// LayerNorm over the rows of [T, H] for Hopper (sm_90a), forward and
// backward, plain C interface for ctypes.
//
// No Pallas kernel stands behind this pair: the JAX models call flax's
// nn.LayerNorm(dtype=cfg.dtype) (cron_operator_tpu/models/gpt.py:139, 166,
// 311; models/bert.py:70, 85, 117; models/vit.py:106), whose f32
// statistics, normalisation and casts XLA fuses into one pass over the bf16
// activation. The port's former LayerNorm (ops/layer_norm.py
// layer_norm_reference, the plain version) cast x to a fresh f32 tensor,
// ran torch's f32 norm into a second and cast that back to bf16; its
// backward cast dy up, ran the f32 backward and cast dx down. This pair
// reads x (and dy) in their own dtype once and writes y (dx) once, in that
// dtype, and keeps only f32 [T] statistics.
//
// The folded pair takes the residual add before the norm into the same
// launch, as XLA fuses the add into the norm's fusion in the reference
// (cron_operator_tpu/models/gpt.py:164-166, 174 -> 139 and 311;
// models/bert.py:83-89, 117): layer_norm_add_fwd reads the residual rows x
// and the branch rows r, writes s = x + r rounded once to their dtype (the
// residual stream, the bits of torch's add) and normalises that rounded s.
// Its backward is layer_norm_bwd given ds, the residual stream's incoming
// gradient: dx_total = dx + ds in f32, rounded once, which both x and r
// receive (the former path rounded dx, then added ds in bf16).
//
// Function (row t of T, H columns; flax's _normalize order):
//   forward   mean_t = sum_j x_tj / H,
//             var_t  = sum_j (x_tj - mean_t)^2 / H   (centred squares of
//                                                     the values held)
//             rstd_t = rsqrt(var_t + eps),
//             y_tj   = (x_tj - mean_t) * (rstd_t * gamma_j) + beta_j in f32,
//             rounded once to y's type; mean and rstd saved in f32.
//   backward  xhat = (x_tj - mean_t) * rstd_t (recomputed), g = gamma_j dy_tj,
//             a_t = sum_j g / H, b_t = sum_j g xhat / H,
//             dx_tj = rstd_t * (g - a_t - xhat b_t), rounded once to x's type;
//             dgamma_j = sum_t dy_tj xhat, dbeta_j = sum_t dy_tj in f32,
//             rounded once to the parameters' type.
//
// Bound: bytes. GPT-2 small's [8192, 768] in bf16: the forward reads x and
// writes y (25.17 MB) and the f32 mean and rstd (65.5 KB), 25.23 MB, 7.53 us
// at 3.35 TB/s; the backward reads x and dy and writes dx (37.75 MB, with
// the statistics and parameters 37.8 MB), 11.3 us. The arithmetic is about
// ten f32 operations an element: 63 M forward, about 1 us at 67 TFLOP/s.
// Folded, the forward also reads r and writes s (50.4 MB, 15.0 us) and the
// backward reads ds (50.4 MB, 15.0 us); a decode step's [8, 768] is a
// latency, not a byte count.
//
// Design "warp": a row is read once, in 16-byte vectors, into the registers
// of one warp, which hold it while its sums are formed, and y (dx) is
// written from them; 8 rows a block of 256 threads. Lane i holds the
// 8-value chunks i, i + 32, ..., CHUNKS of them: ops/layer_norm.py
// forward_plan and backward_plan pick CHUNKS by H, 1 to 256 (the tiny
// configs' 128 and 64) and 3 to 768 (GPT-2 small, BERT-base and ViT-B), the
// widest any config holds. Sums:
// each lane's chain over the values it holds, then a shuffle butterfly
// (every lane ends with the same bits: the adds are commutative).
// The backward's grid is fixed by its plan (at most 264 blocks, two an SM):
// a block's warp w takes rows 8 b + w, 8 (b + blocks) + w, ..., so each lane
// keeps the dgamma and dbeta partials of its columns in registers over its
// rows. The block's 8 warps add theirs in a fixed tree through shared
// memory laid out lane-minor, free of bank conflicts (a first design added
// them in eight serial rounds at 8-way conflicts, which took as long as the
// rows themselves), and warp 0 writes the block's f32 partial row of each;
// a second launch sums each column's partial rows in a fixed order. It is
// launched as the first's programmatic dependent (the first grid allows it
// at its start, it waits for that grid's end with griddepcontrol.wait): at
// BERT-base's rows the gap between two plain launches and the second's own
// start took about a third of the pair's time.
// No atomics: reruns are bit-identical. Nothing allocates or synchronises,
// so a CUDA graph capture of a step holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 8;  // values a chunk: one bf16 vector, two f32 ones

__device__ __forceinline__ void unpack_bf16(const uint4& r,
                                            float (&v)[CHUNK]) {
  // a word holds two bf16 values, the lower address in the low half; a
  // bf16 is the upper half of the f32 of the same value
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack_bf16(const float (&v)[CHUNK]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 values of T as they lie in memory, 16-byte aligned.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  float4 a, b;
  __device__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ void unpack(float (&v)[CHUNK]) const {
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
  __device__ void pack(const float (&v)[CHUNK]) {
    a = make_float4(v[0], v[1], v[2], v[3]);
    b = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ void put(float* p) const {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = a;
    q[1] = b;
  }
  __device__ static void store(float* p, const float (&v)[CHUNK]) {
    float4* q = reinterpret_cast<float4*>(p);
    q[0] = make_float4(v[0], v[1], v[2], v[3]);
    q[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  uint4 r;
  __device__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ void unpack(float (&v)[CHUNK]) const { unpack_bf16(r, v); }
  __device__ void pack(const float (&v)[CHUNK]) { r = pack_bf16(v); }
  __device__ void put(__nv_bfloat16* p) const {
    *reinterpret_cast<uint4*>(p) = r;
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[CHUNK]) {
    *reinterpret_cast<uint4*>(p) = pack_bf16(v);
  }
};

// 8 values at element j of p, f32 or bf16 as `bf16` says, widened.
__device__ __forceinline__ void load8(const void* p, bool bf16, size_t j,
                                      float (&v)[CHUNK]) {
  if (bf16) {
    Chunk<__nv_bfloat16> c;
    c.load(static_cast<const __nv_bfloat16*>(p) + j);
    c.unpack(v);
  } else {
    Chunk<float> c;
    c.load(static_cast<const float*>(p) + j);
    c.unpack(v);
  }
}

__device__ __forceinline__ void store8(void* p, bool bf16, size_t j,
                                       const float (&v)[CHUNK]) {
  if (bf16)
    Chunk<__nv_bfloat16>::store(static_cast<__nv_bfloat16*>(p) + j, v);
  else
    Chunk<float>::store(static_cast<float*>(p) + j, v);
}

// The two sums (x, y) over a warp's row: a butterfly; every lane returns
// the same bits.
__device__ __forceinline__ float2 row_sum(float2 s) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
  }
  return s;
}

// ADD: the rows normalised are s = x + r, rounded once to T (the bits of
// torch's add in T) and written to s_out [rows, h] contiguous; else x.
template <int CHUNKS, typename T, bool ADD>
__global__ void __launch_bounds__(THREADS)
    layer_norm_fwd_kernel(const T* __restrict__ x, long long x_stride,
                          const T* __restrict__ r, long long r_stride,
                          T* __restrict__ s_out,
                          const void* __restrict__ gamma,
                          const void* __restrict__ beta, bool p_bf16,
                          void* __restrict__ y, bool y_bf16,
                          float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int rows, int h,
                          float eps) {
  const int t = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // a whole warp leaves together
  const int chunks = h / CHUNK;
  const T* xr = x + static_cast<size_t>(row) * x_stride;
  const size_t out_row = static_cast<size_t>(row) * h;
  Chunk<T> held[CHUNKS];
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int i = t + k * 32;
    if (i < chunks) held[k].load(xr + static_cast<size_t>(i) * CHUNK);
  }
  if constexpr (ADD) {
    const T* rr = r + static_cast<size_t>(row) * r_stride;
    Chunk<T> branch[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = t + k * 32;
      if (i < chunks) branch[k].load(rr + static_cast<size_t>(i) * CHUNK);
    }
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = t + k * 32;
      if (i < chunks) {
        float v[CHUNK], b[CHUNK];
        held[k].unpack(v);
        branch[k].unpack(b);
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) v[j] += b[j];
        held[k].pack(v);  // rounded once: the norm reads what s holds
        held[k].put(s_out + out_row + static_cast<size_t>(i) * CHUNK);
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    if (t + k * 32 < chunks) {
      float v[CHUNK];
      held[k].unpack(v);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) sum += v[j];
    }
  }
  const float fh = static_cast<float>(h);
  const float mean = row_sum(make_float2(sum, 0.f)).x / fh;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    if (t + k * 32 < chunks) {
      float v[CHUNK];
      held[k].unpack(v);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float d = v[j] - mean;
        sq = fmaf(d, d, sq);
      }
    }
  }
  const float var = row_sum(make_float2(sq, 0.f)).x / fh;
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < CHUNKS; ++k) {
    const int i = t + k * 32;
    if (i < chunks) {
      float v[CHUNK], g[CHUNK], b[CHUNK];
      held[k].unpack(v);
      load8(gamma, p_bf16, static_cast<size_t>(i) * CHUNK, g);
      load8(beta, p_bf16, static_cast<size_t>(i) * CHUNK, b);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        v[j] = fmaf(v[j] - mean, rstd * g[j], b[j]);
      store8(y, y_bf16, out_row + static_cast<size_t>(i) * CHUNK, v);
    }
  }
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// RESID: dx += ds, the residual stream's gradient [rows, h] of T at row
// stride ds_stride, before dx's one rounding.
template <int CHUNKS, typename T, typename D, bool RESID>
__global__ void __launch_bounds__(THREADS)
    layer_norm_bwd_kernel(const T* __restrict__ x, long long x_stride,
                          const D* __restrict__ dy, long long dy_stride,
                          const T* __restrict__ ds, long long ds_stride,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const void* __restrict__ gamma, bool p_bf16,
                          T* __restrict__ dx, float* __restrict__ part,
                          int rows, int h) {
  // a warp's partials, 2 x CHUNKS x CHUNK values a lane, lane-minor so that
  // a warp's store or load of one value touches 32 banks once
  constexpr int HELD = 2 * CHUNKS * CHUNK;
  extern __shared__ float tree[];  // [WARPS / 2][HELD][32]
  // the second launch (layer_norm_params_kernel) may start now: its blocks
  // wait for this grid's end before they read a partial row
  asm volatile("griddepcontrol.launch_dependents;");
  const int t = threadIdx.x & 31;
  const int slot = threadIdx.x / 32;
  const int chunks = h / CHUNK;
  const float fh = static_cast<float>(h);
  // the partials of the columns held: dgamma's CHUNKS x CHUNK, then dbeta's
  float held[HELD];
#pragma unroll
  for (int q = 0; q < HELD; ++q) held[q] = 0.f;
  // no thread leaves early: the block's warps meet at its barriers below
  for (int row = blockIdx.x * WARPS + slot; row < rows;
       row += gridDim.x * WARPS) {
    const T* xr = x + static_cast<size_t>(row) * x_stride;
    const D* dyr = dy + static_cast<size_t>(row) * dy_stride;
    Chunk<T> xc[CHUNKS], sc[CHUNKS];
    Chunk<D> dc[CHUNKS];
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = t + k * 32;
      if (i < chunks) {
        xc[k].load(xr + static_cast<size_t>(i) * CHUNK);
        dc[k].load(dyr + static_cast<size_t>(i) * CHUNK);
        if constexpr (RESID)
          sc[k].load(ds + static_cast<size_t>(row) * ds_stride +
                     static_cast<size_t>(i) * CHUNK);
      }
    }
    const float m = __ldg(mean + row), r = __ldg(rstd + row);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = t + k * 32;
      if (i < chunks) {
        float xv[CHUNK], dv[CHUNK], g[CHUNK];
        xc[k].unpack(xv);
        dc[k].unpack(dv);
        load8(gamma, p_bf16, static_cast<size_t>(i) * CHUNK, g);
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const float xh = (xv[j] - m) * r;
          const float gd = g[j] * dv[j];
          s1 += gd;
          s2 = fmaf(gd, xh, s2);
          held[k * CHUNK + j] = fmaf(dv[j], xh, held[k * CHUNK + j]);
          held[(CHUNKS + k) * CHUNK + j] += dv[j];
        }
      }
    }
    const float2 s = row_sum(make_float2(s1, s2));
    const float a = s.x / fh, b = s.y / fh;
    T* dxr = dx + static_cast<size_t>(row) * h;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = t + k * 32;
      if (i < chunks) {
        float xv[CHUNK], dv[CHUNK], g[CHUNK];
        xc[k].unpack(xv);
        dc[k].unpack(dv);
        load8(gamma, p_bf16, static_cast<size_t>(i) * CHUNK, g);
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const float xh = (xv[j] - m) * r;
          xv[j] = r * (g[j] * dv[j] - a - xh * b);
        }
        if constexpr (RESID) {
          float sv[CHUNK];
          sc[k].unpack(sv);
#pragma unroll
          for (int j = 0; j < CHUNK; ++j) xv[j] += sv[j];
        }
        Chunk<T>::store(dxr + static_cast<size_t>(i) * CHUNK, xv);
      }
    }
  }
  // the 8 warps hold the same columns: a tree through shared memory, warp
  // w + n adding into warp w for n = 4, 2, 1, in that order
#pragma unroll
  for (int n = WARPS / 2; n; n /= 2) {
    if (slot >= n && slot < 2 * n) {
#pragma unroll
      for (int q = 0; q < HELD; ++q)
        tree[((slot - n) * HELD + q) * 32 + t] = held[q];
    }
    __syncthreads();
    if (slot < n) {
#pragma unroll
      for (int q = 0; q < HELD; ++q)
        held[q] += tree[(slot * HELD + q) * 32 + t];
    }
    __syncthreads();
  }
  if (slot == 0) {  // the block's partial rows
    float* out = part + static_cast<size_t>(blockIdx.x) * 2 * h;
#pragma unroll
    for (int k = 0; k < CHUNKS; ++k) {
      const int i = t + k * 32;
      if (i < chunks) {
        float g[CHUNK], d[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          g[j] = held[k * CHUNK + j];
          d[j] = held[(CHUNKS + k) * CHUNK + j];
        }
        Chunk<float>::store(out + static_cast<size_t>(i) * CHUNK, g);
        Chunk<float>::store(out + h + static_cast<size_t>(i) * CHUNK, d);
      }
    }
  }
}

// dgamma_j and dbeta_j from part [blocks][2][h], blocks <= MAX_BWD_BLOCKS:
// a block sums PARAM_COLS columns; its thread (lane, j) loads column j of
// the partial rows lane, lane + PARAM_LANES, ... all at once (a warp reads
// 4 rows of 32 contiguous bytes an instruction) and adds them in order, and
// the lanes' sums are added in lane order.
constexpr int MAX_BWD_BLOCKS = 264;  // ops/layer_norm.py BWD_BLOCKS
constexpr int PARAM_COLS = 8;
constexpr int PARAM_LANES = THREADS / PARAM_COLS;
constexpr int PARAM_ROWS = (MAX_BWD_BLOCKS + PARAM_LANES - 1) / PARAM_LANES;

__global__ void __launch_bounds__(THREADS)
    layer_norm_params_kernel(const float* __restrict__ part, int blocks,
                             int h, void* __restrict__ dgamma,
                             void* __restrict__ dbeta, bool p_bf16) {
  __shared__ float2 red[PARAM_LANES][PARAM_COLS];
  // launched early (programmatic dependent launch): wait for the row
  // kernel's grid to end and its partial rows to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int j = threadIdx.x % PARAM_COLS, lane = threadIdx.x / PARAM_COLS;
  const int c = blockIdx.x * PARAM_COLS + j;  // < h: h is a multiple of 8
  float2 v[PARAM_ROWS];
#pragma unroll
  for (int q = 0; q < PARAM_ROWS; ++q) {
    const int p = lane + q * PARAM_LANES;
    const float* row = part + static_cast<size_t>(p) * 2 * h;
    v[q] = p < blocks ? make_float2(row[c], row[h + c])
                      : make_float2(0.f, 0.f);
  }
  float2 s = v[0];
#pragma unroll
  for (int q = 1; q < PARAM_ROWS; ++q) {
    s.x += v[q].x;
    s.y += v[q].y;
  }
  red[lane][j] = s;
  __syncthreads();
  if (lane == 0) {
    for (int l = 1; l < PARAM_LANES; ++l) {
      s.x += red[l][j].x;
      s.y += red[l][j].y;
    }
    if (p_bf16) {
      static_cast<__nv_bfloat16*>(dgamma)[c] = __float2bfloat16_rn(s.x);
      static_cast<__nv_bfloat16*>(dbeta)[c] = __float2bfloat16_rn(s.y);
    } else {
      static_cast<float*>(dgamma)[c] = s.x;
      static_cast<float*>(dbeta)[c] = s.y;
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool code_ok(int code) { return code == 0 || code == 1; }

// f(std::integral_constant<int, C>{}) for the chunks a lane holds, f(T{})
// for a dtype code (0 float32, 1 bfloat16).
template <typename F>
int by_chunks(int chunks, F&& f) {
  switch (chunks) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
int by_type(int code, F&& f) {
  if (code == 1) return f(__nv_bfloat16{});
  return f(float{});
}

// A row of h values, held as `chunks` chunks by each lane of a warp, read
// at a row stride of whole 16-byte vectors.
bool plan_ok(int rows, int h, int chunks, long long stride, int dtype) {
  const int esize = dtype == 1 ? 2 : 4;
  return rows > 0 && h > 0 && h % CHUNK == 0 && chunks > 0 &&
         chunks * CHUNK * 32 >= h && stride >= h &&
         (stride * esize) % 16 == 0;
}

}  // namespace

extern "C" {

// x [rows, h] of x_dtype (0 float32, 1 bfloat16) at row stride x_stride
// elements, gamma and beta [h] of p_dtype, y [rows, h] contiguous of
// y_dtype, mean and rstd f32 [rows]; every pointer 16-byte aligned. One
// launch of ceil(rows / 8) blocks. Returns the launch's
// cudaGetLastError(), cudaErrorInvalidValue for what the kernel does not
// take.
int layer_norm_fwd(const void* x, long long x_stride, const void* gamma,
                   const void* beta, void* y, void* mean, void* rstd,
                   int x_dtype, int p_dtype, int y_dtype, int rows, int h,
                   float eps, int chunks, void* stream) {
  if (!code_ok(x_dtype) || !code_ok(p_dtype) || !code_ok(y_dtype) ||
      !plan_ok(rows, h, chunks, x_stride, x_dtype) || !aligned(x) ||
      !aligned(gamma) || !aligned(beta) || !aligned(y))
    return cudaErrorInvalidValue;
  const int grid = (rows + WARPS - 1) / WARPS;
  return by_chunks(chunks, [&](auto c) {
    return by_type(x_dtype, [&](auto t) {
      using T = decltype(t);
      layer_norm_fwd_kernel<decltype(c)::value, T, false>
          <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const T*>(x), x_stride, nullptr, 0, nullptr, gamma,
              beta, p_dtype == 1, y, y_dtype == 1, static_cast<float*>(mean),
              static_cast<float*>(rstd), rows, h, eps);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// The folded forward: x and r [rows, h] of x_dtype at row strides x_stride
// and r_stride; s = x + r (rounded once to x_dtype) written to s [rows, h]
// contiguous, then layer_norm_fwd's y, mean and rstd of s. One launch.
int layer_norm_add_fwd(const void* x, long long x_stride, const void* r,
                       long long r_stride, void* s, const void* gamma,
                       const void* beta, void* y, void* mean, void* rstd,
                       int x_dtype, int p_dtype, int y_dtype, int rows, int h,
                       float eps, int chunks, void* stream) {
  if (!code_ok(x_dtype) || !code_ok(p_dtype) || !code_ok(y_dtype) ||
      !plan_ok(rows, h, chunks, x_stride, x_dtype) ||
      !plan_ok(rows, h, chunks, r_stride, x_dtype) || !aligned(x) ||
      !aligned(r) || !aligned(s) || !aligned(gamma) || !aligned(beta) ||
      !aligned(y))
    return cudaErrorInvalidValue;
  const int grid = (rows + WARPS - 1) / WARPS;
  return by_chunks(chunks, [&](auto c) {
    return by_type(x_dtype, [&](auto t) {
      using T = decltype(t);
      layer_norm_fwd_kernel<decltype(c)::value, T, true>
          <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
              static_cast<const T*>(x), x_stride, static_cast<const T*>(r),
              r_stride, static_cast<T*>(s), gamma, beta, p_dtype == 1, y,
              y_dtype == 1, static_cast<float*>(mean),
              static_cast<float*>(rstd), rows, h, eps);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// x as layer_norm_fwd's, dy [rows, h] of dy_dtype at row stride dy_stride,
// ds null or [rows, h] of x_dtype at row stride ds_stride (added to dx),
// mean and rstd from it, gamma [h] of p_dtype; dx [rows, h] contiguous of
// x_dtype; part f32 [grid][2][h] scratch; dgamma and dbeta [h] of p_dtype.
// Two launches: `grid` blocks (1 <= grid <= MAX_BWD_BLOCKS, and at most
// the forward's grid) walking the rows, then h / 8 summing the partials,
// launched as the first's programmatic dependent, so that its blocks are
// resident and waiting when the first grid ends.
int layer_norm_bwd(const void* x, long long x_stride, const void* dy,
                   long long dy_stride, const void* ds, long long ds_stride,
                   const void* mean, const void* rstd, const void* gamma,
                   void* dx, void* part, void* dgamma, void* dbeta,
                   int x_dtype, int dy_dtype, int p_dtype, int rows, int h,
                   int chunks, int grid, void* stream) {
  if (!code_ok(x_dtype) || !code_ok(dy_dtype) || !code_ok(p_dtype) ||
      !plan_ok(rows, h, chunks, x_stride, x_dtype) ||
      !plan_ok(rows, h, chunks, dy_stride, dy_dtype) || !aligned(x) ||
      !aligned(dy) || !aligned(gamma) || !aligned(dx) || !aligned(part))
    return cudaErrorInvalidValue;
  if (ds != nullptr &&
      (!plan_ok(rows, h, chunks, ds_stride, x_dtype) || !aligned(ds)))
    return cudaErrorInvalidValue;
  if (grid < 1 || grid > MAX_BWD_BLOCKS || grid > (rows + WARPS - 1) / WARPS)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = by_chunks(chunks, [&](auto c) {
    return by_type(x_dtype, [&](auto t) {
      return by_type(dy_dtype, [&](auto d) {
        using T = decltype(t);
        using D = decltype(d);
        constexpr int C = decltype(c)::value;
        // the tree: half the warps' partials, 24 KB at 3 chunks a lane
        const int smem = WARPS / 2 * 2 * C * CHUNK * 32 * sizeof(float);
        auto launch = [&](auto kernel) {
          kernel<<<grid, THREADS, smem, s>>>(
              static_cast<const T*>(x), x_stride, static_cast<const D*>(dy),
              dy_stride, static_cast<const T*>(ds), ds_stride,
              static_cast<const float*>(mean),
              static_cast<const float*>(rstd), gamma, p_dtype == 1,
              static_cast<T*>(dx), static_cast<float*>(part), rows, h);
        };
        if (ds != nullptr)
          launch(layer_norm_bwd_kernel<C, T, D, true>);
        else
          launch(layer_norm_bwd_kernel<C, T, D, false>);
        return static_cast<int>(cudaGetLastError());
      });
    });
  });
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(h / PARAM_COLS);
  config.blockDim = dim3(THREADS);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &config, layer_norm_params_kernel, static_cast<const float*>(part),
      grid, h, dgamma, dbeta, p_dtype == 1));
}

const char* layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
