// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces K1 of the JAX package: cron_operator_tpu/ops/flash_attention.py
// `_flash_kernel`, launched by `_forward` through `pl.pallas_call`. Same
// function: online-softmax attention over [b, s, h, d] with an optional
// causal mask, grouped-query K/V, O in the input type and the per-row
// logsumexp LSE = m + log(l) in f32 (a row that saw no key gives O = 0 and
// LSE = LSE_MASKED).
//
// Bound: at the serving shape (b 8, s 512, h 12, d 64, bf16, causal) the
// function needs 25.4 MB of HBM traffic (Q, K, V and O once, LSE) against
// 3.2 GFLOP, so on an H100 it is memory-bound (7.6 us for the bytes, 3.3 us
// for the operations at the bf16 tensor-core rate). The design keeps the
// traffic at that floor: each block owns one 64-row query tile and walks
// the K/V tiles of its (batch, head) in a loop, keeping the running max m,
// the normaliser l and the accumulator in registers, so every Q and O
// element crosses HBM once per tile pass and the s x s score matrix never
// leaves the SM. The TPU kernel's sequential K grid axis becomes that loop;
// a causal loop stops at the diagonal tile.
//
// This first version does the products with f32 FMAs on tiles held as f32
// in shared memory (no tensor cores). It is right and simple; wgmma/TMA is
// later work.
//
// Layout: thread t of 256 is (ty, tx) = (t / 16, t % 16). It owns query
// rows 4*ty .. 4*ty+3 of the tile and, in the score tile, key columns
// tx + 16*j (j < 4); in the output, columns tx + 16*c (c < D/16). The 16
// threads of one row group sit in one half-warp, so row max and row sum are
// half-warp shuffles. Shared rows are padded by one float so that the 16
// threads reading rows tx + 16*j at one column hit 16 distinct banks.
//
// Any sequence length s >= 1. The grid and the key loop round the tile
// counts up, so the last query tile and the last key tile may be partial:
// rows past s load as zeros (never read), and none is stored. Each row
// carries a last key column (its own row under causal, s - 1 otherwise, -1
// for a row past s); a score past it is NEG_INF and its P exactly 0. The
// LSE is f32 [b * h, s]: row r of (batch, head) bh at bh * s + r.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;    // masked score, as in the JAX kernel
constexpr float LSE_MASKED = 1e30f;  // LSE of a row that saw no key

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of a [b, s, h, d] tensor; the head_dim stride is 1.
struct Strides {
  int64_t b, s, h;
};

// Copies rows [r0, r0 + TILE) of one head of a [b, s, h, d] tensor into a
// padded f32 shared tile; rows at or past `seq` are zeros, never read.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          int64_t row_stride, int r0,
                                          int seq) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] =
        r0 + r < seq ? to_float(base[(int64_t)(r0 + r) * row_stride + c])
                     : 0.f;
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * TILE * (D + 1) + TILE * (TILE + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int seq, int heads, int kv_heads,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     int causal, float scale) {
  constexpr int LD = D + 1;      // padded shared row of Q, K, V
  constexpr int LP = TILE + 1;   // padded shared row of P
  constexpr int COLS = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + TILE * LD;
  float* v_s = k_s + TILE * LD;
  float* p_s = v_s + TILE * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / heads;
  const int hi = bh % heads;
  // kv_index(bh) = (bh // h) * kv_h + (bh % h) // group: the grouped K/V
  // head is addressed in place, never repeated.
  const int kvh = hi / (heads / kv_heads);
  const int q0 = q_tile * TILE;

  const T* q_base = q + bi * sq.b + hi * sq.h;
  const T* k_base = k + bi * sk.b + kvh * sk.h;
  const T* v_base = v + bi * sv.b + kvh * sv.h;

  load_tile<T, D>(q_s, q_base, sq.s, q0, seq);

  float m[4], l[4], acc[4][COLS];
  int last_key[4];  // the last key column each row keeps (-1: past s)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
    const int row = q0 + ty * 4 + i;
    last_key[i] = row >= seq ? -1 : causal ? row : seq - 1;
  }

  const int n_tiles = causal ? q_tile + 1 : (seq + TILE - 1) / TILE;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the last tile's K, V and P reads are done
    load_tile<T, D>(k_s, k_base, sk.s, k0, seq);
    load_tile<T, D>(v_s, v_base, sv.s, k0, seq);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * LD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * LD + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // a tile that may hold a key past a row's last: the diagonal, the last
    // key tile, every tile of a partial query tile
    const bool edge = (causal && kt == q_tile) || k0 + TILE > seq ||
                      q0 + TILE > seq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (edge && k0 + tx + 16 * j > last_key[i]) x = NEG_INF;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // exactly 0 past the last key, also in a row that kept no key
        const float p = edge && k0 + tx + 16 * j > last_key[i]
                            ? 0.f
                            : expf(s[i][j] - m_new);
        row_sum += p;
        p_s[row * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P of the whole tile is in shared memory

#pragma unroll 4
    for (int n = 0; n < TILE; ++n) {
      float pv[4], vv[COLS];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * LP + n];
#pragma unroll
      for (int c = 0; c < COLS; ++c) vv[c] = v_s[n * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq) continue;
    const bool masked = l[i] == 0.f;  // fully masked row: O = 0, not NaN
    const float denom = masked ? 1.f : l[i];
    T* o_row = o + bi * so.b + (int64_t)row * so.s + hi * so.h;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      o_row[tx + 16 * c] = from_float<T>(acc[i][c] / denom);
    if (tx == 0)
      lse[(int64_t)bh * seq + row] = masked ? LSE_MASKED : m[i] + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads, int kv_heads,
                   Strides sq, Strides sk, Strides sv, Strides so, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // Above 48 KB a block's dynamic shared memory has to be allowed first.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + TILE - 1) / TILE, batch * heads);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      seq, heads, kv_heads, sq, sk, sv, so, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const void* q, const void* k,
                         const void* v, void* o, void* lse, int batch, int seq,
                         int heads, int kv_heads, Strides sq, Strides sk,
                         Strides sv, Strides so, int causal, float scale,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, batch, seq, heads, kv_heads, sq,
                           sk, sv, so, causal, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch, seq, heads, kv_heads, sq,
                           sk, sv, so, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch, seq, heads, kv_heads, sq,
                            sk, sv, so, causal, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, batch, seq, heads, kv_heads, sq,
                            sk, sv, so, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. The caller
// checks shapes (seq >= 1, heads a multiple of kv_heads, a supported
// head_dim); anything else returns cudaErrorInvalidValue. Returns
// the launch's cudaGetLastError().
int flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
              int dtype, int batch, int seq, int heads, int kv_heads,
              int head_dim, int64_t sq_b, int64_t sq_s, int64_t sq_h,
              int64_t sk_b, int64_t sk_s, int64_t sk_h, int64_t sv_b,
              int64_t sv_s, int64_t sv_h, int64_t so_b, int64_t so_s,
              int64_t so_h, int causal, float scale, void* stream) {
  if (seq <= 0 || batch <= 0 || kv_heads <= 0 || heads % kv_heads)
    return cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_s, sq_h}, sk{sk_b, sk_s, sk_h},
      sv{sv_b, sv_s, sv_h}, so{so_b, so_s, so_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(head_dim, q, k, v, o, lse, batch, seq, heads,
                               kv_heads, sq, sk, sv, so, causal, scale, st);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, o, lse, batch, seq,
                                       heads, kv_heads, sq, sk, sv, so, causal,
                                       scale, st);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
