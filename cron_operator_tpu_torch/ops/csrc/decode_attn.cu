// Decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// No Pallas kernel stands behind this one: on the TPU, XLA compiles the
// JAX decode step's attention (cron_operator_tpu/models/gpt.py:215-243,
// DecoderLayer._decode_attention) into the step's program. The port's
// plain version (ops/attention.py decode_attention_reference) upcast the
// whole bf16 KV cache to f32 on every step, and its einsum made a
// contiguous copy of every layer's K and V; this kernel reads the cache as
// it lies, once.
//
// Function, for each batch row b and K/V head kh, with the g = h / kv_h
// query heads of its group (query head kh * g + i reads K/V head kh):
//   s[j] = (sum_d q[d] * K[j][d]) * scale    products of T values, f32 sum
//   s[j] = DECODE_MASK (-1e30) for j > pos   (positions not written yet)
//   p    = softmax(s) in f32, rounded to T   (the reference's bf16 probs)
//   out  = sum_j p[j] * V[j] in f32, rounded to T
// with pos read from device memory (the cache's position counter, which a
// captured decode graph advances on the card), so nothing here waits for
// the host and one capture serves every position.
//
// Reading only positions j <= pos is exact: a masked score gives
// exp(-1e30 - m) = 0 in f32 for any real row max m, so the skipped tail
// adds nothing to the sum or to the output. At the serving shape (prompt
// 512 + 64 new tokens on max_len 1024) that halves the bytes read.
//
// Bound: bytes. At GPT-2 small's decode (b 8, kv_h 12, d 64, bf16, pos
// 575) the function reads 2 * 8 * 576 * 12 * 64 * 2 B = 14.2 MB of K and V
// and does 14 MFLOP: 4.2 us at 3.35 TB/s against 0.014 us at the bf16
// tensor-core rate. So the design spends nothing on tensor cores and
// everything on reading K and V once, coalesced, from enough blocks:
//
// 1. scores_kernel, grid (chunks, kv_h, b): each block takes CHUNK
//    positions of one (b, kh); groups of LANES threads read one K row in
//    16-byte loads, each group's dot products for all g heads of the group
//    (q staged in shared memory) are reduced by shuffles; scaled scores go
//    to an f32 workspace [b, kv_h, g, max_len].
// 2. pv_kernel, same grid: each block reduces its heads' whole score rows
//    (at most max_len floats each, from L2) to the row max m and the sum l
//    of exp(s - m), in a fixed order, so every block of a row finds the
//    same m and l; then it forms p = T(exp(s - m) / l) for its chunk (the
//    softmax's global normalisation comes before the rounding, as in the
//    reference: a split online softmax would round unnormalised partials)
//    and accumulates p * V over the chunk into an f32 partial per chunk.
// 3. combine_kernel, grid (kv_h, b): sums the chunks' partials in chunk
//    order and rounds to T.
// No float atomics: every sum has one order, so reruns are bit-identical.
// Blocks whose chunk starts past pos return at once: the grid is sized by
// max_len (static, so a graph capture holds), the work by pos.
//
// Layout: q [b, 1, h, d] and out [b, 1, h, d] by (batch, head) strides; the
// caches [b, max_len, kv_h, d] by (batch, position, head) strides, unit
// stride in d, 16-byte aligned rows (the wrapper checks). Head dims 32, 64,
// 128 and 256; f32 or bf16; g at most MAX_GROUP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 64;      // positions per block
constexpr int HEAD_TILE = 4;   // query heads accumulated at once in pass 2
constexpr int MAX_GROUP = 32;  // query heads per K/V head

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

// Positions written so far, pos + 1, held to [1, max_len].
__device__ __forceinline__ int written(const int64_t* pos, int max_len) {
  const int64_t n = *pos + 1;
  return n < 1 ? 1 : (n > max_len ? max_len : static_cast<int>(n));
}

// How a block reads rows of D values of type T: VEC values a 16-byte load,
// LANES threads a row, STEPS loads a thread, ROWS rows at once.
template <typename T, int D>
struct RowMap {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int LANES = D / VEC < 32 ? D / VEC : 32;
  static constexpr int STEPS = D / (VEC * LANES);
  static constexpr int ROWS = THREADS / LANES;
  static constexpr int PER_THREAD = VEC * STEPS;
  static_assert(D % (VEC * LANES) == 0, "head dim must tile the lanes");
};

// The PER_THREAD values of row `r` that lane `lane` owns, as f32: columns
// (step * LANES + lane) * VEC + e.
template <typename T, int D>
__device__ __forceinline__ void load_row(const T* r, int lane,
                                         float (&out)[RowMap<T, D>::PER_THREAD]) {
  using M = RowMap<T, D>;
#pragma unroll
  for (int step = 0; step < M::STEPS; ++step) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        r + (step * M::LANES + lane) * M::VEC);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < M::VEC; ++e) out[step * M::VEC + e] = to_float(vals[e]);
  }
}

template <typename T, int D>
__device__ __forceinline__ int column(int i, int lane) {
  using M = RowMap<T, D>;
  return ((i / M::VEC) * M::LANES + lane) * M::VEC + i % M::VEC;
}

// Sum over the LANES consecutive lanes of a row group (a power of two
// within one warp); every thread of the warp takes part.
template <int LANES>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The block's reduction of one value a thread, max or sum, in a fixed
// order: a shuffle tree in each warp, then warp 0 over the warps' results.
// Every thread gets the result. `scratch` holds THREADS / 32 floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < THREADS / 32 ? scratch[lane] : (MAX ? -CUDART_INF_F : 0.f);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      const float y = __shfl_xor_sync(0xffffffffu, x, off);
      x = MAX ? fmaxf(x, y) : x + y;
    }
    if (lane == 0) scratch[0] = x;
  }
  __syncthreads();
  return scratch[0];
}

// Pass 1: scaled scores of CHUNK positions for the g heads of (b, kh).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const int64_t* __restrict__ pos, float* __restrict__ scores,
                  int max_len, int kv_heads, int group, Strides sq, Strides sk,
                  float scale) {
  using M = RowMap<T, D>;
  const int chunk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n = written(pos, max_len);
  const int start = chunk * CHUNK;
  if (start >= n) return;
  const int end = min(start + CHUNK, n);

  extern __shared__ float q_s[];  // [group][D]
  for (int i = threadIdx.x; i < group * D; i += THREADS) {
    const int head = kh * group + i / D;
    q_s[i] = to_float(q[b * sq.b + head * sq.h + i % D]);
  }
  __syncthreads();

  const int lane = threadIdx.x % M::LANES, row = threadIdx.x / M::LANES;
  float* out = scores + (static_cast<int64_t>(b) * kv_heads + kh) * group *
                            static_cast<int64_t>(max_len);
  // every thread runs every round, so the shuffles see whole warps
  for (int j0 = start; j0 < end; j0 += M::ROWS) {
    const int j = j0 + row;
    const bool valid = j < end;
    float kv[M::PER_THREAD];
    if (valid) {
      load_row<T, D>(k + b * sk.b + j * sk.s + kh * sk.h, lane, kv);
    } else {
#pragma unroll
      for (int i = 0; i < M::PER_THREAD; ++i) kv[i] = 0.f;
    }
    for (int gi = 0; gi < group; ++gi) {
      const float* qg = q_s + gi * D;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < M::PER_THREAD; ++i)
        acc = fmaf(qg[column<T, D>(i, lane)], kv[i], acc);
      acc = group_sum<M::LANES>(acc);
      if (valid && lane == 0) out[gi * static_cast<int64_t>(max_len) + j] = acc * scale;
    }
  }
}

// Pass 2: p for CHUNK positions from the whole rows' max and sum, and the
// chunk's share of p V, for the g heads of (b, kh).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    pv_kernel(const float* __restrict__ scores, const T* __restrict__ v,
              const int64_t* __restrict__ pos, float* __restrict__ partial,
              int max_len, int kv_heads, int group, int chunks, Strides sv) {
  using M = RowMap<T, D>;
  const int chunk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n = written(pos, max_len);
  const int start = chunk * CHUNK;
  if (start >= n) return;
  const int end = min(start + CHUNK, n);

  __shared__ float scratch[THREADS / 32];
  __shared__ float row_max[MAX_GROUP], row_sum[MAX_GROUP];
  __shared__ float red[M::ROWS * HEAD_TILE * D];
  const float* rows = scores + (static_cast<int64_t>(b) * kv_heads + kh) *
                                   group * static_cast<int64_t>(max_len);
  for (int gi = 0; gi < group; ++gi) {
    const float* s = rows + gi * static_cast<int64_t>(max_len);
    float m = -CUDART_INF_F;
    for (int j = threadIdx.x; j < n; j += THREADS) m = fmaxf(m, s[j]);
    m = block_reduce<true>(m, scratch);
    float l = 0.f;
    for (int j = threadIdx.x; j < n; j += THREADS) l += expf(s[j] - m);
    l = block_reduce<false>(l, scratch);
    if (threadIdx.x == 0) {
      row_max[gi] = m;
      row_sum[gi] = l;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % M::LANES, row = threadIdx.x / M::LANES;
  for (int g0 = 0; g0 < group; g0 += HEAD_TILE) {
    const int tile = min(HEAD_TILE, group - g0);
    float acc[HEAD_TILE][M::PER_THREAD];
#pragma unroll
    for (int t = 0; t < HEAD_TILE; ++t)
#pragma unroll
      for (int i = 0; i < M::PER_THREAD; ++i) acc[t][i] = 0.f;
    for (int j = start + row; j < end; j += M::ROWS) {
      float vr[M::PER_THREAD];
      load_row<T, D>(v + b * sv.b + j * sv.s + kh * sv.h, lane, vr);
#pragma unroll
      for (int t = 0; t < HEAD_TILE; ++t) {
        if (t < tile) {
          const int gi = g0 + t;
          const float e = expf(rows[gi * static_cast<int64_t>(max_len) + j] -
                               row_max[gi]);
          const float p = to_float(from_float<T>(e / row_sum[gi]));
#pragma unroll
          for (int i = 0; i < M::PER_THREAD; ++i)
            acc[t][i] = fmaf(p, vr[i], acc[t][i]);
        }
      }
    }
    // the rows' sums, summed over the rows in row order
    for (int t = 0; t < tile; ++t)
#pragma unroll
      for (int i = 0; i < M::PER_THREAD; ++i)
        red[(row * HEAD_TILE + t) * D + column<T, D>(i, lane)] = acc[t][i];
    __syncthreads();
    float* out = partial + ((static_cast<int64_t>(b) * kv_heads + kh) * chunks +
                            chunk) * group * D;
    for (int i = threadIdx.x; i < tile * D; i += THREADS) {
      const int t = i / D, col = i % D;
      float sum = 0.f;
      for (int r = 0; r < M::ROWS; ++r) sum += red[(r * HEAD_TILE + t) * D + col];
      out[(g0 + t) * D + col] = sum;
    }
    __syncthreads();  // red is rewritten by the next head tile
  }
}

// Pass 3: the chunks' partials summed in chunk order, rounded to T.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    combine_kernel(const float* __restrict__ partial,
                   const int64_t* __restrict__ pos, T* __restrict__ out,
                   int max_len, int kv_heads, int group, int chunks,
                   Strides so) {
  const int kh = blockIdx.x, b = blockIdx.y;
  const int used = (written(pos, max_len) + CHUNK - 1) / CHUNK;
  const float* in = partial + (static_cast<int64_t>(b) * kv_heads + kh) *
                                  chunks * group * D;
  for (int i = threadIdx.x; i < group * D; i += THREADS) {
    float sum = 0.f;
    for (int c = 0; c < used; ++c) sum += in[static_cast<int64_t>(c) * group * D + i];
    const int head = kh * group + i / D;
    out[b * so.b + head * so.h + i % D] = from_float<T>(sum);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int64_t* pos, void* out, float* scores,
                   float* partial, int batch, int max_len, int heads,
                   int kv_heads, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, cudaStream_t stream) {
  const int group = heads / kv_heads;
  const int chunks = (max_len + CHUNK - 1) / CHUNK;
  const dim3 grid(chunks, kv_heads, batch);
  scores_kernel<T, D><<<grid, THREADS, group * D * sizeof(float), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), pos, scores, max_len,
      kv_heads, group, sq, sk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pv_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      scores, static_cast<const T*>(v), pos, partial, max_len, kv_heads, group,
      chunks, sv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T, D><<<dim3(kv_heads, batch), THREADS, 0, stream>>>(
      partial, pos, static_cast<T*>(out), max_len, kv_heads, group, chunks,
      so);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, const void* q, const void* k,
                         const void* v, const int64_t* pos, void* out,
                         float* scores, float* partial, int batch, int max_len,
                         int heads, int kv_heads, Strides sq, Strides sk,
                         Strides sv, Strides so, float scale,
                         cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, pos, out, scores, partial, batch, max_len,
                           heads, kv_heads, sq, sk, sv, so, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, pos, out, scores, partial, batch, max_len,
                           heads, kv_heads, sq, sk, sv, so, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, pos, out, scores, partial, batch, max_len,
                            heads, kv_heads, sq, sk, sv, so, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, pos, out, scores, partial, batch, max_len,
                            heads, kv_heads, sq, sk, sv, so, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements: q and out by
// (batch, head), k and v by (batch, position, head). `scores` is f32
// [batch, kv_heads, heads / kv_heads, max_len] and `partial` f32
// [batch, kv_heads, ceil(max_len / 64), heads / kv_heads, head_dim], both
// scratch. The caller checks shapes and alignment; a bad head_dim, dtype
// or group returns cudaErrorInvalidValue. Returns the launches'
// cudaGetLastError().
int decode_attn(const void* q, const void* k, const void* v,
                const void* pos, void* out, void* scores, void* partial,
                int dtype, int batch, int max_len, int heads, int kv_heads,
                int head_dim, int64_t sq_b, int64_t sq_h, int64_t sk_b,
                int64_t sk_s, int64_t sk_h, int64_t sv_b, int64_t sv_s,
                int64_t sv_h, int64_t so_b, int64_t so_h, float scale,
                void* stream) {
  if (batch <= 0 || max_len <= 0 || kv_heads <= 0 || heads % kv_heads ||
      heads / kv_heads > MAX_GROUP)
    return cudaErrorInvalidValue;
  const Strides sq{sq_b, 0, sq_h}, sk{sk_b, sk_s, sk_h}, sv{sv_b, sv_s, sv_h},
      so{so_b, 0, so_h};
  const int64_t* p = static_cast<const int64_t*>(pos);
  float* sc = static_cast<float*>(scores);
  float* pa = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(head_dim, q, k, v, p, out, sc, pa, batch,
                               max_len, heads, kv_heads, sq, sk, sv, so, scale,
                               st);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k, v, p, out, sc, pa,
                                       batch, max_len, heads, kv_heads, sq, sk,
                                       sv, so, scale, st);
  return cudaErrorInvalidValue;
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
