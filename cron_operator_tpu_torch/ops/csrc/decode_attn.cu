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
// everything on reading K and V once, from enough blocks, with as few
// launches and round trips through device memory as it can.
//
// Design "cluster" (the main path; ops/attention.py decode_plan picks it
// whenever its tiles fit a block's shared memory): one launch of (CL, kv_h,
// b) blocks of 128 threads, a thread-block cluster of CL per (b, kh); CL is
// 2, 4, 8 or 16, and the plan takes 4, which keeps GPT-2 small's 96
// clusters resident at once (8 needs a second wave). The cache positions
// fall into boxes of BOX = 16 rows; block `rank` of the cluster owns boxes
// rank, rank + CL, rank + 2 CL, ... (interleaved, so at any pos the blocks
// share the written rows within a box each). Each block:
//   1. reads pos, and starts TMA loads (4-D tensor maps over the caches'
//      own strides) of its K boxes up to pos on one mbarrier. A block with
//      no box loads nothing but still takes part in every cluster barrier.
//   2. computes the scaled scores of its g heads over its written rows into
//      shared memory (groups of LANES threads a row, q staged in shared
//      memory, shuffle sums), starts the TMA loads of its V boxes into the
//      shared memory K held (half the tiles: 34 KB a block at GPT-2
//      small's shape), and takes each head's max over its scores.
//   3. exchanges the maxima over distributed shared memory (DSMEM): after a
//      cluster barrier every block reads the ranks' maxima in rank order
//      and takes the row max M.
//   4. forms e = exp(s - M) in place and its sum, and exchanges the sums the
//      same way: every block adds the ranks' sums in rank order, so every
//      block holds the same L.
//   5. forms p = T(e / L) as the three-pass design does (the global
//      normalisation before the rounding, as in the reference) and
//      accumulates its f32 P V partial [g, d] (the V tiles landed during
//      steps 3-4): rows summed by shuffles in each warp, warps in order.
//   6. rank 0 sums the ranks' partials in rank order over DSMEM, rounds
//      once and writes out; a last cluster barrier keeps every block's
//      shared memory alive until rank 0 has read it.
// Rows past pos are loaded with their box (TMA reads whole boxes) but never
// reach an exponent or a product: every loop stops at the written rows.
// Shared memory holds ceil(ceil(max_len / 16) / CL) boxes (of K, then of V),
// the scores (g x rows x 4 bytes) and the partials; where that passes a
// block's 227 KB (a long max_len at a large group or head dim), the plan
// keeps:
//
// Design "fma" (three passes, the first design):
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
// Blocks whose chunk starts past pos return at once: the grid is sized by
// max_len (static, so a graph capture holds), the work by pos.
//
// Neither design uses float atomics: every sum has one order, so reruns are
// bit-identical. A captured decode graph bakes the cluster design's tensor
// maps, which hold the caches' addresses, as it bakes every kernel's
// pointers: the serving loop's caches are allocated once per (model, batch)
// and written in place, so the addresses hold for the graph's life.
//
// Layout: q [b, 1, h, d] and out [b, 1, h, d] by (batch, head) strides; the
// caches [b, max_len, kv_h, d] by (batch, position, head) strides, unit
// stride in d, 16-byte aligned rows (the wrapper checks). Head dims 32, 64,
// 128 and 256; f32 or bf16; g at most MAX_GROUP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int THREADS = 256;
constexpr int CHUNK = 64;      // positions per block
constexpr int HEAD_TILE = 4;   // query heads accumulated at once in pass 2
constexpr int MAX_GROUP = 32;  // query heads per K/V head
// the cluster design
constexpr int CTHREADS = 128;  // threads of a block
constexpr int CWARPS = CTHREADS / 32;
constexpr int BOX = 16;        // cache rows of one TMA box
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take

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

// ------------------------------------------------------ the cluster design

// Byte offsets of the cluster kernel's shared memory: `slots` boxes of K,
// which V's boxes replace once the scores are taken (each box BOX rows of
// D values, 128-byte aligned), the scores
// [g][slots * BOX], q [g][D], the block's P V partial [g][D], the warps'
// partials [CWARPS][min(g, HEAD_TILE)][D], the maxima, sums and row sums
// [g] each, and two mbarriers. ops/attention.py decode_plan mirrors it.
struct ClusterLayout {
  int k, v, scores, q, pv, red, stats, bars, bytes;
  __host__ __device__ ClusterLayout(int group, int slots, int d, int esize) {
    const int box_bytes = BOX * d * esize;
    k = 0;
    v = 0;  // V lands where K was
    scores = slots * box_bytes;
    q = scores + group * slots * BOX * 4;
    pv = q + group * d * 4;
    red = pv + group * d * 4;
    stats = red + CWARPS * (group < HEAD_TILE ? group : HEAD_TILE) * d * 4;
    bars = stats + (3 * group * 4 + 15) / 16 * 16;
    bytes = bars + 16;
  }
};

// Boxes a block holds: the cache's boxes dealt round the cluster.
__host__ __device__ __forceinline__ int cluster_slots(int max_len,
                                                     int cluster) {
  return ((max_len + BOX - 1) / BOX + cluster - 1) / cluster;
}

// grid (cluster, kv_h, b), clusters of `cluster` blocks along x.
template <typename T, int D>
__global__ void __launch_bounds__(CTHREADS)
    decode_cluster_kernel(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const T* __restrict__ q, const int64_t* __restrict__ pos,
                   T* __restrict__ out, int max_len, int group, int slots,
                   Strides sq, Strides so, float scale) {
  using M = RowMap<T, D>;
  constexpr int ROWS = CTHREADS / M::LANES;  // K or V rows read at once
  extern __shared__ __align__(128) unsigned char smem[];
  const ClusterLayout lay(group, slots, D, sizeof(T));
  const T* k_s = reinterpret_cast<const T*>(smem + lay.k);
  const T* v_s = reinterpret_cast<const T*>(smem + lay.v);
  float* sc = reinterpret_cast<float*>(smem + lay.scores);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* pv = reinterpret_cast<float*>(smem + lay.pv);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* xmax = reinterpret_cast<float*>(smem + lay.stats);
  float* xsum = xmax + group;
  float* lsum = xsum + group;
  const uint32_t bar_k = smem_u32(smem + lay.bars), bar_v = bar_k + 8;

  const int cl = gridDim.x;  // the grid is one cluster wide
  const int rank = static_cast<int>(cluster_rank());
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane32 = tid % 32;
  const int n = written(pos, max_len);
  const int nbox = (n + BOX - 1) / BOX;
  const int mine = nbox > rank ? (nbox - rank + cl - 1) / cl : 0;
  // the written rows of this block's boxes: a prefix, since only the last
  // box of all (this block's last, if it is this block's) is partial
  int rows = mine * BOX;
  if (mine && (nbox - 1) % cl == rank) rows -= nbox * BOX - n;
  const int cap = slots * BOX;

  if (tid == 0) {
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    mbar_init_fence();
    if (mine) {
      constexpr uint32_t box_bytes = BOX * D * sizeof(T);
      mbar_arrive_expect_tx(bar_k, mine * box_bytes);
      for (int i = 0; i < mine; ++i)
        tma_load_4d(smem_u32(k_s + i * BOX * D), &tm_k, 0,
                    (rank + i * cl) * BOX, kh, b, bar_k);
    }
  }
  for (int i = tid; i < group * D; i += CTHREADS) {
    const int head = kh * group + i / D;
    q_s[i] = to_float(q[b * sq.b + head * sq.h + i % D]);
  }
  __syncthreads();  // q staged, the barriers initialised

  // 2. scaled scores of the written rows, each head's block max
  const int lane = tid % M::LANES, row = tid / M::LANES;
  if (mine) mbar_wait(bar_k, 0);
  // every thread runs every round, so the shuffles see whole warps
  for (int t0 = 0; t0 < rows; t0 += ROWS) {
    const int t = t0 + row;
    const bool valid = t < rows;
    float kv[M::PER_THREAD];
    if (valid) {
      load_row<T, D>(k_s + t * D, lane, kv);
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
      if (valid && lane == 0) sc[gi * cap + t] = acc * scale;
    }
  }
  fence_proxy_async();
  __syncthreads();  // every thread is done with K: V's boxes replace it
  if (tid == 0 && mine) {
    constexpr uint32_t box_bytes = BOX * D * sizeof(T);
    mbar_arrive_expect_tx(bar_v, mine * box_bytes);
    for (int i = 0; i < mine; ++i)
      tma_load_4d(smem_u32(v_s + i * BOX * D), &tm_v, 0,
                  (rank + i * cl) * BOX, kh, b, bar_v);
  }
  for (int gi = warp; gi < group; gi += CWARPS) {
    float m = -CUDART_INF_F;
    for (int t = lane32; t < rows; t += 32) m = fmaxf(m, sc[gi * cap + t]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane32 == 0) xmax[gi] = m;
  }
  cluster_sync();  // 3. every block's maxima visible

  // 4. e = exp(s - M) in place, its block sum; M from every rank
  for (int gi = warp; gi < group; gi += CWARPS) {
    float m = -CUDART_INF_F;
    for (int r = 0; r < cl; ++r) m = fmaxf(m, cluster_peer(xmax, r)[gi]);
    float l = 0.f;
    for (int t = lane32; t < rows; t += 32) {
      const float e = expf(sc[gi * cap + t] - m);
      sc[gi * cap + t] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane32 == 0) xsum[gi] = l;
  }
  cluster_sync();  // every block's sums visible
  for (int gi = tid; gi < group; gi += CTHREADS) {
    float l = 0.f;
    for (int r = 0; r < cl; ++r) l += cluster_peer(xsum, r)[gi];
    lsum[gi] = l;
  }
  __syncthreads();

  // 5. p = T(e / L), the block's P V partial
  if (mine) mbar_wait(bar_v, 0);
  const int ht = group < HEAD_TILE ? group : HEAD_TILE;
  for (int g0 = 0; g0 < group; g0 += HEAD_TILE) {
    const int tile = min(HEAD_TILE, group - g0);
    float acc[HEAD_TILE][M::PER_THREAD];
#pragma unroll
    for (int u = 0; u < HEAD_TILE; ++u)
#pragma unroll
      for (int i = 0; i < M::PER_THREAD; ++i) acc[u][i] = 0.f;
    for (int t = row; t < rows; t += ROWS) {
      float vr[M::PER_THREAD];
      load_row<T, D>(v_s + t * D, lane, vr);
#pragma unroll
      for (int u = 0; u < HEAD_TILE; ++u) {
        if (u < tile) {
          const int gi = g0 + u;
          const float p = to_float(from_float<T>(sc[gi * cap + t] / lsum[gi]));
#pragma unroll
          for (int i = 0; i < M::PER_THREAD; ++i)
            acc[u][i] = fmaf(p, vr[i], acc[u][i]);
        }
      }
    }
    // the warp's rows by a shuffle tree, then the warps in order
#pragma unroll
    for (int u = 0; u < HEAD_TILE; ++u) {
      if (u < tile) {
#pragma unroll
        for (int i = 0; i < M::PER_THREAD; ++i)
#pragma unroll
          for (int off = M::LANES; off < 32; off *= 2)
            acc[u][i] += __shfl_xor_sync(0xffffffffu, acc[u][i], off);
      }
    }
    if (lane32 < M::LANES)
      for (int u = 0; u < tile; ++u)
#pragma unroll
        for (int i = 0; i < M::PER_THREAD; ++i)
          red[(warp * ht + u) * D + column<T, D>(i, lane)] = acc[u][i];
    __syncthreads();
    for (int i = tid; i < tile * D; i += CTHREADS) {
      const int u = i / D, col = i % D;
      float sum = 0.f;
      for (int w = 0; w < CWARPS; ++w) sum += red[(w * ht + u) * D + col];
      pv[(g0 + u) * D + col] = sum;
    }
    __syncthreads();  // red is rewritten by the next head tile
  }
  cluster_sync();  // 6. every block's partial visible

  if (rank == 0) {
    const int used = nbox < cl ? nbox : cl;
    for (int i = tid; i < group * D; i += CTHREADS) {
      float sum = 0.f;
      for (int r = 0; r < used; ++r) sum += cluster_peer(pv, r)[i];
      const int head = kh * group + i / D;
      out[b * so.b + head * so.h + i % D] = from_float<T>(sum);
    }
  }
  cluster_sync();  // rank 0 has read every block's shared memory
}

template <typename T, int D>
cudaLaunchConfig_t cluster_config(int batch, int kv_heads, int cluster,
                                  int bytes, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster, kv_heads, batch);
  config.blockDim = dim3(CTHREADS);
  config.dynamicSmemBytes = bytes;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The shared-memory limit and clusters of 16, once a device.
template <typename T, int D>
cudaError_t cluster_attributes() {
  static std::atomic<uint64_t> done{0};
  return allow_cluster_once(
      done, reinterpret_cast<const void*>(decode_cluster_kernel<T, D>),
      SMEM_LIMIT);
}

bool valid_cluster(int cluster) {
  return cluster == 2 || cluster == 4 || cluster == 8 || cluster == 16;
}

template <typename T, int D>
cudaError_t launch_cluster(const void* q, const void* k, const void* v,
                           const int64_t* pos, void* out, int batch,
                           int max_len, int heads, int kv_heads, int cluster,
                           int slots, Strides sq, Strides sk, Strides sv,
                           Strides so, float scale, cudaStream_t stream) {
  const int group = heads / kv_heads;
  const ClusterLayout lay(group, slots, D, sizeof(T));
  if (!valid_cluster(cluster) || slots != cluster_slots(max_len, cluster) ||
      lay.bytes > SMEM_LIMIT)
    return cudaErrorInvalidValue;
  constexpr bool bf16 = sizeof(T) == 2;
  const cuuint64_t es = sizeof(T);
  const cuuint32_t box[4] = {(cuuint32_t)D, BOX, 1, 1};
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)max_len,
                              (cuuint64_t)kv_heads, (cuuint64_t)batch};
  const cuuint64_t k_strides[3] = {sk.s * es, sk.h * es, sk.b * es};
  const cuuint64_t v_strides[3] = {sv.s * es, sv.h * es, sv.b * es};
  CUtensorMap tm_k, tm_v;
  cudaError_t err = make_map_plain(&tm_k, k, 4, bf16, dims, k_strides, box);
  if (err == cudaSuccess)
    err = make_map_plain(&tm_v, v, 4, bf16, dims, v_strides, box);
  if (err == cudaSuccess) err = cluster_attributes<T, D>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config =
      cluster_config<T, D>(batch, kv_heads, cluster, lay.bytes, &attr);
  config.stream = stream;
  return cudaLaunchKernelEx(&config, decode_cluster_kernel<T, D>, tm_k, tm_v,
                            static_cast<const T*>(q), pos,
                            static_cast<T*>(out), max_len, group, slots, sq,
                            so, scale);
}

// Clusters of the design that can be resident at once on the current
// device for this shape (cudaOccupancyMaxActiveClusters), or -1.
template <typename T, int D>
int cluster_occupancy(int batch, int kv_heads, int group, int cluster,
                      int slots) {
  const ClusterLayout lay(group, slots, D, sizeof(T));
  if (!valid_cluster(cluster) || lay.bytes > SMEM_LIMIT ||
      cluster_attributes<T, D>() != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config =
      cluster_config<T, D>(batch, kv_heads, cluster, lay.bytes, &attr);
  int clusters = -1;
  if (cudaOccupancyMaxActiveClusters(
          &clusters, reinterpret_cast<const void*>(decode_cluster_kernel<T, D>),
          &config) != cudaSuccess)
    return -1;
  return clusters;
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

// The cluster design's launch and occupancy query, for by_type.
struct ClusterCall {
  const void *q, *k, *v;
  const int64_t* pos;
  void* out;
  int batch, max_len, heads, kv_heads, cluster, slots;
  Strides sq, sk, sv, so;
  float scale;
  cudaStream_t stream;
  template <typename T, int D>
  int run() const {
    return launch_cluster<T, D>(q, k, v, pos, out, batch, max_len, heads,
                                kv_heads, cluster, slots, sq, sk, sv, so,
                                scale, stream);
  }
};

struct OccupancyCall {
  int batch, kv_heads, group, cluster, slots;
  template <typename T, int D>
  int run() const {
    return cluster_occupancy<T, D>(batch, kv_heads, group, cluster, slots);
  }
};

// Calls fn.template run<T, D>() for the dtype code (0 = f32, 1 = bf16) and
// head dim, or returns `bad` for one the kernels are not built for.
template <typename Fn, typename R>
R by_type(int dtype, int head_dim, Fn fn, R bad) {
#define DECODE_DIMS(T)                                   \
  switch (head_dim) {                                    \
    case 32: return fn.template run<T, 32>();            \
    case 64: return fn.template run<T, 64>();            \
    case 128: return fn.template run<T, 128>();          \
    case 256: return fn.template run<T, 256>();          \
    default: return bad;                                 \
  }
  if (dtype == 0) DECODE_DIMS(float)
  if (dtype == 1) DECODE_DIMS(__nv_bfloat16)
#undef DECODE_DIMS
  return bad;
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

// The cluster design (see the header): one launch, no scratch. `cluster`
// is 2, 4, 8 or 16 blocks and `slots` ceil(ceil(max_len / 16) / cluster),
// the boxes of K and of V each block holds (ops/attention.py decode_plan);
// a shape whose shared memory passes a block's limit, or a wrong `slots`,
// returns cudaErrorInvalidValue. Other arguments as decode_attn's.
int decode_attn_cluster(const void* q, const void* k, const void* v,
                        const void* pos, void* out, int dtype, int batch,
                        int max_len, int heads, int kv_heads, int head_dim,
                        int cluster, int slots, int64_t sq_b,
                        int64_t sq_h, int64_t sk_b, int64_t sk_s,
                        int64_t sk_h, int64_t sv_b, int64_t sv_s,
                        int64_t sv_h, int64_t so_b, int64_t so_h,
                        float scale, void* stream) {
  if (batch <= 0 || max_len <= 0 || kv_heads <= 0 || heads % kv_heads ||
      heads / kv_heads > MAX_GROUP)
    return cudaErrorInvalidValue;
  const ClusterCall run{q, k, v, static_cast<const int64_t*>(pos), out, batch,
                max_len, heads, kv_heads, cluster, slots,
                Strides{sq_b, 0, sq_h},
                Strides{sk_b, sk_s, sk_h}, Strides{sv_b, sv_s, sv_h},
                Strides{so_b, 0, so_h}, scale,
                static_cast<cudaStream_t>(stream)};
  return by_type(dtype, head_dim, run, (int)cudaErrorInvalidValue);
}

// Clusters of the cluster design resident at once on the current device
// for this shape (cudaOccupancyMaxActiveClusters); -1 where it cannot run.
int decode_attn_cluster_occupancy(int dtype, int batch, int kv_heads,
                                  int group, int head_dim, int cluster,
                                  int slots) {
  return by_type(dtype, head_dim,
                 OccupancyCall{batch, kv_heads, group, cluster, slots}, -1);
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
