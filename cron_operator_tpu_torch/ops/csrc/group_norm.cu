// GroupNorm over channels-last tensors for Hopper (sm_90a), forward and
// backward, plain C interface for ctypes.
//
// No Pallas kernel stands behind this one: on the TPU, XLA compiles flax's
// nn.GroupNorm (cron_operator_tpu/models/resnet.py:38, and every norm of
// that file) into the convolutions' fusions. The port's plain version
// (ops/group_norm.py group_norm_reference) casts x to f32, lets
// F.group_norm copy the channels-last tensor to NCHW, and casts back; its
// autograd saves the f32 copy. This pair reads the bf16 (or f32) NHWC
// tensor as it lies and keeps only f32 statistics.
//
// Function (G groups of Cg = C / G consecutive channels, n = Cg * H * W):
//   forward   mean_g, M2_g = sum (x - mean_g)^2 (or Chan's combination of
//             partial (n, mean, M2), in the two-pass design)
//             rstd_g = 1 / sqrt(M2_g / n + eps)
//             y = (x - mean_g) * (rstd_g * gamma_c) + beta_c   (flax's
//             order), in f32, rounded once to y's type
//   backward  xhat = (x - mean_g) * rstd_g, recomputed from x
//             s1_g = sum gamma_c dy, s2_g = sum gamma_c dy xhat over (b, g)
//             dx = rstd_g * (gamma_c dy - s1_g / n - xhat s2_g / n)
//             dgamma_c = sum_{b,h,w} dy xhat, dbeta_c = sum_{b,h,w} dy
// Epilogues, ResNet's ops after a norm (models/resnet.py), fused where y is
// written so that they cost no pass of their own:
//   forward   EPI_RELU z = relu(y); EPI_RESIDUAL_RELU z = relu(round(y) + r),
//             the residual r of y's type read from global memory beside the
//             store and added in f32, rounded once: a bf16 torch add and
//             relu, to the bit. The relu comes before the last rounding,
//             which keeps the sign.
//   backward  relu: dy is zeroed where round(y) <= 0, y recomputed from x
//             by the forward's expression (norm_y, the same mean, rstd,
//             gamma, beta), before any sum reads it: the unmasked kernel fed
//             dy * (z > 0), to the bit. The residual's mask stays outside
//             (ops/group_norm.py: z is saved, and dres is the masked dy).
// No float atomics: every sum and merge has one order, so reruns are
// bit-identical. Nothing here allocates or synchronises; the wrapper hands
// in the outputs and every scratch buffer, and a graph capture holds.
//
// Bound: bytes. The forward must read x and write y, the backward read x
// and dy and write dx (the statistics and gamma are B * G and C floats).
// ResNet-50's 53 norms at b 128 x 224^2 hold 1,422,589,952 elements a
// step: 5.69 GB forward and 8.54 GB backward in bf16, 1.699 + 2.549 ms at
// 3.35 TB/s (2 and 3 units of traffic); the largest norm (C 64 at 112^2,
// 102.8 M elements) 122.7 and 184.0 us. The residual epilogue reads one
// unit more: its 16 norms hold 353 M elements, 0.422 ms. The arithmetic is
// a few operations an element.
//
// Each direction has two designs; ops/group_norm.py forward_plan and
// backward_plan pick one by shape: "cluster" wherever it fits.
//
// Design "cluster" (the main path both ways): one thread-block cluster of CL
// blocks (1, 2, 4, 8 or 16) per (b, slab), the slab chosen so that the
// (b, slab)'s held tensors (x forward; x and dy backward) fit the cluster's
// shared memory and hold whole groups. The plan takes the smallest CL whose
// blocks fit half an SM (two blocks an SM, one's loads beside the other's
// stores) with pixel rows of 64 bytes or more. At ResNet-50's shapes in
// bf16: forward 8 blocks of 32 channels at 112^2, 2 of 32 at 56^2, one block
// of 64 at 28^2 and of 256 at 14^2 and 7^2; backward 16 of 32 at 112^2, 4 of
// 32 at 56^2, one block of 32 at 28^2, of 128 at 14^2 and of 256 at 7^2
// (hack/torch_cluster_sweep.py times the alternatives). Block `rank` takes
// pixels [rank * pix, (rank + 1) * pix) of the map and TMA-loads them (3-D
// maps [C, HW, B], boxes of [box_pix <= 256 pixels, slab channels], each box
// on its own mbarrier, all issued at once). A per-channel sum is a thread's
// pixels in one chain, the warp's rows by a shuffle tree and the warps in
// order; after a cluster barrier every block reads the ranks' partials over
// distributed shared memory in rank order (so every block holds the same
// bits), and a group's channels are summed by a tree.
// - Forward, fwd_cluster_kernel: the statistics by two exact passes over the
//   tile in shared memory. The channel sums give mean_g after one exchange,
//   then sum (x - mean_g)^2 gives M2_g after a second. Chosen over one
//   exchange of Chan-merged (n, mean, M2) partials: a thread's partial M2
//   needs its pixels twice either way, so the cost is one more cluster
//   barrier, and the centred squares keep the variance free of cancellation
//   at any mean. Rank 0 writes mean and rstd (finalize_kernel's formula); y
//   is normalize_kernel's expression on the x still in shared memory, stored
//   from registers in one place. x is read once and y written once: 2 units
//   of traffic, the bound's. The three passes over the tile are the
//   kernel's compute, which two blocks an SM overlap with each other's
//   loads: each thread walks its pixels box by box (no division a pixel),
//   and y is packed two bf16 values an instruction. Tried and dropped
//   (PERF.md section 6): y over the x tile and a TMA store (slower), a
//   persistent cluster with two units' tiles in flight at one block an SM
//   (slower: eight warps cannot hide the passes' latency).
// - Backward, bwd_cluster_kernel: per-channel (sum dy xhat, sum dy), one
//   exchange, the gamma-weighted s1, s2 of each group (rank 0 writes
//   sums[b, c]), then dx from the x and dy in shared memory, in the two-pass
//   formula; bwd_dgamma_kernel, a second launch, sums dgamma and dbeta over b
//   in order as dx_kernel's last blocks do. 3 units of traffic, the bound's.
// Sum depth: the held tiles fit 227 KB, so a thread's chain is at most
// pix * slab * size / (16 * 256) <= 57 pixels (25 at ResNet-50's shapes);
// then 3 shuffle levels, 8 warps, 16 ranks and 8 tree levels over a group's
// channels: under the 2^8 sequential additions the tolerance's SUM_ORDER
// bounds.
//
// Design "two_pass", kept for shapes past a cluster's shared memory:
// - Layout. A group is 2-64 adjacent channels, 4-128 bytes of bf16 a pixel:
//   a block per (b, g) would read short strided runs. A block reads whole
//   slabs of a pixel row instead: SLAB = min(C, 256) channels (512 bytes of
//   bf16), as 16-byte vectors, one per thread and pixel; the 256 threads
//   are rows x cols (cols = SLAB / vector) and each reads PIX = 8 pixels
//   rows apart, so a warp's loads are contiguous. A thread keeps its 8
//   vectors packed (32 registers for bf16) and widens each value where it
//   uses it, so two or three blocks share an SM and one block's reduction
//   overlaps another's loads.
// - Parallelism. A tile is (b, slab, rows * 8 pixels): 8-16 K elements.
//   The statistics of a (b, g) are split over the tiles and merged in a
//   second, ordered step, so every shape gives 256-6,272 blocks for 132
//   SMs, not 128 blocks of one sample each.
// - Forward: stats_kernel (a thread's 8 pixels by two passes in registers,
//   then each group's rows x Cg per-channel partials combined at once:
//   mean = sum n_i mean_i / N, M2 = sum M2_i + n_i (mean_i - mean)^2, each
//   sum a fixed tree over the group's threads); finalize_kernel (a warp per
//   (b, g) merges the tiles' partials pairwise in order); normalize_kernel
//   (the second read of x): 3 units of traffic where the bound needs 2.
// - Backward: bwd_partials_kernel (per (b, tile, c) sums of dy xhat and dy
//   over the tile's pixels); bwd_sum_kernel (per (b, c) over the tiles in
//   order, then s1 / n and s2 / n of each (b, g) by a tree over its Cg
//   channels); dx_kernel (the second read of x and dy), whose last C / 32
//   blocks sum dgamma, dbeta over b in order: 5 units where the bound needs
//   3.
// C must be a power of two with G | C, C / G <= 256 and C at least one
// vector (8 bf16, 4 f32); the wrapper checks the layout (NHWC-contiguous,
// 16-byte aligned).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

// the forward's epilogues (ops/group_norm.py EPILOGUES, in order); the
// backward takes 0 or EPI_RELU
constexpr int EPI_NONE = 0;
constexpr int EPI_RELU = 1;
constexpr int EPI_RESIDUAL_RELU = 2;
// residual pixels a thread reads ahead of its stores in the cluster forward,
// so that its global loads overlap
constexpr int RES_AHEAD = 4;

constexpr int THREADS = 256;
constexpr int PIX = 8;         // pixels each thread reads in a tile
constexpr int MAX_SLAB = 256;  // channels of a slab
constexpr int DG_CHANNELS = 32;
constexpr int DG_LANES = THREADS / DG_CHANNELS;
// the cluster designs
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BOX = 256;        // pixels of a TMA box
constexpr int MAX_CLUSTER = 16;     // 8 portable, 16 with the opt-in
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take

struct Tiling {
  int slab;      // channels a block reads of each pixel
  int slabs;     // C / slab
  int cols;      // vectors across a slab
  int rows;      // THREADS / cols
  int pix_tile;  // pixels of a tile: rows * PIX
  int tiles;     // tiles of a (b, slab)
  int cg;        // channels of a group
  int cg_log2;
};

bool power_of_two(int v) { return v > 0 && (v & (v - 1)) == 0; }

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Returns false for a shape the kernels do not take.
bool make_tiling(int channels, int hw, int groups, int vec, Tiling* t) {
  if (!power_of_two(channels) || !power_of_two(groups) || channels < vec ||
      groups > channels || hw <= 0)
    return false;
  t->slab = channels < MAX_SLAB ? channels : MAX_SLAB;
  t->slabs = channels / t->slab;
  t->cols = t->slab / vec;
  t->rows = THREADS / t->cols;
  t->pix_tile = t->rows * PIX;
  t->tiles = (hw + t->pix_tile - 1) / t->pix_tile;
  t->cg = channels / groups;
  t->cg_log2 = log2_of(t->cg);
  return t->cg <= t->slab;
}

int vec_of(int dtype) { return dtype == 0 ? 4 : 8; }

// V values of T kept as they lie in memory (V * sizeof(T) is 8, 16 or 32
// bytes), read and written in 8- or 16-byte accesses, widened to f32 one
// value at a time.
template <typename T, int V>
struct Packed {
  static constexpr int WORDS = V * (int)sizeof(T) / 4;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (WORDS >= 4) {
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + k);
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    }
  }

  // the same from shared memory (a generic pointer, no __ldg)
  __device__ __forceinline__ void load_shared(const T* p) {
    if constexpr (WORDS >= 4) {
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[k];
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    }
  }

  __device__ __forceinline__ void store(T* p) const {
    if constexpr (WORDS >= 4) {
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k)
        reinterpret_cast<uint4*>(p)[k] =
            make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    }
  }

  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[j]);
    } else {  // bf16: the upper half of an f32
      const uint32_t v = w[j >> 1];
      return __uint_as_float((j & 1) ? (v & 0xffff0000u) : (v << 16));
    }
  }

  // V values rounded once each (bf16 two at a time, low half first)
  static __device__ __forceinline__ Packed of(const float (&f)[V]) {
    Packed out;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) {
      if constexpr (sizeof(T) == 4) {
        out.w[k] = __float_as_uint(f[k]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
        out.w[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    return out;
  }

  __device__ __forceinline__ void set(int j, float f) {
    if constexpr (sizeof(T) == 4) {
      w[j] = __float_as_uint(f);
    } else {
      const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(f));
      w[j >> 1] = (j & 1) ? ((w[j >> 1] & 0xffffu) | (h << 16))
                          : ((w[j >> 1] & 0xffff0000u) | h);
    }
  }
};

// y before its rounding, the one expression every forward writes and the
// backward's relu mask recomputes: (x - mean) * (rstd * gamma) + beta, with
// mul = norm_mul(rstd, gamma) and add = beta. Explicit roundings, so that no
// contraction can make two call sites differ.
__device__ __forceinline__ float norm_mul(float rstd, float gamma) {
  return __fmul_rn(rstd, gamma);
}

__device__ __forceinline__ float norm_y(float x, float mean, float mul,
                                        float add) {
  return fmaf(__fsub_rn(x, mean), mul, add);
}

// f rounded to T and widened back
template <typename T>
__device__ __forceinline__ float round_to(float f) {
  if constexpr (sizeof(T) == 4)
    return f;
  else
    return __bfloat162float(__float2bfloat16_rn(f));
}

// z of epilogue EPI from y (not yet rounded) and the residual r: y,
// relu(y) or relu(round(y) + r), still to be rounded to TY once. A NaN
// stays NaN, as torch's relu keeps it.
template <int EPI, typename TY>
__device__ __forceinline__ float epilogue(float y, float r) {
  if constexpr (EPI == EPI_RESIDUAL_RELU) y = __fadd_rn(round_to<TY>(y), r);
  if constexpr (EPI != EPI_NONE) y = (y > 0.f || y != y) ? y : 0.f;
  return y;
}

// Whether the forward's relu passed the gradient at x: round_TY(y) > 0,
// with y recomputed by norm_y.
template <typename TY>
__device__ __forceinline__ bool relu_passes(float x, float mean, float mul,
                                            float add) {
  return round_to<TY>(norm_y(x, mean, mul, add)) > 0.f;
}

// Chan's merge of (nb, mb, m2b) into (n, m, m2); an empty side is a no-op.
__device__ __forceinline__ void chan_merge(float& n, float& m, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    m = mb;
    m2 = m2b;
    return;
  }
  const float nn = n + nb;
  const float d = mb - m;
  const float f = nb / nn;
  m = m + d * f;
  m2 = m2 + m2b + d * d * n * f;
  n = nn;
}

// The sum of v over the tpg consecutive threads of a group (tpg a power of
// two), the same bits in each: a butterfly within the warp (a + b == b + a,
// so both partners of each exchange hold one value), then the group's
// warps in order through `scratch` (one float a warp).
__device__ __forceinline__ float group_sum(float v, int tpg,
                                           float* scratch) {
  const int width = tpg < 32 ? tpg : 32;
  for (int off = width / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (tpg > 32) {
    __syncthreads();  // the scratch's last readers are done
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
    __syncthreads();
    const int warps = tpg / 32, first = threadIdx.x / tpg * warps;
    v = 0.f;
    for (int k = 0; k < warps; ++k) v += scratch[first + k];
  }
  return v;
}

// Pixels that thread row `row` of tile `tile` reads (its first valid ones).
__device__ __forceinline__ int row_count(const Tiling& t, int tile, int row,
                                         int hw) {
  const int left = hw - tile * t.pix_tile - row;
  if (left <= 0) return 0;
  const int k = (left + t.rows - 1) / t.rows;
  return k < PIX ? k : PIX;
}

__device__ __forceinline__ int tile_pixels(const Tiling& t, int tile, int hw) {
  const int left = hw - tile * t.pix_tile;
  return left < t.pix_tile ? left : t.pix_tile;
}

// ---------------------------------------------------------------- forward

// grid (tiles, slabs, b). part: [b, groups, tiles] of (mean, M2).
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
    stats_kernel(const T* __restrict__ x, float2* __restrict__ part, int hw,
                 int channels, int groups, Tiling t) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float s_mean[THREADS * V];  // [row][channel of the slab]
  __shared__ float s_m2[THREADS * V];
  __shared__ float s_count[THREADS];  // pixels of each thread row
  __shared__ float scratch[THREADS / 32];
  const int tile = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, col = tid % t.cols, row = tid / t.cols;
  const int k = row_count(t, tile, row, hw);
  const T* base = x + ((int64_t)b * hw + (int64_t)tile * t.pix_tile + row) *
                          channels + slab * t.slab + col * V;
  Packed<T, V> v[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    if (i < k) v[i].load(base + (int64_t)i * t.rows * channels);
  const float inv_k = k ? 1.f / (float)k : 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < PIX; ++i)
      if (i < k) sum += v[i].get(j);
    const float mean = sum * inv_k;
    float m2 = 0.f;
#pragma unroll
    for (int i = 0; i < PIX; ++i)
      if (i < k) {
        const float d = v[i].get(j) - mean;
        m2 += d * d;
      }
    s_mean[row * t.slab + col * V + j] = mean;
    s_m2[row * t.slab + col * V + j] = m2;
  }
  if (col == 0) s_count[row] = (float)k;
  __syncthreads();
  // Group lg of the slab has rows * cg partials (entry e: row e / cg,
  // channel lg * cg + e % cg) = tpg * V: its tpg threads take V each.
  const int gs = t.slab / t.cg, tpg = THREADS / gs;
  const int lg = tid / tpg, lane = tid % tpg;
  float nm = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int e = lane * V + j, r = e >> t.cg_log2;
    nm += s_count[r] * s_mean[r * t.slab + lg * t.cg + (e & (t.cg - 1))];
  }
  const float n = (float)(tile_pixels(t, tile, hw) * t.cg);
  const float mean = group_sum(nm, tpg, scratch) / n;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int e = lane * V + j, r = e >> t.cg_log2;
    const int idx = r * t.slab + lg * t.cg + (e & (t.cg - 1));
    const float d = s_mean[idx] - mean;
    q += s_m2[idx] + s_count[r] * d * d;
  }
  const float m2 = group_sum(q, tpg, scratch);
  if (lane == 0) {
    const int g = slab * gs + lg;
    part[((int64_t)b * groups + g) * t.tiles + tile] = make_float2(mean, m2);
  }
}

// A warp per (b, g): the tiles' partials merged in order (lane l takes
// tiles l, l + 32, ...; then a shuffle tree), then mean and rstd.
__global__ void __launch_bounds__(THREADS)
    finalize_kernel(const float2* __restrict__ part, float* __restrict__ mean,
                    float* __restrict__ rstd, int batch, int hw, int groups,
                    float eps, Tiling t) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= batch * groups) return;
  const float2* p = part + (int64_t)warp * t.tiles;
  float n = 0.f, m = 0.f, m2 = 0.f;
  for (int tile = lane; tile < t.tiles; tile += 32)
    chan_merge(n, m, m2, (float)(tile_pixels(t, tile, hw) * t.cg), p[tile].x,
               p[tile].y);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, m, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    if (lane < off) chan_merge(n, m, m2, nb, mb, m2b);
  }
  if (lane == 0) {
    mean[warp] = m;
    rstd[warp] = 1.f / sqrtf(m2 / n + eps);
  }
}

// grid (tiles, slabs, b): y = (x - mean) * (rstd * gamma) + beta, then
// epilogue EPI (the residual, of y's type, read beside x).
template <typename TX, typename TY, int EPI>
__global__ void __launch_bounds__(THREADS, 2)
    normalize_kernel(const TX* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     const TY* __restrict__ residual, TY* __restrict__ y,
                     int hw, int channels, int groups, Tiling t) {
  constexpr int V = 16 / sizeof(TX);
  const int tile = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, col = tid % t.cols, row = tid / t.cols;
  const int c0 = slab * t.slab + col * V;
  const int k = row_count(t, tile, row, hw);
  const int64_t at =
      ((int64_t)b * hw + (int64_t)tile * t.pix_tile + row) * channels + c0;
  Packed<TX, V> v[PIX];
  Packed<TY, V> res[PIX] = {};
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    if (i < k) {
      v[i].load(x + at + (int64_t)i * t.rows * channels);
      if constexpr (EPI == EPI_RESIDUAL_RELU)
        res[i].load(residual + at + (int64_t)i * t.rows * channels);
    }
  float mu[V], mul[V], add[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j, bg = b * groups + (c >> t.cg_log2);
    mu[j] = mean[bg];
    mul[j] = norm_mul(rstd[bg], gamma[c]);
    add[j] = beta[c];
  }
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    if (i < k) {
      Packed<TY, V> out{};
#pragma unroll
      for (int j = 0; j < V; ++j)
        out.set(j, epilogue<EPI, TY>(norm_y(v[i].get(j), mu[j], mul[j],
                                            add[j]),
                                     res[i].get(j)));
      out.store(y + at + (int64_t)i * t.rows * channels);
    }
}

// Zeroes the dy values of PIX pixels (k of them valid) where the forward's
// relu stopped the gradient (relu_passes), channel c0 + j of each vector:
// the masked dy that every later read takes.
template <typename TX, typename TY, int V>
__device__ __forceinline__ void mask_pixels(const Packed<TX, V> (&xv)[PIX],
                                            Packed<TY, V> (&dv)[PIX], int k,
                                            int b, int c0, int groups,
                                            int cg_log2,
                                            const float* __restrict__ mean,
                                            const float* __restrict__ rstd,
                                            const float* __restrict__ gamma,
                                            const float* __restrict__ beta) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j, bg = b * groups + (c >> cg_log2);
    const float mu = mean[bg], mul = norm_mul(rstd[bg], gamma[c]),
                add = beta[c];
#pragma unroll
    for (int i = 0; i < PIX; ++i)
      if (i < k && !relu_passes<TY>(xv[i].get(j), mu, mul, add))
        dv[i].set(j, 0.f);
  }
}

// --------------------------------------------------------------- backward

// grid (tiles, slabs, b). part: [b, tiles, C] of (sum dy xhat, sum dy);
// with RELU, of the masked dy.
template <typename TX, typename TY, bool RELU>
__global__ void __launch_bounds__(THREADS, 2)
    bwd_partials_kernel(const TY* __restrict__ dy, const TX* __restrict__ x,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        float2* __restrict__ part, int hw, int channels,
                        int groups, Tiling t) {
  constexpr int V = 16 / sizeof(TX);
  __shared__ float s_a[THREADS * V];  // [row][channel of the slab]
  __shared__ float s_b[THREADS * V];
  const int tile = blockIdx.x, slab = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, col = tid % t.cols, row = tid / t.cols;
  const int c0 = slab * t.slab + col * V;
  const int k = row_count(t, tile, row, hw);
  const int64_t at =
      ((int64_t)b * hw + (int64_t)tile * t.pix_tile + row) * channels + c0;
  Packed<TX, V> xv[PIX];
  Packed<TY, V> dv[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    if (i < k) {
      xv[i].load(x + at + (int64_t)i * t.rows * channels);
      dv[i].load(dy + at + (int64_t)i * t.rows * channels);
    }
  if constexpr (RELU)
    mask_pixels(xv, dv, k, b, c0, groups, t.cg_log2, mean, rstd, gamma, beta);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int bg = b * groups + ((c0 + j) >> t.cg_log2);
    const float mu = mean[bg], r = rstd[bg];
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int i = 0; i < PIX; ++i)
      if (i < k) {
        const float d = dv[i].get(j);
        a += d * ((xv[i].get(j) - mu) * r);
        s += d;
      }
    s_a[row * t.slab + col * V + j] = a;
    s_b[row * t.slab + col * V + j] = s;
  }
  __syncthreads();
  if (tid < t.slab) {
    float sa = 0.f, sb = 0.f;
    for (int q = 0; q < t.rows; ++q) {
      sa += s_a[q * t.slab + tid];
      sb += s_b[q * t.slab + tid];
    }
    part[((int64_t)b * t.tiles + tile) * channels + slab * t.slab + tid] =
        make_float2(sa, sb);
  }
}

// A thread per (b, c): the tiles' partials summed in order into sums[b, c];
// then s1 / n and s2 / n of each (b, g) by a tree over its cg consecutive
// channels (a block's 256 channels hold whole groups) into coef[b, g].
__global__ void __launch_bounds__(THREADS)
    bwd_sum_kernel(const float2* __restrict__ part,
                   const float* __restrict__ gamma, float2* __restrict__ sums,
                   float2* __restrict__ coef, int batch, int hw, int channels,
                   Tiling t) {
  __shared__ float s1[THREADS], s2[THREADS];
  const int tid = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * THREADS + tid;
  const bool live = i < (int64_t)batch * channels;
  const int64_t b = i / channels;
  const int c = (int)(i % channels);
  float sa = 0.f, sb = 0.f;
  if (live) {
    const float2* p = part + b * t.tiles * channels + c;
    for (int tile = 0; tile < t.tiles; ++tile) {
      const float2 v = p[(int64_t)tile * channels];
      sa += v.x;
      sb += v.y;
    }
    sums[i] = make_float2(sa, sb);
    s1[tid] = gamma[c] * sb;
    s2[tid] = gamma[c] * sa;
  } else {
    s1[tid] = 0.f;
    s2[tid] = 0.f;
  }
  __syncthreads();
  for (int s = t.cg / 2; s > 0; s >>= 1) {
    if ((tid & (t.cg - 1)) < s) {
      s1[tid] += s1[tid + s];
      s2[tid] += s2[tid + s];
    }
    __syncthreads();
  }
  if (live && (c & (t.cg - 1)) == 0) {
    const float n = (float)t.cg * (float)hw;
    coef[b * (channels >> t.cg_log2) + (c >> t.cg_log2)] =
        make_float2(s1[tid] / n, s2[tid] / n);
  }
}

// dgamma_c = sum_b sum dy xhat, dbeta_c = sum_b sum dy, in b's order, for
// the DG_CHANNELS channels of block `blk`: DG_LANES lanes over b, then the
// lanes in order.
__device__ __forceinline__ void dgamma_block(const float2* __restrict__ sums,
                                             float* __restrict__ dgamma,
                                             float* __restrict__ dbeta,
                                             int batch, int channels,
                                             int blk) {
  __shared__ float2 lanes[DG_LANES][DG_CHANNELS];
  const int tid = threadIdx.x;
  const int c = blk * DG_CHANNELS + tid % DG_CHANNELS;
  const int lane = tid / DG_CHANNELS;
  float sa = 0.f, sb = 0.f;
  if (c < channels)
    for (int b = lane; b < batch; b += DG_LANES) {
      const float2 v = sums[(int64_t)b * channels + c];
      sa += v.x;
      sb += v.y;
    }
  lanes[lane][tid % DG_CHANNELS] = make_float2(sa, sb);
  __syncthreads();
  if (tid < DG_CHANNELS && c < channels) {
    float ga = 0.f, gb = 0.f;
    for (int l = 0; l < DG_LANES; ++l) {
      ga += lanes[l][tid].x;
      gb += lanes[l][tid].y;
    }
    dgamma[c] = ga;
    dbeta[c] = gb;
  }
}

// 1-D grid: tiles * slabs * b blocks of dx (of the masked dy with RELU),
// then C / 32 blocks of dgamma and dbeta.
template <typename TX, typename TY, bool RELU>
__global__ void __launch_bounds__(THREADS, 2)
    dx_kernel(const TY* __restrict__ dy, const TX* __restrict__ x,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float2* __restrict__ sums, const float2* __restrict__ coef,
              TX* __restrict__ dx, float* __restrict__ dgamma,
              float* __restrict__ dbeta, int batch, int hw, int channels,
              int groups, Tiling t) {
  constexpr int V = 16 / sizeof(TX);
  const int tid = threadIdx.x;
  const int64_t n_dx = (int64_t)t.tiles * t.slabs * batch;
  if (blockIdx.x >= n_dx) {
    dgamma_block(sums, dgamma, dbeta, batch, channels,
                 (int)(blockIdx.x - n_dx));
    return;
  }
  const int tile = blockIdx.x % t.tiles;
  const int slab = (blockIdx.x / t.tiles) % t.slabs;
  const int b = blockIdx.x / (t.tiles * t.slabs);
  const int col = tid % t.cols, row = tid / t.cols;
  const int c0 = slab * t.slab + col * V;
  const int k = row_count(t, tile, row, hw);
  const int64_t at =
      ((int64_t)b * hw + (int64_t)tile * t.pix_tile + row) * channels + c0;
  Packed<TX, V> xv[PIX];
  Packed<TY, V> dv[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    if (i < k) {
      xv[i].load(x + at + (int64_t)i * t.rows * channels);
      dv[i].load(dy + at + (int64_t)i * t.rows * channels);
    }
  if constexpr (RELU)
    mask_pixels(xv, dv, k, b, c0, groups, t.cg_log2, mean, rstd, gamma, beta);
  float mu[V], r[V], g[V], c1[V], c2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = c0 + j, bg = b * groups + (c >> t.cg_log2);
    const float2 cf = coef[bg];
    mu[j] = mean[bg];
    r[j] = rstd[bg];
    g[j] = gamma[c];
    c1[j] = cf.x;
    c2[j] = cf.y;
  }
#pragma unroll
  for (int i = 0; i < PIX; ++i)
    if (i < k) {
      Packed<TX, V> out{};
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xhat = (xv[i].get(j) - mu[j]) * r[j];
        out.set(j, r[j] * (g[j] * dv[i].get(j) - c1[j] - xhat * c2[j]));
      }
      out.store(dx + at + (int64_t)i * t.rows * channels);
    }
}

template <typename TX, typename TY, int EPI>
int run_forward(const void* x, const float* gamma, const float* beta,
                const void* residual, void* y, float* mean, float* rstd,
                float2* part, int batch, int hw, int channels, int groups,
                float eps, const Tiling& t, cudaStream_t st) {
  const dim3 grid(t.tiles, t.slabs, batch);
  stats_kernel<TX><<<grid, THREADS, 0, st>>>(static_cast<const TX*>(x), part,
                                             hw, channels, groups, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = batch * groups;
  finalize_kernel<<<(warps * 32 + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, mean, rstd, batch, hw, groups, eps, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  normalize_kernel<TX, TY, EPI><<<grid, THREADS, 0, st>>>(
      static_cast<const TX*>(x), gamma, beta, mean, rstd,
      static_cast<const TY*>(residual), static_cast<TY*>(y), hw, channels,
      groups, t);
  return cudaGetLastError();
}

template <typename TX, typename TY, bool RELU>
int run_backward(const void* dy, const void* x, const float* mean,
                 const float* rstd, const float* gamma, const float* beta,
                 void* dx, float* dgamma, float* dbeta, float2* part,
                 float2* sums, float2* coef, int batch, int hw, int channels,
                 int groups, const Tiling& t, cudaStream_t st) {
  const TX* xp = static_cast<const TX*>(x);
  const TY* dyp = static_cast<const TY*>(dy);
  bwd_partials_kernel<TX, TY, RELU>
      <<<dim3(t.tiles, t.slabs, batch), THREADS, 0, st>>>(
          dyp, xp, mean, rstd, gamma, beta, part, hw, channels, groups, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bc = (int64_t)batch * channels;
  bwd_sum_kernel<<<(unsigned)((bc + THREADS - 1) / THREADS), THREADS, 0,
                   st>>>(part, gamma, sums, coef, batch, hw, channels, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)t.tiles * t.slabs * batch +
                         (channels + DG_CHANNELS - 1) / DG_CHANNELS;
  dx_kernel<TX, TY, RELU><<<(unsigned)blocks, THREADS, 0, st>>>(
      dyp, xp, mean, rstd, gamma, beta, sums, coef, static_cast<TX*>(dx),
      dgamma, dbeta, batch, hw, channels, groups, t);
  return cudaGetLastError();
}

// ------------------------------------------------------ the cluster designs

// A cluster design's plan (ops/group_norm.py forward_plan and backward_plan
// make it): slab channels, `cluster` blocks a (b, slab), `pix` pixels a
// block, boxes of `box_pix` pixels, `nbox` boxes a block.
struct ClusterPlan {
  int slab, cluster, pix, box_pix, nbox;
};

// Byte offsets of a cluster kernel's shared memory for held tensors of sx
// (x) and sy (dy; 0 for the forward, which holds x alone) bytes an element:
// nbox boxes of x, then of dy (each 128-byte aligned); for each held tensor
// a row groups' partials array [WARPS][slab] (the forward reuses its one
// for the sums, then the centred squares); the block's partials, two [slab]
// float arrays read by the other ranks; for each held tensor a group tree
// [slab]; and nbox mbarriers. ops/group_norm.py _fit mirrors it.
struct Layout {
  int box_x, box_dy, x, dy, red, blk, tree, bars, bytes;
  __host__ __device__ Layout(const ClusterPlan& p, int sx, int sy) {
    const int held = sy ? 2 : 1;
    box_x = (p.box_pix * p.slab * sx + 127) / 128 * 128;
    box_dy = (p.box_pix * p.slab * sy + 127) / 128 * 128;
    x = 0;
    dy = p.nbox * box_x;
    red = dy + p.nbox * box_dy;
    blk = red + held * WARPS * p.slab * 4;
    tree = blk + p.slab * 8;
    bars = tree + held * p.slab * 4;
    bytes = bars + p.nbox * 8;
  }
};

// One exchange of the cluster forward. Thread (row, col) holds v[j] of
// channel col * V + j of the slab: the sum over the (b, slab) of each
// channel (the warp's rows by a shuffle tree where cols < 32, the row
// groups in order through red: a warp each, or a row each where a row
// spans whole warps; then the ranks over DSMEM in order, so every block
// gets the same bits), then over each group's cg channels by a tree:
// tree[first] ends as the group's sum for each group's first channel.
// `part` is this exchange's [slab] of the block's partials, which the
// other ranks read after the cluster barrier.
template <int V>
__device__ __forceinline__ void cluster_group_sums(float (&v)[V], float* red,
                                                   float* part, float* tree,
                                                   const ClusterPlan& p,
                                                   int cols, int cg) {
  const int tid = threadIdx.x, col = tid % cols;
  if (cols < 32) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      for (int off = cols; off < 32; off *= 2)
        v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  }
  const int row_group = cols < 32 ? tid / 32 : tid / cols;
  const int parts = cols < 32 ? WARPS : THREADS / cols;
  if (cols >= 32 || (tid % 32) < cols)
#pragma unroll
    for (int j = 0; j < V; ++j) red[row_group * p.slab + col * V + j] = v[j];
  __syncthreads();
  if (tid < p.slab) {
    float s = 0.f;
    for (int k = 0; k < parts; ++k) s += red[k * p.slab + tid];
    part[tid] = s;
  }
  cluster_sync();  // every block's partials visible
  if (tid < p.slab) {
    float s = 0.f;
    for (int k = 0; k < p.cluster; ++k) s += cluster_peer(part, k)[tid];
    tree[tid] = s;
  }
  __syncthreads();
  for (int h = cg / 2; h > 0; h >>= 1) {
    if (tid < p.slab && (tid & (cg - 1)) < h) tree[tid] += tree[tid + h];
    __syncthreads();
  }
}

// grid (cluster, C / slab, b), clusters of `cluster` blocks along x.
template <typename TX, typename TY, int EPI>
__global__ void __launch_bounds__(THREADS, 2)
    fwd_cluster_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const TY* __restrict__ residual, TY* __restrict__ y,
                       float* __restrict__ mean, float* __restrict__ rstd,
                       int hw, int channels, int groups, float eps,
                       ClusterPlan p, int cg_log2) {
  constexpr int V = 16 / sizeof(TX);
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(p, sizeof(TX), 0);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* blk = reinterpret_cast<float*>(smem + lay.blk);  // sums, then M2s
  float* tree = reinterpret_cast<float*>(smem + lay.tree);
  const uint32_t bars = smem_u32(smem + lay.bars);

  const int rank = (int)cluster_rank();
  const int slab = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int start = rank * p.pix;
  const int npix = max(min(start + p.pix, hw) - start, 0);
  const int mine = (npix + p.box_pix - 1) / p.box_pix;
  const int cg = 1 << cg_log2;

  if (tid == 0) {
    for (int i = 0; i < p.nbox; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    for (int i = 0; i < mine; ++i) {
      const uint32_t bar = bars + 8 * i;
      mbar_arrive_expect_tx(bar, p.box_pix * p.slab * sizeof(TX));
      tma_load_3d(smem_u32(smem + lay.x + i * lay.box_x), &tm_x,
                  slab * p.slab, start + i * p.box_pix, b, bar);
    }
  }
  __syncthreads();  // the barriers initialised

  const int cols = p.slab / V, rows = THREADS / cols;
  const int col = tid % cols, row = tid / cols;
  const int c0 = slab * p.slab + col * V;
  // fn(pixel, its vector in shared memory) over the thread's pixels row,
  // row + rows, ... box by box (rows is a power of two, so a box's first
  // is a mask away: no division a pixel), in ascending order; with `wait`,
  // after each box's barrier. Every pass reads the pixels, so the boxes,
  // that the first one waited for.
  auto each = [&](bool wait, auto&& fn) {
    for (int i = 0; i < mine; ++i) {
      const int lo = i * p.box_pix, len = min(p.box_pix, npix - lo);
      int q = (row - lo) & (rows - 1);
      if (wait && q < len) mbar_wait(bars + 8 * i, 0);
      const TX* at =
          reinterpret_cast<const TX*>(smem + lay.x + i * lay.box_x) + col * V;
      for (; q < len; q += rows) fn(lo + q, at + q * p.slab);
    }
  };

  // 1. the channel sums as the boxes land, then mean_g
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = 0.f;
  each(true, [&](int, const TX* at) {
    Packed<TX, V> xv;
    xv.load_shared(at);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] += xv.get(j);
  });
  cluster_group_sums(v, red, blk, tree, p, cols, cg);
  const float n = (float)cg * (float)hw;
  float mu[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mu[j] = tree[(col * V + j) & ~(cg - 1)] / n;
  const bool writer = rank == 0 && tid < p.slab && (tid & (cg - 1)) == 0;
  const float group_mean = writer ? tree[tid] / n : 0.f;

  // 2. the centred squares, then M2_g (the second exchange writes tree only
  // after its cluster barrier, which every read of it above precedes)
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = 0.f;
  each(false, [&](int, const TX* at) {
    Packed<TX, V> xv;
    xv.load_shared(at);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = xv.get(j) - mu[j];
      v[j] += d * d;
    }
  });
  cluster_group_sums(v, red, blk + p.slab, tree, p, cols, cg);
  cluster_arrive();  // done reading the other blocks

  float mul[V], add[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float r = 1.f / sqrtf(tree[(col * V + j) & ~(cg - 1)] / n + eps);
    mul[j] = norm_mul(r, gamma[c0 + j]);
    add[j] = beta[c0 + j];
  }
  if (writer) {
    const int bg = b * groups + ((slab * p.slab + tid) >> cg_log2);
    mean[bg] = group_mean;
    rstd[bg] = 1.f / sqrtf(tree[tid] / n + eps);
  }

  // 3. y from the tile in shared memory and its epilogue: the one place y
  // is written. `each`'s walk, RES_AHEAD pixels at a time where a residual
  // is read from global memory, so that a thread's loads overlap.
  constexpr int AHEAD = EPI == EPI_RESIDUAL_RELU ? RES_AHEAD : 1;
  const int64_t first = ((int64_t)b * hw + start) * channels + c0;
  for (int i = 0; i < mine; ++i) {
    const int lo = i * p.box_pix, len = min(p.box_pix, npix - lo);
    const TX* tile =
        reinterpret_cast<const TX*>(smem + lay.x + i * lay.box_x) + col * V;
    for (int q = (row - lo) & (rows - 1); q < len; q += AHEAD * rows) {
      Packed<TY, V> res[AHEAD] = {};
      if constexpr (EPI == EPI_RESIDUAL_RELU) {
#pragma unroll
        for (int u = 0; u < AHEAD; ++u)
          if (q + u * rows < len)
            res[u].load(residual + first +
                        (int64_t)(lo + q + u * rows) * channels);
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int k = q + u * rows;
        if (k >= len) break;
        Packed<TX, V> xv;
        xv.load_shared(tile + k * p.slab);
        float o[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = epilogue<EPI, TY>(norm_y(xv.get(j), mu[j], mul[j], add[j]),
                                   res[u].get(j));
        Packed<TY, V>::of(o).store(y + first + (int64_t)(lo + k) * channels);
      }
    }
  }
  cluster_wait();  // the other blocks are done reading this one
}

// grid (cluster, C / slab, b), clusters of `cluster` blocks along x. With
// RELU the sums' pass masks each dy vector it reads and writes it back into
// the tile where it zeroed a value, so the dx pass reads the masked dy.
template <typename TX, typename TY, bool RELU>
__global__ void __launch_bounds__(THREADS, 2)
    bwd_cluster_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_dy,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, TX* __restrict__ dx,
                       float2* __restrict__ sums, int hw, int channels,
                       int groups, ClusterPlan p, int cg_log2) {
  constexpr int V = 16 / sizeof(TX);
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(p, sizeof(TX), sizeof(TY));
  float* red_a = reinterpret_cast<float*>(smem + lay.red);
  float* red_b = red_a + WARPS * p.slab;
  float2* blk = reinterpret_cast<float2*>(smem + lay.blk);
  float* t1 = reinterpret_cast<float*>(smem + lay.tree);
  float* t2 = t1 + p.slab;
  const uint32_t bars = smem_u32(smem + lay.bars);

  const int rank = (int)cluster_rank();
  const int slab = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;
  const int start = rank * p.pix;
  const int npix = max(min(start + p.pix, hw) - start, 0);
  const int mine = (npix + p.box_pix - 1) / p.box_pix;
  const int cg = 1 << cg_log2;

  if (tid == 0) {
    for (int i = 0; i < p.nbox; ++i) mbar_init(bars + 8 * i, 1);
    mbar_init_fence();
    const uint32_t bytes = p.box_pix * p.slab * (sizeof(TX) + sizeof(TY));
    for (int i = 0; i < mine; ++i) {
      const uint32_t bar = bars + 8 * i;
      mbar_arrive_expect_tx(bar, bytes);
      tma_load_3d(smem_u32(smem + lay.x + i * lay.box_x), &tm_x,
                  slab * p.slab, start + i * p.box_pix, b, bar);
      tma_load_3d(smem_u32(smem + lay.dy + i * lay.box_dy), &tm_dy,
                  slab * p.slab, start + i * p.box_pix, b, bar);
    }
  }
  __syncthreads();  // the barriers initialised

  // 1. per-channel (sum dy xhat, sum dy) over the block's pixels
  const int cols = p.slab / V, rows = THREADS / cols;
  const int col = tid % cols, row = tid / cols;
  const int c0 = slab * p.slab + col * V;
  float mu[V], r[V], a[V], s[V], mul[V], add[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int bg = b * groups + ((c0 + j) >> cg_log2);
    mu[j] = mean[bg];
    r[j] = rstd[bg];
    a[j] = 0.f;
    s[j] = 0.f;
    if constexpr (RELU) {
      mul[j] = norm_mul(r[j], gamma[c0 + j]);
      add[j] = beta[c0 + j];
    }
  }
  auto x_at = [&](int q) {
    const int box = q / p.box_pix;
    return reinterpret_cast<const TX*>(smem + lay.x + box * lay.box_x) +
           (q - box * p.box_pix) * p.slab + col * V;
  };
  auto dy_at = [&](int q) {
    const int box = q / p.box_pix;
    return reinterpret_cast<TY*>(smem + lay.dy + box * lay.box_dy) +
           (q - box * p.box_pix) * p.slab + col * V;
  };
  int waited = -1;
  for (int q = row; q < npix; q += rows) {
    const int box = q / p.box_pix;
    if (box != waited) {
      mbar_wait(bars + 8 * box, 0);
      waited = box;
    }
    Packed<TX, V> xv;
    Packed<TY, V> dv;
    xv.load_shared(x_at(q));
    dv.load_shared(dy_at(q));
    if constexpr (RELU) {
      bool zeroed = false;
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (!relu_passes<TY>(xv.get(j), mu[j], mul[j], add[j])) {
          dv.set(j, 0.f);
          zeroed = true;
        }
      if (zeroed) dv.store(dy_at(q));  // this thread's dx pass reads it
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = dv.get(j);
      a[j] += d * ((xv.get(j) - mu[j]) * r[j]);
      s[j] += d;
    }
  }
  // the rows of a warp by a shuffle tree (cols < 32), then row groups in
  // order: a warp each, or a row each where a row spans whole warps
  if (cols < 32) {
#pragma unroll
    for (int j = 0; j < V; ++j)
      for (int off = cols; off < 32; off *= 2) {
        a[j] += __shfl_xor_sync(0xffffffffu, a[j], off);
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      }
  }
  const int part = cols < 32 ? warp : row, parts = cols < 32 ? WARPS : rows;
  if (cols >= 32 || (tid % 32) < cols)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red_a[part * p.slab + col * V + j] = a[j];
      red_b[part * p.slab + col * V + j] = s[j];
    }
  __syncthreads();
  if (tid < p.slab) {
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < parts; ++k) {
      sa += red_a[k * p.slab + tid];
      sb += red_b[k * p.slab + tid];
    }
    blk[tid] = make_float2(sa, sb);
  }
  cluster_sync();  // 2. every block's partials visible

  if (tid < p.slab) {
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < p.cluster; ++k) {
      const float2 v = cluster_peer(blk, k)[tid];
      sa += v.x;
      sb += v.y;
    }
    const int c = slab * p.slab + tid;
    if (rank == 0) sums[(int64_t)b * channels + c] = make_float2(sa, sb);
    t1[tid] = gamma[c] * sb;
    t2[tid] = gamma[c] * sa;
  }
  cluster_arrive();  // done reading the other blocks
  __syncthreads();
  for (int h = cg / 2; h > 0; h >>= 1) {
    if (tid < p.slab && (tid & (cg - 1)) < h) {
      t1[tid] += t1[tid + h];
      t2[tid] += t2[tid + h];
    }
    __syncthreads();
  }

  // 3. dx from the tiles in shared memory
  const float n = (float)cg * (float)hw;
  float g[V], c1[V], c2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int lc = col * V + j, first = lc & ~(cg - 1);
    g[j] = gamma[c0 + j];
    c1[j] = t1[first] / n;
    c2[j] = t2[first] / n;
  }
  TX* out = dx + ((int64_t)b * hw + start) * channels + c0;
  for (int q = row; q < npix; q += rows) {
    Packed<TX, V> xv, o{};
    Packed<TY, V> dv;
    xv.load_shared(x_at(q));
    dv.load_shared(dy_at(q));
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xhat = (xv.get(j) - mu[j]) * r[j];
      o.set(j, r[j] * (g[j] * dv.get(j) - c1[j] - xhat * c2[j]));
    }
    o.store(out + (int64_t)q * channels);
  }
  cluster_wait();  // the other blocks are done reading this one
}

// dgamma and dbeta from sums[b, c], C / 32 blocks.
__global__ void __launch_bounds__(THREADS)
    bwd_dgamma_kernel(const float2* __restrict__ sums,
                      float* __restrict__ dgamma, float* __restrict__ dbeta,
                      int batch, int channels) {
  dgamma_block(sums, dgamma, dbeta, batch, channels, blockIdx.x);
}

// Returns false for a plan the cluster kernels do not take (sy 0: the
// forward, which holds x alone).
bool valid_plan(const ClusterPlan& p, int channels, int hw, int groups,
                int sx, int sy) {
  const int cg = channels / groups;
  return power_of_two(p.slab) && p.slab <= MAX_SLAB && channels % p.slab == 0 &&
         cg <= p.slab && (p.slab * sx) % 16 == 0 && (p.slab * sy) % 16 == 0 &&
         p.cluster >= 1 && p.cluster <= MAX_CLUSTER &&
         (int64_t)p.pix * p.cluster >= hw && p.pix > 0 && p.box_pix > 0 &&
         p.box_pix <= MAX_BOX && p.nbox * p.box_pix >= p.pix &&
         Layout(p, sx, sy).bytes <= SMEM_LIMIT;
}

// A direction's cluster kernel for (TX, TY) (the forward's TY is y's type,
// the backward's dy's) and epilogue EPI (the backward's relu for EPI_RELU):
// its launch configuration and occupancy, and its attributes (the
// shared-memory limit and clusters of 16), set once a device for each
// kernel.
template <bool FWD, typename TX, typename TY, int EPI>
struct Cluster {
  static const void* kernel() {
    return FWD ? reinterpret_cast<const void*>(fwd_cluster_kernel<TX, TY, EPI>)
               : reinterpret_cast<const void*>(
                     bwd_cluster_kernel<TX, TY, EPI != EPI_NONE>);
  }

  static cudaError_t allow() {
    static std::atomic<uint64_t> done{0};
    return allow_cluster_once(done, kernel(), SMEM_LIMIT);
  }

  static cudaLaunchConfig_t config(const ClusterPlan& p, int batch,
                                   int channels, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(p.cluster, channels / p.slab, batch);
    config.blockDim = dim3(THREADS);
    config.dynamicSmemBytes =
        Layout(p, sizeof(TX), FWD ? 0 : sizeof(TY)).bytes;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = p.cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    return config;
  }

  static int occupancy(int batch, int channels, const ClusterPlan& p) {
    if (allow() != cudaSuccess) return -1;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(p, batch, channels, &attr);
    int clusters = -1;
    if (cudaOccupancyMaxActiveClusters(&clusters, kernel(), &cfg) !=
        cudaSuccess)
      return -1;
    return clusters;
  }
};

// The 3-D tensor map [C, HW, B] of one channels-last tensor of T, boxes of
// [box_pix, slab]; make_map_plain binds the device first.
template <typename T>
cudaError_t nhwc_map(CUtensorMap* map, const void* base, int batch, int hw,
                     int channels, const ClusterPlan& p) {
  const cuuint32_t box[3] = {(cuuint32_t)p.slab, (cuuint32_t)p.box_pix, 1};
  const cuuint64_t dims[3] = {(cuuint64_t)channels, (cuuint64_t)hw,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)channels * sizeof(T),
                                 (cuuint64_t)hw * channels * sizeof(T)};
  return make_map_plain(map, base, 3, sizeof(T) == 2, dims, strides, box);
}

template <typename TX, typename TY, int EPI>
int run_forward_cluster(const void* x, const float* gamma, const float* beta,
                        const void* residual, void* y, float* mean,
                        float* rstd, int batch, int hw, int channels,
                        int groups, float eps, const ClusterPlan& p,
                        cudaStream_t st) {
  using K = Cluster<true, TX, TY, EPI>;
  CUtensorMap tm_x;
  cudaError_t err = nhwc_map<TX>(&tm_x, x, batch, hw, channels, p);
  if (err == cudaSuccess) err = K::allow();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = K::config(p, batch, channels, &attr);
  config.stream = st;
  return cudaLaunchKernelEx(&config, fwd_cluster_kernel<TX, TY, EPI>, tm_x,
                            gamma, beta, static_cast<const TY*>(residual),
                            static_cast<TY*>(y), mean, rstd, hw, channels,
                            groups, eps, p, log2_of(channels / groups));
}

template <typename TX, typename TY, bool RELU>
int run_backward_cluster(const void* dy, const void* x, const float* mean,
                         const float* rstd, const float* gamma,
                         const float* beta, void* dx, float* dgamma,
                         float* dbeta, float2* sums, int batch, int hw,
                         int channels, int groups, const ClusterPlan& p,
                         cudaStream_t st) {
  using K = Cluster<false, TX, TY, RELU ? EPI_RELU : EPI_NONE>;
  CUtensorMap tm_x, tm_dy;
  cudaError_t err = nhwc_map<TX>(&tm_x, x, batch, hw, channels, p);
  if (err == cudaSuccess)
    err = nhwc_map<TY>(&tm_dy, dy, batch, hw, channels, p);
  if (err == cudaSuccess) err = K::allow();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config = K::config(p, batch, channels, &attr);
  config.stream = st;
  err = cudaLaunchKernelEx(&config, bwd_cluster_kernel<TX, TY, RELU>, tm_x,
                           tm_dy, mean, rstd, gamma, beta,
                           static_cast<TX*>(dx), sums, hw, channels, groups,
                           p, log2_of(channels / groups));
  if (err != cudaSuccess) return err;
  bwd_dgamma_kernel<<<(channels + DG_CHANNELS - 1) / DG_CHANNELS, THREADS, 0,
                      st>>>(sums, dgamma, dbeta, batch, channels);
  return cudaGetLastError();
}

bool dtype_ok(int code) { return code == 0 || code == 1; }

// A forward's epilogue code and residual agree: a residual exactly with
// EPI_RESIDUAL_RELU. The backward takes EPI_NONE or EPI_RELU (and beta with
// the latter).
bool forward_epilogue_ok(int epi, const void* residual) {
  return (epi == EPI_NONE || epi == EPI_RELU || epi == EPI_RESIDUAL_RELU) &&
         (residual != nullptr) == (epi == EPI_RESIDUAL_RELU);
}

bool backward_epilogue_ok(int epi, const void* beta) {
  return epi == EPI_NONE || (epi == EPI_RELU && beta != nullptr);
}

// f(std::integral_constant<int, E>{}) for epilogue code epi
template <typename F>
int by_epilogue(int epi, F&& f) {
  if (epi == EPI_RELU) return f(std::integral_constant<int, EPI_RELU>{});
  if (epi == EPI_RESIDUAL_RELU)
    return f(std::integral_constant<int, EPI_RESIDUAL_RELU>{});
  return f(std::integral_constant<int, EPI_NONE>{});
}

// f(TA{}, TB{}) with the element types of dtype codes a and b (0 = float32,
// 1 = bfloat16).
template <typename F>
int by_dtypes(int a, int b, F&& f) {
  if (a == 1 && b == 1) return f(__nv_bfloat16{}, __nv_bfloat16{});
  if (a == 1) return f(__nv_bfloat16{}, float{});
  if (b == 1) return f(float{}, __nv_bfloat16{});
  return f(float{}, float{});
}

}  // namespace

extern "C" {

// Tiles of a (b, slab) for x's dtype (0 = float32, 1 = bfloat16): the
// scratch sizes below depend on it. -1 for a shape the kernels refuse.
int group_norm_tiles(int channels, int hw, int groups, int x_dtype) {
  Tiling t;
  if (!dtype_ok(x_dtype) ||
      !make_tiling(channels, hw, groups, vec_of(x_dtype), &t))
    return -1;
  return t.tiles;
}

// The two-pass forward. x and y [b, h, w, C] (NHWC in memory), gamma/beta
// f32 [C]; mean and rstd f32 [b, groups]; part f32 scratch [b, groups,
// tiles, 2]. Dtypes: 0 = float32, 1 = bfloat16. epilogue: 0 none, 1 relu,
// 2 residual then relu, with residual [b, h, w, C] of y's dtype (null
// otherwise). Returns the launches' cudaGetLastError().
int group_norm_fwd(const void* x, const void* gamma, const void* beta,
                   const void* residual, void* y, void* mean, void* rstd,
                   void* part, int x_dtype, int y_dtype, int batch,
                   int channels, int hw, int groups, float eps, int epilogue,
                   void* stream) {
  Tiling t;
  if (batch <= 0 || !dtype_ok(x_dtype) || !dtype_ok(y_dtype) ||
      !forward_epilogue_ok(epilogue, residual) ||
      !make_tiling(channels, hw, groups, vec_of(x_dtype), &t))
    return cudaErrorInvalidValue;
  return by_dtypes(x_dtype, y_dtype, [&](auto tx, auto ty) {
    return by_epilogue(epilogue, [&](auto epi) {
      return run_forward<decltype(tx), decltype(ty), decltype(epi)::value>(
          x, static_cast<const float*>(gamma),
          static_cast<const float*>(beta), residual, y,
          static_cast<float*>(mean), static_cast<float*>(rstd),
          static_cast<float2*>(part), batch, hw, channels, groups, eps, t,
          static_cast<cudaStream_t>(stream));
    });
  });
}

// The cluster forward (see the header), for the plan of ops/group_norm.py
// forward_plan: slab, cluster, pix, box_pix and nbox. Arguments as
// group_norm_fwd's, with no scratch. A plan the kernel does not take
// returns cudaErrorInvalidValue.
int group_norm_fwd_cluster(const void* x, const void* gamma, const void* beta,
                           const void* residual, void* y, void* mean,
                           void* rstd, int x_dtype, int y_dtype, int batch,
                           int channels, int hw, int groups, float eps,
                           int epilogue, int slab, int cluster, int pix,
                           int box_pix, int nbox, void* stream) {
  Tiling t;
  const ClusterPlan p{slab, cluster, pix, box_pix, nbox};
  if (batch <= 0 || !dtype_ok(x_dtype) || !dtype_ok(y_dtype) ||
      !forward_epilogue_ok(epilogue, residual) ||
      !make_tiling(channels, hw, groups, vec_of(x_dtype), &t) ||
      !valid_plan(p, channels, hw, groups, x_dtype ? 2 : 4, 0))
    return cudaErrorInvalidValue;
  return by_dtypes(x_dtype, y_dtype, [&](auto tx, auto ty) {
    return by_epilogue(epilogue, [&](auto epi) {
      return run_forward_cluster<decltype(tx), decltype(ty),
                                 decltype(epi)::value>(
          x, static_cast<const float*>(gamma),
          static_cast<const float*>(beta), residual, y,
          static_cast<float*>(mean), static_cast<float*>(rstd), batch, hw,
          channels, groups, eps, p, static_cast<cudaStream_t>(stream));
    });
  });
}

// dy [b, h, w, C] in dy_dtype, x and dx in x_dtype (NHWC in memory); mean,
// rstd f32 [b, groups]; gamma, dgamma, dbeta f32 [C]; scratch part f32
// [b, tiles, C, 2], sums f32 [b, C, 2] and coef f32 [b, groups, 2].
// epilogue 1 (relu) masks dy by the forward's relu, recomputed from x,
// gamma and beta f32 [C] (null with epilogue 0); dy's dtype is then y's.
// Returns the launches' cudaGetLastError().
int group_norm_bwd(const void* dy, const void* x, const void* mean,
                   const void* rstd, const void* gamma, const void* beta,
                   void* dx, void* dgamma, void* dbeta, void* part,
                   void* sums, void* coef, int x_dtype, int dy_dtype,
                   int batch, int channels, int hw, int groups, int epilogue,
                   void* stream) {
  Tiling t;
  if (batch <= 0 || !dtype_ok(x_dtype) || !dtype_ok(dy_dtype) ||
      !backward_epilogue_ok(epilogue, beta) ||
      !make_tiling(channels, hw, groups, vec_of(x_dtype), &t))
    return cudaErrorInvalidValue;
  return by_dtypes(x_dtype, dy_dtype, [&](auto tx, auto ty) {
    return by_epilogue(epilogue, [&](auto epi) {
      return run_backward<decltype(tx), decltype(ty),
                          decltype(epi)::value == EPI_RELU>(
          dy, x, static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), dx, static_cast<float*>(dgamma),
          static_cast<float*>(dbeta), static_cast<float2*>(part),
          static_cast<float2*>(sums), static_cast<float2*>(coef), batch, hw,
          channels, groups, t, static_cast<cudaStream_t>(stream));
    });
  });
}

// The cluster backward (see the header), for the plan of
// ops/group_norm.py backward_plan: slab, cluster, pix, box_pix and nbox.
// Arguments as group_norm_bwd's; sums f32 [b, C, 2] is scratch (no part or
// coef). A plan the kernel does not take returns cudaErrorInvalidValue.
int group_norm_bwd_cluster(const void* dy, const void* x, const void* mean,
                           const void* rstd, const void* gamma,
                           const void* beta, void* dx, void* dgamma,
                           void* dbeta, void* sums, int x_dtype, int dy_dtype,
                           int batch, int channels, int hw, int groups,
                           int epilogue, int slab, int cluster, int pix,
                           int box_pix, int nbox, void* stream) {
  Tiling t;
  const ClusterPlan p{slab, cluster, pix, box_pix, nbox};
  if (batch <= 0 || !dtype_ok(x_dtype) || !dtype_ok(dy_dtype) ||
      !backward_epilogue_ok(epilogue, beta) ||
      !make_tiling(channels, hw, groups, vec_of(x_dtype), &t) ||
      !valid_plan(p, channels, hw, groups, x_dtype ? 2 : 4, dy_dtype ? 2 : 4))
    return cudaErrorInvalidValue;
  return by_dtypes(x_dtype, dy_dtype, [&](auto tx, auto ty) {
    return by_epilogue(epilogue, [&](auto epi) {
      return run_backward_cluster<decltype(tx), decltype(ty),
                                  decltype(epi)::value == EPI_RELU>(
          dy, x, static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), dx, static_cast<float*>(dgamma),
          static_cast<float*>(dbeta), static_cast<float2*>(sums), batch, hw,
          channels, groups, p, static_cast<cudaStream_t>(stream));
    });
  });
}

// Clusters of a cluster kernel resident at once on the current device for
// this plan (cudaOccupancyMaxActiveClusters); -1 where it cannot run. The
// forward's second dtype is y's, the backward's dy's. Every epilogue's
// kernel has the same launch bounds and shared memory, so the plain one
// stands for them.
int group_norm_fwd_cluster_occupancy(int x_dtype, int y_dtype, int batch,
                                     int channels, int hw, int groups,
                                     int slab, int cluster, int pix,
                                     int box_pix, int nbox) {
  const ClusterPlan p{slab, cluster, pix, box_pix, nbox};
  if (!dtype_ok(x_dtype) || !dtype_ok(y_dtype) ||
      !valid_plan(p, channels, hw, groups, x_dtype ? 2 : 4, 0))
    return -1;
  return by_dtypes(x_dtype, y_dtype, [&](auto tx, auto ty) {
    return Cluster<true, decltype(tx), decltype(ty), EPI_NONE>::occupancy(
        batch, channels, p);
  });
}

int group_norm_bwd_cluster_occupancy(int x_dtype, int dy_dtype, int batch,
                                     int channels, int hw, int groups,
                                     int slab, int cluster, int pix,
                                     int box_pix, int nbox) {
  const ClusterPlan p{slab, cluster, pix, box_pix, nbox};
  if (!dtype_ok(x_dtype) || !dtype_ok(dy_dtype) ||
      !valid_plan(p, channels, hw, groups, x_dtype ? 2 : 4, dy_dtype ? 2 : 4))
    return -1;
  return by_dtypes(x_dtype, dy_dtype, [&](auto tx, auto ty) {
    return Cluster<false, decltype(tx), decltype(ty), EPI_NONE>::occupancy(
        batch, channels, p);
  });
}

const char* group_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
