// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces K2 and K3 of the JAX package, cron_operator_tpu/ops/
// flash_attention.py: `_bwd_dq_kernel` (K2, launched by `_flash_bwd` through
// `pl.pallas_call`, grid (bh, qi, ki)) and `_bwd_dkv_kernel` (K3, grid
// (bh, ki, qi)). Same functions: with P = exp(S * scale - LSE) recomputed
// from the forward's per-row logsumexp, the causal NEG_INF mask, and
// Delta = rowsum(dO * O) precomputed by the caller,
//   K2: dQ = sum_k P * (dO V^T - Delta) K * scale
//   K3: dV = sum_q P^T dO,  dK = sum_q (P * (dO V^T - Delta))^T Q * scale.
// Both accumulate in f32 and round once to the input type.
//
// Bound at the training slice's shape (b 8, s 1024, h 12, d 64, causal,
// bf16; 50,380,800 causal (query, key) pairs):
//   K2 reads Q, K, V, dO once and writes dQ (5 x 12.58 MB) plus the f32 LSE
//   and Delta (0.79 MB): 63.7 MB, 19.0 us at 3.35 TB/s. It does QK^T, dO V^T
//   and dS K, 6 d FLOP per pair: 19.3 GFLOP, 19.6 us at 989 TFLOP/s. Bound:
//   operations.
//   K3 reads Q, K, V, dO once and writes dK and dV (6 x 12.58 MB) plus LSE and
//   Delta: 76.3 MB, 22.8 us. It does QK^T, dO V^T, P^T dO and dS^T Q, 8 d FLOP
//   per pair: 25.8 GFLOP, 26.1 us. Bound: operations.
// The design keeps the traffic near those floors: the s x s matrices P and dS
// never leave the SM.
//   K2: one block owns a query tile of one (batch, head). Q, dO, LSE and Delta
//   for the tile stay resident; the block loops over the K/V tiles (stopping
//   at the diagonal when causal), recomputes S and P, forms dS in shared
//   memory and accumulates dQ in registers.
//   K3: one block owns a key tile of one (batch, KV head). K and V stay
//   resident; the block loops over the `group` query heads that share this
//   KV head and, for each, over the query tiles at and below the diagonal,
//   accumulating dK and dV in registers. The grouped result is written once:
//   there are no per-query-head partials to sum afterwards (the JAX package
//   emits those and sums them in XLA), and no atomics, so a run's grads are
//   bit-identical to the next run's.
// The TPU kernels' sequential innermost grid axis becomes the block's loop.
//
// This design does the products with f32 FMAs on tiles held as f32 in
// shared memory (no tensor cores), as `flash_fwd.cu` does. It serves f32 and
// head dims 32 and 256; bf16 at head dims 64 and 128 runs the Hopper designs
// `flash_bwd_dq_sm90.cu` (K2) and `flash_bwd_dkv_sm90.cu` (K3), bf16 wgmma
// tiles fed by TMA.
//
// Tiles: 64 rows for head dims 32 to 128 and 32 rows at d 256, where four
// padded f32 tiles of 64 rows would need 263 KB of shared memory, above the
// 227 KB a block may have. Thread t of 256 is (ty, tx) = (t / 16, t % 16): it
// owns rows RM*ty .. RM*ty+RM-1 of the block's own tile (RM = TILE / 16) and,
// in the score tile, the other side's columns tx + 16*j; in the output,
// columns tx + 16*c (c < D/16). Shared rows are padded by one float so that
// the 16 threads reading rows tx + 16*j at one column hit 16 distinct banks.
//
// Any sequence length s >= 1. The grids and the loops round the tile counts
// up, so the last query tile and the last key tile may be partial: rows past
// s load as zeros, and no dQ, dK or dV row past s is stored. LSE and Delta
// are f32 [b * h, s], row r of (batch, head) bh at bh * s + r, read only for
// r < s, so no read reaches another head's rows or past the buffer. P and dS
// are set to 0 by the index where the key lies past the query's last (above
// it under causal, or past s) or the query lies past s, whatever the scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

template <int D>
__host__ __device__ constexpr int tile_rows() {
  return D == 256 ? 32 : 64;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int TILE = tile_rows<D>();
  // Q, dO, K, V tiles and the dS tile
  return sizeof(float) * (4 * TILE * (D + 1) + TILE * (TILE + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int TILE = tile_rows<D>();
  // K, V, Q, dO tiles, the P^T and dS^T tiles, and LSE and Delta of a tile
  return sizeof(float) *
         (4 * TILE * (D + 1) + 2 * TILE * (TILE + 1) + 2 * TILE);
}

// Copies rows [r0, r0 + TILE) of one head of a [b, s, h, d] tensor into a
// padded f32 shared tile; rows at or past `seq` are zeros.
template <typename T, int D, int TILE>
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

// K2: dQ for one query tile of one (batch, head).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int seq, int heads, int kv_heads, Strides sq,
                        Strides sk, Strides sv, Strides sdo, Strides sdq,
                        int causal, float scale) {
  constexpr int TILE = tile_rows<D>();
  constexpr int LD = D + 1;     // padded shared row of Q, dO, K, V
  constexpr int LP = TILE + 1;  // padded shared row of dS
  constexpr int RM = TILE / 16;  // query rows per thread
  constexpr int CN = TILE / 16;  // key columns per thread
  constexpr int COLS = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + TILE * LD;
  float* k_s = do_s + TILE * LD;
  float* v_s = k_s + TILE * LD;
  float* ds_s = v_s + TILE * LD;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_tile = blockIdx.x;
  const int bh = blockIdx.y;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int kvh = hi / (heads / kv_heads);  // kv_index: grouped K/V in place
  const int q0 = q_tile * TILE;

  load_tile<T, D, TILE>(q_s, q + bi * sq.b + hi * sq.h, sq.s, q0, seq);
  load_tile<T, D, TILE>(do_s, dout + bi * sdo.b + hi * sdo.h, sdo.s, q0, seq);
  const T* k_base = k + bi * sk.b + kvh * sk.h;
  const T* v_base = v + bi * sv.b + kvh * sv.h;

  float lse_r[RM], delta_r[RM], acc[RM][COLS];
  int last_key[RM];  // the last key column each row keeps (-1: past s)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    const bool in = row < seq;
    lse_r[i] = in ? lse[(int64_t)bh * seq + row] : 0.f;
    delta_r[i] = in ? delta[(int64_t)bh * seq + row] : 0.f;
    last_key[i] = !in ? -1 : causal ? row : seq - 1;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = causal ? q_tile + 1 : (seq + TILE - 1) / TILE;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * TILE;
    __syncthreads();  // the last tile's K and dS reads are done
    load_tile<T, D, TILE>(k_s, k_base, sk.s, k0, seq);
    load_tile<T, D, TILE>(v_s, v_base, sv.s, k0, seq);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D; ++kk) {
      float qv[RM], dov[RM], kv[CN], vv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qv[i] = q_s[(ty * RM + i) * LD + kk];
        dov[i] = do_s[(ty * RM + i) * LD + kk];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kv[j] = k_s[(tx + 16 * j) * LD + kk];
        vv[j] = v_s[(tx + 16 * j) * LD + kk];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

    // a tile that may hold a key past a row's last: the diagonal, the last
    // key tile, every tile of a partial query tile
    const bool edge = (causal && kt == q_tile) || k0 + TILE > seq ||
                      q0 + TILE > seq;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty * RM + i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int col = tx + 16 * j;
        // A masked score is NEG_INF in the JAX kernel: exp() gives exactly 0.
        ds_s[row * LP + col] =
            (edge && k0 + col > last_key[i])
                ? 0.f
                : expf(s[i][j] * scale - lse_r[i]) * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();  // dS of the whole tile is in shared memory

#pragma unroll 4
    for (int n = 0; n < TILE; ++n) {
      float dsv[RM], kc[COLS];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsv[i] = ds_s[(ty * RM + i) * LP + n];
#pragma unroll
      for (int c = 0; c < COLS; ++c) kc[c] = k_s[n * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(dsv[i], kc[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (q0 + ty * RM + i >= seq) continue;
    T* dq_row = dq + bi * sdq.b + (int64_t)(q0 + ty * RM + i) * sdq.s +
                hi * sdq.h;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      dq_row[tx + 16 * c] = from_float<T>(acc[i][c] * scale);
  }
}

// K3: dK and dV for one key tile of one (batch, KV head), summed over the
// query heads of its group.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int seq, int heads, int kv_heads,
                         Strides sq, Strides sk, Strides sv, Strides sdo,
                         Strides sdk, Strides sdv, int causal, float scale) {
  constexpr int TILE = tile_rows<D>();
  constexpr int LD = D + 1;      // padded shared row of K, V, Q, dO
  constexpr int LP = TILE + 1;   // padded shared row of P^T and dS^T
  constexpr int RM = TILE / 16;  // key rows per thread
  constexpr int CN = TILE / 16;  // query columns per thread
  constexpr int COLS = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + TILE * LD;
  float* q_s = v_s + TILE * LD;
  float* do_s = q_s + TILE * LD;
  float* pt_s = do_s + TILE * LD;
  float* dst_s = pt_s + TILE * LP;
  float* lse_s = dst_s + TILE * LP;
  float* delta_s = lse_s + TILE;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k_tile = blockIdx.x;
  const int bi = blockIdx.y / kv_heads;
  const int kvh = blockIdx.y % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = k_tile * TILE;

  load_tile<T, D, TILE>(k_s, k + bi * sk.b + kvh * sk.h, sk.s, k0, seq);
  load_tile<T, D, TILE>(v_s, v + bi * sv.b + kvh * sv.h, sv.s, k0, seq);

  float dk_acc[RM][COLS], dv_acc[RM][COLS];
  int first_q[RM];  // the first query each key row takes (s: none)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty * RM + i;
    first_q[i] = row >= seq ? seq : causal ? row : 0;
#pragma unroll
    for (int c = 0; c < COLS; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  const int n_tiles = (seq + TILE - 1) / TILE;
  const int first_q_tile = causal ? k_tile : 0;
  for (int g = 0; g < group; ++g) {
    const int hi = kvh * group + g;
    const int64_t row_base = (int64_t)(bi * heads + hi) * seq;
    const T* q_base = q + bi * sq.b + hi * sq.h;
    const T* do_base = dout + bi * sdo.b + hi * sdo.h;
    for (int qt = first_q_tile; qt < n_tiles; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();  // the last tile's Q, dO, P^T and dS^T reads are done
      load_tile<T, D, TILE>(q_s, q_base, sq.s, q0, seq);
      load_tile<T, D, TILE>(do_s, do_base, sdo.s, q0, seq);
      if (tid < TILE) {
        const bool in = q0 + tid < seq;
        lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[RM][CN], dp[RM][CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < D; ++kk) {
        float kv[RM], vv[RM], qv[CN], dov[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          kv[i] = k_s[(ty * RM + i) * LD + kk];
          vv[i] = v_s[(ty * RM + i) * LD + kk];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          qv[j] = q_s[(tx + 16 * j) * LD + kk];
          dov[j] = do_s[(tx + 16 * j) * LD + kk];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }

      // a tile that may hold a query before a key's first or past s: the
      // diagonal, the last query tile, every tile of a partial key tile
      const bool edge = (causal && qt == k_tile) || q0 + TILE > seq ||
                        k0 + TILE > seq;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int kr = ty * RM + i;
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const int qc = tx + 16 * j;
          const bool keep =
              !edge || (q0 + qc >= first_q[i] && q0 + qc < seq);
          const float p = keep ? expf(s[i][j] * scale - lse_s[qc]) : 0.f;
          pt_s[kr * LP + qc] = p;
          dst_s[kr * LP + qc] = keep ? p * (dp[i][j] - delta_s[qc]) : 0.f;
        }
      }
      __syncthreads();  // P^T and dS^T of the whole tile are in shared memory

#pragma unroll 4
      for (int n = 0; n < TILE; ++n) {
        float pv[RM], dsv[RM], doc[COLS], qr[COLS];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pv[i] = pt_s[(ty * RM + i) * LP + n];
          dsv[i] = dst_s[(ty * RM + i) * LP + n];
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          doc[c] = do_s[n * LD + tx + 16 * c];
          qr[c] = q_s[n * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            dv_acc[i][c] = fmaf(pv[i], doc[c], dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsv[i], qr[c], dk_acc[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = k0 + ty * RM + i;
    if (row >= seq) continue;
    T* dk_row = dk + bi * sdk.b + row * sdk.s + kvh * sdk.h;
    T* dv_row = dv + bi * sdv.b + row * sdv.s + kvh * sdv.h;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      dk_row[tx + 16 * c] = from_float<T>(dk_acc[i][c] * scale);
      dv_row[tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *out0, *out1;  // dQ for K2; dK and dV for K3
  int batch, seq, heads, kv_heads;
  Strides sq, sk, sv, sdo, s0, s1;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  // Above 48 KB a block's dynamic shared memory has to be allowed first.
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + tile_rows<D>() - 1) / tile_rows<D>(),
                  a.batch * a.heads);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), a.seq, a.heads, a.kv_heads, a.sq,
      a.sk, a.sv, a.sdo, a.s0, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.seq + tile_rows<D>() - 1) / tile_rows<D>(),
                  a.batch * a.kv_heads);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.seq,
      a.heads, a.kv_heads, a.sq, a.sk, a.sv, a.sdo, a.s0, a.s1, a.causal,
      a.scale);
  return cudaGetLastError();
}

template <typename T, bool DQ>
cudaError_t dispatch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 32:
      return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64:
      return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    case 256:
      return DQ ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int dispatch(int dtype, int head_dim, const Args& a) {
  if (a.seq <= 0 || a.batch <= 0 || a.kv_heads <= 0 ||
      a.heads % a.kv_heads)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_dim<float, DQ>(head_dim, a);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16, DQ>(head_dim, a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; every head_dim
// stride is 1. lse and delta are contiguous f32 [batch * heads, seq]. The
// caller checks shapes (seq >= 1, heads a multiple of kv_heads, a supported
// head_dim); anything else returns cudaErrorInvalidValue. Each
// returns its launch's cudaGetLastError().
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dq, int dtype,
                 int batch, int seq, int heads, int kv_heads, int head_dim,
                 int64_t sq_b, int64_t sq_s, int64_t sq_h, int64_t sk_b,
                 int64_t sk_s, int64_t sk_h, int64_t sv_b, int64_t sv_s,
                 int64_t sv_h, int64_t sdo_b, int64_t sdo_s, int64_t sdo_h,
                 int64_t sdq_b, int64_t sdq_s, int64_t sdq_h, int causal,
                 float scale, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, nullptr, batch, seq, heads, kv_heads,
               {sq_b, sq_s, sq_h}, {sk_b, sk_s, sk_h}, {sv_b, sv_s, sv_h},
               {sdo_b, sdo_s, sdo_h}, {sdq_b, sdq_s, sdq_h}, {0, 0, 0},
               causal, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, head_dim, a);
}

int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int dtype, int batch, int seq, int heads,
                  int kv_heads, int head_dim, int64_t sq_b, int64_t sq_s,
                  int64_t sq_h, int64_t sk_b, int64_t sk_s, int64_t sk_h,
                  int64_t sv_b, int64_t sv_s, int64_t sv_h, int64_t sdo_b,
                  int64_t sdo_s, int64_t sdo_h, int64_t sdk_b, int64_t sdk_s,
                  int64_t sdk_h, int64_t sdv_b, int64_t sdv_s, int64_t sdv_h,
                  int causal, float scale, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               dk, dv, batch, seq, heads, kv_heads,
               {sq_b, sq_s, sq_h}, {sk_b, sk_s, sk_h}, {sv_b, sv_s, sv_h},
               {sdo_b, sdo_s, sdo_h}, {sdk_b, sdk_s, sdk_h},
               {sdv_b, sdv_s, sdv_h}, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, head_dim, a);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
