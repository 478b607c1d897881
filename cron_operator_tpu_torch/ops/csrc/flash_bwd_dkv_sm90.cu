// Flash-attention dK/dV backward for Hopper (sm_90a) on bf16 tensor cores,
// plain C interface for ctypes.
//
// Replaces K3 of the JAX package: cron_operator_tpu/ops/flash_attention.py
// `_bwd_dkv_kernel`, launched by `_flash_bwd` through `pl.pallas_call`
// (grid (bh, ki, qi)), for bf16 inputs at head dims 64 and 128
// (`flash_bwd.cu` keeps f32 and d 32/256, and K2). Same function: with
// P = exp(S * scale - LSE) recomputed from the forward's logsumexp, the
// causal NEG_INF mask and Delta = rowsum(dO * O) from the caller,
//   dV = sum_q P^T dO,   dK = sum_q (P * (dO V^T - Delta))^T Q * scale,
// summed over the query heads of each KV head's group. As in the TPU kernel,
// P and dS are rounded to bf16 before the products that take them.
//
// Bound: at the training shape (b 8, s 1024, h 12, d 64, causal; 50,380,800
// kept (query, key) pairs) the function reads Q, K, V, dO, LSE and Delta
// and writes dK and dV, 76.28 MB (22.8 us at 3.35 TB/s), and does K Q^T,
// V dO^T, P^T dO and dS^T Q, 8 d FLOP a pair, 25.8 GFLOP (26.1 us at 989
// TFLOP/s): bound by operations. So the products run on the tensor cores
// with both inputs in bf16 and the accumulators in registers, and the loads
// run ahead of them.
//
// Design. A block owns a key tile of 64 rows of one (batch, KV head): one
// consumer warpgroup and one producer warp. K and V are loaded once by TMA
// and stay in shared memory. The producer's first lane then streams, for
// each of the `group` query heads that share the KV head and each query
// tile of BQ rows at or below the diagonal, the Q and dO tiles (TMA, 128-byte
// swizzle, 4-D tensor maps over the inputs' strides) into a ring of STAGES
// buffers guarded by mbarriers, while the warp's 32 lanes copy the tile's
// LSE and Delta into the same stage (plain loads and stores, each lane then
// arriving on the stage's barrier, which releases its stores).
// The warpgroup computes S^T = K Q^T and dP^T = V dO^T as wgmma m64nBQk16
// from shared memory, forms P^T = exp2(S^T scale log2e - LSE log2e) and
// dS^T = P^T (dP^T - Delta) in registers on the accumulator layout, and
// accumulates dV += P^T dO and dK += dS^T Q as wgmma with P^T and dS^T as
// bf16 register A operands and dO and Q read N-major from their natural
// [q, d] layout. dK is scaled once at the end. dK and dV of the whole group
// are written once, with no atomics, so a rerun is bit-identical. Key tile 0,
// the heaviest under causal, is launched first. BQ is 64 at d 64 and 32 at
// d 128, where the two d-wide accumulators take 128 registers a thread.
//
// Any sequence length s >= 1. The grid and the query loop round the tile
// counts up, so the last key tile and the last query tile may be partial.
// TMA reads rows past s as zeros (the tensor maps end at s). LSE and Delta
// are f32 [b * h, s], row r of (batch, head) bh at bh * s + r; the lanes
// read a tile's values only for r < s (0 past it), so no read reaches
// another head's rows or past the buffer, and a tile at any offset needs no
// 16-byte alignment. P^T and dS^T are set to 0 by the index, whatever the
// scores, for a query past s (the last query tile) and a key past s (the
// last key tile), so a query row past s adds nothing to dK and dV. No dK or
// dV row past s is stored. As in K1 (`flash_fwd_sm90.cu`), this lives in a
// second instantiation (RAGGED), launched when s is not a multiple of 64,
// so that a multiple of 64 runs the kernel without it. The lanes load a
// tile's LSE and Delta into registers before they wait for its stage to
// drain.
//
// The tensor maps come from cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint (sm90.cuh), so the library needs no -lcuda.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BK = 64;     // keys per block
constexpr int STAGES = 2;  // Q/dO ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int BQ = D == 128 ? 32 : 64;      // queries per tile
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr int KV_TILE = PANELS * BK * 128;  // K or V, bytes
  static constexpr int Q_PANEL = BQ * 128;           // one panel of Q or dO
  static constexpr int Q_TILE = PANELS * Q_PANEL;
  static constexpr int K = 0;
  static constexpr int V = KV_TILE;
  static constexpr int STAGE0 = 2 * KV_TILE;
  // a stage: Q, dO, LSE, Delta, padded to the swizzle's 1024-byte period
  static constexpr int S_Q = 0, S_DO = Q_TILE, S_LSE = 2 * Q_TILE,
                       S_DELTA = 2 * Q_TILE + 4 * BQ;
  static constexpr int STAGE = (2 * Q_TILE + 8 * BQ + 1023) / 1024 * 1024;
  static constexpr int STAGE_TX = 2 * Q_TILE;  // bytes TMA loads a stage
  static constexpr int BARS = STAGE0 + STAGES * STAGE;  // kv, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + align
  static constexpr int THREADS = 128 + 32;
};

template <int D, bool RAGGED>
__global__ void __launch_bounds__(Layout<D>::THREADS, D == 64 ? 2 : 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int seq,
                              int heads, int kv_heads, int64_t sdk_b,
                              int64_t sdk_s, int64_t sdk_h, int64_t sdv_b,
                              int64_t sdv_s, int64_t sdv_h, int causal,
                              float scale, float scale_log2) {
  using L = Layout<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_bar = base + L::BARS;
  const uint32_t full_bar = kv_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int k_tile = blockIdx.y;  // tile 0, the heaviest under causal, first
  const int bi = blockIdx.x / kv_heads;
  const int kvh = blockIdx.x % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = k_tile * BK;
  const int first_qt = causal ? k0 / BQ : 0;
  const int n_qt = (seq + BQ - 1) / BQ;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar + 8 * st, 32);  // one arrival per producer lane
      mbar_init(empty_bar + 8 * st, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {  // producer warp: lane 0 issues the TMA loads
    const int lane = tid - 128;
    if (lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_do);
      mbar_arrive_expect_tx(kv_bar, 2 * L::KV_TILE);
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load_4d(base + L::K + p * BK * 128, &tm_k, p * PANEL_COLS, k0,
                    kvh, bi, kv_bar);
        tma_load_4d(base + L::V + p * BK * 128, &tm_v, p * PANEL_COLS, k0,
                    kvh, bi, kv_bar);
      }
    }
    int st = 0;
    uint32_t phase = 0;
    for (int g = 0; g < group; ++g) {
      const int hi = kvh * group + g;
      const int64_t row_base = (int64_t)(bi * heads + hi) * seq;
      for (int qt = first_qt; qt < n_qt; ++qt) {
        // this tile's LSE and Delta into registers while the stage drains,
        // so that their latency hides behind the wait
        float lse_v[BQ / 32], delta_v[BQ / 32];
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          const int row = qt * BQ + lane + 32 * i;
          const bool in = !RAGGED || row < seq;
          lse_v[i] = in ? lse[row_base + row] : 0.f;
          delta_v[i] = in ? delta[row_base + row] : 0.f;
        }
        mbar_wait(empty_bar + 8 * st, phase ^ 1);
        const uint32_t full = full_bar + 8 * st;
        const uint32_t stage = base + L::STAGE0 + st * L::STAGE;
        if (lane == 0) {
          mbar_expect_tx(full, L::STAGE_TX);
          for (int p = 0; p < L::PANELS; ++p) {
            tma_load_4d(stage + L::S_Q + p * L::Q_PANEL, &tm_q,
                        p * PANEL_COLS, qt * BQ, hi, bi, full);
            tma_load_4d(stage + L::S_DO + p * L::Q_PANEL, &tm_do,
                        p * PANEL_COLS, qt * BQ, hi, bi, full);
          }
        }
        float* lse_s = reinterpret_cast<float*>(base_ptr + L::STAGE0 +
                                                st * L::STAGE + L::S_LSE);
        float* delta_s = reinterpret_cast<float*>(base_ptr + L::STAGE0 +
                                                  st * L::STAGE + L::S_DELTA);
#pragma unroll
        for (int i = 0; i < BQ / 32; ++i) {
          lse_s[lane + 32 * i] = lse_v[i];
          delta_s[lane + 32 * i] = delta_v[i];
        }
        mbar_arrive(full);  // releases this lane's stores to the consumers
        if (++st == STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4;  // this thread's keys: r_lo, r_lo + 8
  const int c2 = 2 * (lane % 4);          // its queries: 8j + c2, 8j + c2 + 1
  const uint32_t k_s = base + L::K;
  const uint32_t v_s = base + L::V;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kv_bar, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int g = 0; g < group; ++g) {
    for (int qt = first_qt; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      mbar_wait(full_bar + 8 * st, phase);
      const uint32_t stage = base + L::STAGE0 + st * L::STAGE;
      const float* lse_s =
          reinterpret_cast<const float*>(base_ptr + L::STAGE0 +
                                         st * L::STAGE + L::S_LSE);
      const float* delta_s =
          reinterpret_cast<const float*>(base_ptr + L::STAGE0 +
                                         st * L::STAGE + L::S_DELTA);

      float s[BQ / 2], dp[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t dq = desc_k_major(
            stage + L::S_Q + (kk / 4) * L::Q_PANEL, kk % 4);
        const uint64_t ddo = desc_k_major(
            stage + L::S_DO + (kk / 4) * L::Q_PANEL, kk % 4);
        const uint64_t dkk = desc_k_major(k_s + (kk / 4) * BK * 128, kk % 4);
        const uint64_t dvv = desc_k_major(v_s + (kk / 4) * BK * 128, kk % 4);
        if constexpr (BQ == 64) {
          wgmma_ss_n64(s, dkk, dq, kk > 0);
          wgmma_ss_n64(dp, dvv, ddo, kk > 0);
        } else {
          wgmma_ss_n32(s, dkk, dq, kk > 0);
          wgmma_ss_n32(dp, dvv, ddo, kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // P^T and dS^T; a key above its query (diagonal tiles only) gives
      // 0, as the NEG_INF score does in the TPU kernel.
      const bool diagonal = causal && q0 < k0 + BK;
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int r = k0 + r_lo + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + c2 + (i & 1);
        const float p =
            (diagonal && r > q0 + c)
                ? 0.f
                : fast_exp2(fmaf(s[i], scale_log2, -lse_s[c] * LOG2E));
        s[i] = p;
        dp[i] = p * (dp[i] - delta_s[c]);
      }
      if constexpr (RAGGED) {
        if (q0 + BQ > seq || k0 + BK > seq) {  // a query or a key past s
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i)
            if (q0 + 8 * (i >> 2) + c2 + (i & 1) >= seq ||
                k0 + r_lo + 8 * ((i >> 1) & 1) >= seq)
              s[i] = dp[i] = 0.f;  // set, not multiplied: P may be inf
        }
      }
      uint32_t pa[BQ / 4], da[BQ / 4];
      acc_to_a(s, pa);
      acc_to_a(dp, da);
      wgmma_fence();
#pragma unroll
      for (int pn = 0; pn < L::PANELS; ++pn)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          wgmma_rs_n64_tb(dv_acc + 32 * pn, pa + 4 * kk,
                          desc_n_major(stage + L::S_DO + pn * L::Q_PANEL, kk),
                          1);
          wgmma_rs_n64_tb(dk_acc + 32 * pn, da + 4 * kk,
                          desc_n_major(stage + L::S_Q + pn * L::Q_PANEL, kk),
                          1);
        }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv_acc);
      reg_fence(dk_acc);
      reg_fence(pa);
      reg_fence(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * st);
      if (++st == STAGES) {
        st = 0;
        phase ^= 1;
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = k0 + r_lo + 8 * h;
    if (RAGGED && row >= seq) continue;
    __nv_bfloat16* dk_row = dk + bi * sdk_b + row * sdk_s + kvh * sdk_h;
    __nv_bfloat16* dv_row = dv + bi * sdv_b + row * sdv_s + kvh * sdv_h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk_row + 8 * j + c2) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * h] * scale,
                                dk_acc[4 * j + 2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_row + 8 * j + c2) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * h],
                                dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dk, *dv;
  int batch, seq, heads, kv_heads;
  int64_t sq[3], sk[3], sv[3], sdo[3], sdk[3], sdv[3];  // b, s, h strides
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int D, bool RAGGED>
cudaError_t launch(const Args& a) {
  using L = Layout<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = make_map_bshd(&tm_q, a.q, a.batch, a.seq, a.heads, D,
                                  a.sq[0], a.sq[1], a.sq[2], L::BQ);
  if (err == cudaSuccess)
    err = make_map_bshd(&tm_do, a.dout, a.batch, a.seq, a.heads, D, a.sdo[0],
                        a.sdo[1], a.sdo[2], L::BQ);
  if (err == cudaSuccess)
    err = make_map_bshd(&tm_k, a.k, a.batch, a.seq, a.kv_heads, D, a.sk[0],
                        a.sk[1], a.sk[2], BK);
  if (err == cudaSuccess)
    err = make_map_bshd(&tm_v, a.v, a.batch, a.seq, a.kv_heads, D, a.sv[0],
                        a.sv[1], a.sv[2], BK);
  if (err != cudaSuccess) return err;
  static std::atomic<uint64_t> smem_set{0};
  err = allow_smem_once(
      smem_set,
      reinterpret_cast<const void*>(flash_bwd_dkv_sm90_kernel<D, RAGGED>),
      L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.kv_heads, (a.seq + BK - 1) / BK);
  flash_bwd_dkv_sm90_kernel<D, RAGGED><<<grid, L::THREADS, L::BYTES,
                                         a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.seq, a.heads, a.kv_heads, a.sdk[0], a.sdk[1], a.sdk[2], a.sdv[0],
      a.sdv[1], a.sdv[2], a.causal, a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only; head_dim 64 or 128; any seq >= 1. Strides are in elements
// (every head_dim stride is 1); q, k, v and dO need a 16-byte aligned base
// and strides that are multiples of 8 elements, lse and delta are
// contiguous f32 [batch * heads, seq]; the caller checks all of it.
// Anything else returns cudaErrorInvalidValue. Returns the launch's
// cudaGetLastError().
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, int seq, int heads,
                       int kv_heads, int head_dim, int64_t sq_b, int64_t sq_s,
                       int64_t sq_h, int64_t sk_b, int64_t sk_s, int64_t sk_h,
                       int64_t sv_b, int64_t sv_s, int64_t sv_h,
                       int64_t sdo_b, int64_t sdo_s, int64_t sdo_h,
                       int64_t sdk_b, int64_t sdk_s, int64_t sdk_h,
                       int64_t sdv_b, int64_t sdv_s, int64_t sdv_h,
                       int causal, float scale, void* stream) {
  if (seq <= 0 || batch <= 0 || kv_heads <= 0 || heads % kv_heads)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               dk, dv, batch, seq, heads, kv_heads,
               {sq_b, sq_s, sq_h}, {sk_b, sk_s, sk_h}, {sv_b, sv_s, sv_h},
               {sdo_b, sdo_s, sdo_h}, {sdk_b, sdk_s, sdk_h},
               {sdv_b, sdv_s, sdv_h}, causal, scale,
               static_cast<cudaStream_t>(stream)};
  const bool ragged = seq % BK != 0;
  if (head_dim == 64) return ragged ? launch<64, true>(a) : launch<64, false>(a);
  if (head_dim == 128)
    return ragged ? launch<128, true>(a) : launch<128, false>(a);
  return cudaErrorInvalidValue;
}

const char* flash_bwd_dkv_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
