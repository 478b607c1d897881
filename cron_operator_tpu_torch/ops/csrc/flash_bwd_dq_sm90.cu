// Flash-attention dQ backward for Hopper (sm_90a) on bf16 tensor cores,
// plain C interface for ctypes.
//
// Replaces K2 of the JAX package: cron_operator_tpu/ops/flash_attention.py
// `_bwd_dq_kernel`, launched by `_flash_bwd` through `pl.pallas_call` (grid
// (bh, qi, ki)), for bf16 inputs at head dims 64 and 128 (`flash_bwd.cu`
// keeps f32 and d 32/256). Same function: with P = exp(S * scale - LSE)
// recomputed from the forward's logsumexp, the causal NEG_INF mask and
// Delta = rowsum(dO * O) from the caller,
//   dQ = sum_k (P * (dO V^T - Delta)) K * scale,
// with K and V read at the KV head of each query head's group. As in the
// TPU kernel, dS is rounded to bf16 before the product that takes it.
//
// Bound: at the training shape (b 8, s 1024, h 12, d 64, causal; 50,380,800
// kept (query, key) pairs) the function reads Q, K, V, dO, LSE and Delta
// and writes dQ, 63.70 MB (19.0 us at 3.35 TB/s), and does Q K^T, dO V^T
// and dS K, 6 d FLOP a pair, 19.3 GFLOP (19.6 us at 989 TFLOP/s): bound by
// operations. So the products run on the tensor cores with both inputs in
// bf16 and the accumulators in registers, and the loads run ahead of them.
//
// Design. A block owns a query tile of 64 rows of one (batch, query head):
// one consumer warpgroup and one producer warp. Q and dO are loaded once by
// TMA and stay in shared memory; each consumer thread reads LSE and Delta of
// its two query rows once into registers. The producer's first lane then
// streams the K and V tiles of BK rows of the query head's KV head, up to
// the diagonal under causal (TMA, 128-byte swizzle, 4-D tensor maps over the
// inputs' strides), into a ring of STAGES buffers guarded by mbarriers. The
// warpgroup computes S = Q K^T and dP = dO V^T as wgmma m64nBKk16 from
// shared memory, forms P = exp2(S scale log2e - LSE log2e) and
// dS = P (dP - Delta) in registers on the accumulator layout, and
// accumulates dQ += dS K as wgmma with dS as the bf16 register A operand and
// K read N-major from its natural [key, d] layout. dQ is scaled once at the
// end and written once, with no atomics, so a rerun is bit-identical. The
// last query tile, the heaviest under causal, is launched first. BK is 64
// at both head dims: the dQ, S and dP accumulators and the dS fragment take
// 144 registers a thread at d 128.
//
// Any sequence length s >= 1. The grid and the key loop round the tile
// counts up, so the last query tile and the last key tile may be partial.
// TMA reads rows past s as zeros (the tensor maps end at s). LSE and Delta
// are f32 [b * h, s], row r of (batch, head) bh at bh * s + r; a row past s
// reads row s - 1's values, so no read reaches another head's rows or past
// the buffer. dS is set to 0 by the index, whatever the scores, for a key
// past s (the last key tile) and in a row past s (the last query tile), so
// a zero-filled key adds nothing and a row past s accumulates nothing. No
// dQ row past s is stored. As in K1 (`flash_fwd_sm90.cu`), this lives in a
// second instantiation (RAGGED), launched when s is not a multiple of 64,
// so that a multiple of 64 runs the kernel without it.
//
// The tensor maps come from cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint (sm90.cuh), so the library needs no -lcuda.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 64;     // queries per block: wgmma's M
constexpr int BK = 64;     // keys per K/V tile
constexpr int STAGES = 2;  // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr int Q_PANEL = BQ * 128;           // one panel of Q or dO
  static constexpr int Q_TILE = PANELS * Q_PANEL;    // Q or dO, bytes
  static constexpr int KV_PANEL = BK * 128;          // one panel of K or V
  static constexpr int KV_TILE = PANELS * KV_PANEL;  // K or V, bytes
  static constexpr int Q = 0;
  static constexpr int DO = Q_TILE;
  static constexpr int STAGE0 = 2 * Q_TILE;
  // a stage: K, then V (each a multiple of the swizzle's 1024-byte period)
  static constexpr int S_K = 0, S_V = KV_TILE;
  static constexpr int STAGE = 2 * KV_TILE;
  static constexpr int BARS = STAGE0 + STAGES * STAGE;  // q, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + align
  static constexpr int THREADS = 128 + 32;
};

template <int D, bool RAGGED>
__global__ void __launch_bounds__(Layout<D>::THREADS, 2)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int seq,
                             int heads, int kv_heads, int64_t sdq_b,
                             int64_t sdq_s, int64_t sdq_h, int causal,
                             float scale, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_bar = base + L::BARS;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  // the last tile, the heaviest under causal, first
  const int q_tile = gridDim.y - 1 - blockIdx.y;
  const int bi = blockIdx.x / heads;
  const int hi = blockIdx.x % heads;
  const int kvh = hi / (heads / kv_heads);  // kv_index: grouped K/V in place
  const int q0 = q_tile * BQ;
  const int n_kt = ((causal ? q0 + BQ : seq) + BK - 1) / BK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128) {  // producer warp: one lane issues every load
    if (tid == 128) {
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_arrive_expect_tx(q_bar, 2 * L::Q_TILE);
      for (int p = 0; p < L::PANELS; ++p) {
        tma_load_4d(base + L::Q + p * L::Q_PANEL, &tm_q, p * PANEL_COLS, q0,
                    hi, bi, q_bar);
        tma_load_4d(base + L::DO + p * L::Q_PANEL, &tm_do, p * PANEL_COLS, q0,
                    hi, bi, q_bar);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(empty_bar + 8 * st, phase ^ 1);
        const uint32_t full = full_bar + 8 * st;
        const uint32_t stage = base + L::STAGE0 + st * L::STAGE;
        mbar_arrive_expect_tx(full, L::STAGE);
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_4d(stage + L::S_K + p * L::KV_PANEL, &tm_k, p * PANEL_COLS,
                      kt * BK, kvh, bi, full);
          tma_load_4d(stage + L::S_V + p * L::KV_PANEL, &tm_v, p * PANEL_COLS,
                      kt * BK, kvh, bi, full);
        }
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
  const int r_lo = 16 * warp + lane / 4;  // this thread's queries: r_lo, r_lo + 8
  const int c2 = 2 * (lane % 4);          // its keys: 8j + c2, 8j + c2 + 1
  const uint32_t q_s = base + L::Q;
  const uint32_t do_s = base + L::DO;

  // LSE (times log2 e) and Delta of this thread's two rows, constant over
  // the key loop; a row past s reads row s - 1's (its dS is set to 0)
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r_lo + 8 * h;
    const int64_t at =
        (int64_t)blockIdx.x * seq + min(row, seq - 1);
    lse_r[h] = lse[at] * LOG2E;
    delta_r[h] = delta[at];
  }

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

  mbar_wait(q_bar, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    mbar_wait(full_bar + 8 * st, phase);
    const uint32_t stage = base + L::STAGE0 + st * L::STAGE;
    const uint32_t k_s = stage + L::S_K;
    const uint32_t v_s = stage + L::S_V;

    float s[BK / 2], dp[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t dqq = desc_k_major(q_s + (kk / 4) * L::Q_PANEL, kk % 4);
      const uint64_t ddo = desc_k_major(do_s + (kk / 4) * L::Q_PANEL, kk % 4);
      const uint64_t dkk = desc_k_major(k_s + (kk / 4) * L::KV_PANEL, kk % 4);
      const uint64_t dvv = desc_k_major(v_s + (kk / 4) * L::KV_PANEL, kk % 4);
      wgmma_ss_n64(s, dqq, dkk, kk > 0);
      wgmma_ss_n64(dp, ddo, dvv, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);

    // P and dS; a key above its query (diagonal tiles only) gives 0, as
    // the NEG_INF score does in the TPU kernel.
    const bool diagonal = causal && k0 + BK - 1 > q0;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      const int r = q0 + r_lo + 8 * h;
      const int c = k0 + 8 * (i >> 2) + c2 + (i & 1);
      const float p = (diagonal && c > r)
                          ? 0.f
                          : fast_exp2(fmaf(s[i], scale_log2, -lse_r[h]));
      dp[i] = p * (dp[i] - delta_r[h]);
    }
    if constexpr (RAGGED) {
      if (k0 + BK > seq || q0 + BQ > seq) {  // a key or a query past s
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (k0 + 8 * (i >> 2) + c2 + (i & 1) >= seq ||
              q0 + r_lo + 8 * ((i >> 1) & 1) >= seq)
            dp[i] = 0.f;  // set, not multiplied: such a P may be inf
      }
    }
    uint32_t da[BK / 4];
    acc_to_a(dp, da);
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < L::PANELS; ++pn)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n64_tb(dq_acc + 32 * pn, da + 4 * kk,
                        desc_n_major(k_s + pn * L::KV_PANEL, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(dq_acc);
    reg_fence(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * st);
    if (++st == STAGES) {
      st = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = q0 + r_lo + 8 * h;
    if (row >= seq) continue;
    __nv_bfloat16* dq_row = dq + bi * sdq_b + row * sdq_s + hi * sdq_h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dq_row + 8 * j + c2) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * h] * scale,
                                dq_acc[4 * j + 2 * h + 1] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void* dq;
  int batch, seq, heads, kv_heads;
  int64_t sq[3], sk[3], sv[3], sdo[3], sdq[3];  // b, s, h strides
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int D, bool RAGGED>
cudaError_t launch(const Args& a) {
  using L = Layout<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = make_map_bshd(&tm_q, a.q, a.batch, a.seq, a.heads, D,
                                  a.sq[0], a.sq[1], a.sq[2], BQ);
  if (err == cudaSuccess)
    err = make_map_bshd(&tm_do, a.dout, a.batch, a.seq, a.heads, D, a.sdo[0],
                        a.sdo[1], a.sdo[2], BQ);
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
      reinterpret_cast<const void*>(flash_bwd_dq_sm90_kernel<D, RAGGED>),
      L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.heads, (a.seq + BQ - 1) / BQ);
  flash_bwd_dq_sm90_kernel<D, RAGGED><<<grid, L::THREADS, L::BYTES,
                                        a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dq), a.seq, a.heads, a.kv_heads,
      a.sdq[0], a.sdq[1], a.sdq[2], a.causal, a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only; head_dim 64 or 128; any seq >= 1. Strides are in elements
// (every head_dim stride is 1); q, k, v and dO need a 16-byte aligned base
// and strides that are multiples of 8 elements, lse and delta are
// contiguous f32 [batch * heads, seq]; the caller checks all of it. dQ,
// written as bf16 pairs, needs a 4-byte aligned base and even strides. Anything else returns cudaErrorInvalidValue. Returns the launch's
// cudaGetLastError().
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int seq, int heads, int kv_heads,
                      int head_dim, int64_t sq_b, int64_t sq_s, int64_t sq_h,
                      int64_t sk_b, int64_t sk_s, int64_t sk_h, int64_t sv_b,
                      int64_t sv_s, int64_t sv_h, int64_t sdo_b,
                      int64_t sdo_s, int64_t sdo_h, int64_t sdq_b,
                      int64_t sdq_s, int64_t sdq_h, int causal, float scale,
                      void* stream) {
  if (seq <= 0 || batch <= 0 || kv_heads <= 0 ||
      heads % kv_heads || reinterpret_cast<uintptr_t>(dq) % 4 ||
      (sdq_b | sdq_s | sdq_h) & 1)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse), static_cast<const float*>(delta),
               dq, batch, seq, heads, kv_heads,
               {sq_b, sq_s, sq_h}, {sk_b, sk_s, sk_h}, {sv_b, sv_s, sv_h},
               {sdo_b, sdo_s, sdo_h}, {sdq_b, sdq_s, sdq_h}, causal, scale,
               static_cast<cudaStream_t>(stream)};
  const bool ragged = seq % BK != 0;
  if (head_dim == 64) return ragged ? launch<64, true>(a) : launch<64, false>(a);
  if (head_dim == 128)
    return ragged ? launch<128, true>(a) : launch<128, false>(a);
  return cudaErrorInvalidValue;
}

const char* flash_bwd_dq_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
