// Flash-attention forward for Hopper (sm_90a) on bf16 tensor cores, plain C
// interface for ctypes.
//
// Replaces K1 of the JAX package: cron_operator_tpu/ops/flash_attention.py
// `_flash_kernel`, launched by `_forward` through `pl.pallas_call`, for bf16
// inputs at head dims 64 and 128 (`flash_fwd.cu` keeps f32 and d 32/256).
// Same function: online-softmax attention over [b, s, h, d], optional causal
// mask, grouped-query K/V read in place, O in bf16 and the per-row logsumexp
// LSE = m + log(l) in f32 (a row that saw no key gives O = 0 and LSE =
// LSE_MASKED). As in the TPU kernel, P is rounded to bf16 before P V and the
// normaliser l sums the unrounded f32 P.
//
// Bound: at the training shape (b 8, s 1024, h 12, d 64, causal) the
// function moves Q, K, V, O and the f32 LSE once, 50.73 MB, 15.1 us at
// 3.35 TB/s; its 12.9 GFLOP take 13.0 us at 989 TFLOP/s. It is bound by
// bytes, though barely, so the design has to keep both sides busy: the bytes
// at their floor (each block reads its Q tile once and streams K/V, and the
// s x s scores never leave the SM), the products on the tensor cores.
//
// Design. A block owns a query tile of one (batch, head): NWG consumer
// warpgroups of 64 rows each (NWG = 2: 128 rows, or 1: 64) and one producer
// warp. The producer's first lane loads Q once and then K/V tiles of 64 keys
// by TMA (128-byte swizzle, one 4-D tensor map per input over its [b, s, h,
// d] strides, so the strided q/k/v views of a fused projection need no copy)
// into a ring of STAGES buffers guarded by full/empty mbarriers, so the next
// tiles are in flight while the consumers compute. Each consumer warpgroup
// runs S = Q K^T as wgmma m64n64k16 with both operands in shared memory,
// keeps m and l in registers on the accumulator layout (a row lives in the
// four lanes of a quad, so row max and sum are two shuffles), converts P to
// bf16 in registers and runs O += P V as wgmma with P as the register A
// operand and V read N-major from its natural [kv, d] layout. Causal blocks
// stop at the diagonal; the last query tiles, which see the most keys, are
// launched first. A warpgroup whose rows all lie past s (the second of a
// last half block) computes and stores nothing. NWG follows the head dim
// (`flash_fwd_sm90` below), from device times on the H100 (PERF.md): at d
// 64 one warpgroup (two or three blocks share an SM and hide each other's
// waits), at d 128 two (each K/V tile, twice as wide, then feeds twice the
// rows).
//
// Any sequence length s >= 1. The grid and the key loop round the tile
// counts up, so the last query tile and the last key tile may be partial.
// TMA reads rows past s as zeros (the tensor maps end at s), and no row past
// s is stored. In the last key tile a key past s scores NEG_INF, as the
// causal mask sets a key above the diagonal, so its P is exactly 0 and a
// zero-filled key takes no softmax mass; in the last query tile P is set to
// 0 in every row past s. These masks live in a second instantiation of the
// kernel (RAGGED), launched when s is not a multiple of 64: any code for
// them in the loop, even a branch that the aligned shapes never take, made
// those shapes slower on the H100 (PERF.md), so a multiple of 64 runs the
// kernel without it. The LSE is f32 [b * h, s]: row r of (batch, head) bh
// at bh * s + r, written for r < s only.
//
// The tensor maps come from cuTensorMapEncodeTiled through
// cudaGetDriverEntryPoint (sm90.cuh), so the library needs no -lcuda.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BN = 64;      // keys per K/V tile
constexpr int STAGES = 3;   // K/V ring depth
constexpr float NEG_INF = -1e30f;    // masked score, as in the JAX kernel
constexpr float LSE_MASKED = 1e30f;  // LSE of a row that saw no key
constexpr float LN2 = 0.6931471805599453f;

template <int D, int NWG>
struct Layout {
  static constexpr int PANELS = D / PANEL_COLS;
  static constexpr int TILE = PANELS * 64 * 128;  // 64 rows at width D, bytes
  static constexpr int Q = 0;                     // NWG tiles
  static constexpr int K = Q + NWG * TILE;        // STAGES tiles
  static constexpr int V = K + STAGES * TILE;     // STAGES tiles
  static constexpr int BARS = V + STAGES * TILE;  // q, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + align
  static constexpr int THREADS = 128 * NWG + 32;
};

template <int D, int NWG, bool RAGGED>
__global__ void __launch_bounds__(Layout<D, NWG>::THREADS, NWG == 1 ? 2 : 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int seq, int heads,
                          int kv_heads, int64_t so_b, int64_t so_s,
                          int64_t so_h, int causal, float scale_log2) {
  using L = Layout<D, NWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_bar = base + L::BARS;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  constexpr int ROWS = 64 * NWG;
  const int n_qt = (seq + ROWS - 1) / ROWS;
  const int q_tile = n_qt - 1 - blockIdx.y;  // longest causal tiles first
  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh % heads;
  const int kvh = hi / (heads / kv_heads);  // grouped K/V addressed in place
  const int q0 = q_tile * ROWS;
  const int q_end = min(seq, q0 + ROWS);
  const int n_kt = ((causal ? q_end : seq) + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_bar + 8 * st, 1);
      mbar_init(empty_bar + 8 * st, 4 * NWG);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * NWG) {  // producer warp: one lane issues every load
    if (tid == 128 * NWG) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_arrive_expect_tx(q_bar, NWG * L::TILE);
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < L::PANELS; ++p)
          tma_load_4d(base + L::Q + w * L::TILE + p * 8192, &tm_q,
                      p * PANEL_COLS, q0 + 64 * w, hi, bi, q_bar);
      int st = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(empty_bar + 8 * st, phase ^ 1);
        const uint32_t full = full_bar + 8 * st;
        mbar_arrive_expect_tx(full, 2 * L::TILE);
        for (int p = 0; p < L::PANELS; ++p) {
          tma_load_4d(base + L::K + st * L::TILE + p * 8192, &tm_k,
                      p * PANEL_COLS, kt * BN, kvh, bi, full);
          tma_load_4d(base + L::V + st * L::TILE + p * 8192, &tm_v,
                      p * PANEL_COLS, kt * BN, kvh, bi, full);
        }
        if (++st == STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup `wg`: query rows row0 .. row0 + 63.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int r_lo = 16 * warp + lane / 4;  // this thread's rows: r_lo, r_lo + 8
  const int c2 = 2 * (lane % 4);          // and columns 8j + c2, 8j + c2 + 1
  const int row0 = q0 + 64 * wg;
  const bool active = row0 < seq;
  const int my_kt = !active ? 0 : causal ? row0 / BN + 1 : n_kt;
  const uint32_t q_s = base + L::Q + wg * L::TILE;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum

  mbar_wait(q_bar, 0);
  int st = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    mbar_wait(full_bar + 8 * st, phase);
    if (kt < my_kt) {
      const uint32_t k_s = base + L::K + st * L::TILE;
      const uint32_t v_s = base + L::V + st * L::TILE;
      float s[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_k_major(q_s + (kk / 4) * 8192, kk % 4),
                     desc_k_major(k_s + (kk / 4) * 8192, kk % 4), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);

      if constexpr (RAGGED) {
        if ((kt + 1) * BN > seq) {  // the last key tile: keys past s
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            if (kt * BN + 8 * (i >> 2) + c2 + (i & 1) >= seq) s[i] = NEG_INF;
        }
      }
      const bool diagonal = causal && kt == row0 / BN;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = r_lo + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + c2 + (i & 1);
        float x = s[i] * scale_log2;
        if (diagonal && c > r) x = NEG_INF;
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = fast_exp2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = fast_exp2(s[i] - m[h]);
        l[h] += s[i];
      }
      if constexpr (RAGGED) {
        if (row0 + 64 > seq) {  // the last query tile: P = 0 past s
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            if (row0 + r_lo + 8 * ((i >> 1) & 1) >= seq) s[i] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      uint32_t p[BN / 4];  // P in bf16: the A operand of P V
      acc_to_a(s, p);
      wgmma_fence();
#pragma unroll
      for (int pn = 0; pn < L::PANELS; ++pn)
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs_n64_tb(acc + 32 * pn, p + 4 * kk,
                          desc_n_major(v_s + pn * 8192, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(p);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * st);
    if (++st == STAGES) {
      st = 0;
      phase ^= 1;
    }
  }
  if (!active) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + r_lo + 8 * h;
    if (row >= seq) continue;
    const bool masked = l[h] == 0.f;  // fully masked row: O = 0, not NaN
    const float inv = masked ? 1.f : 1.f / l[h];
    __nv_bfloat16* o_row = o + bi * so_b + (int64_t)row * so_s + hi * so_h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * j + c2) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * inv,
                                acc[4 * j + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[(int64_t)bh * seq + row] =
          masked ? LSE_MASKED : (m[h] + __log2f(l[h])) * LN2;
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  int batch, seq, heads, kv_heads;
  int64_t sq[3], sk[3], sv[3], so[3];  // b, s, h element strides
  int causal;
  float scale;
  cudaStream_t stream;
};

template <int D, int NWG, bool RAGGED>
cudaError_t launch(const Args& a) {
  using L = Layout<D, NWG>;
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map_bshd(&tm_q, a.q, a.batch, a.seq, a.heads, D,
                                  a.sq[0], a.sq[1], a.sq[2], 64);
  if (err == cudaSuccess)
    err = make_map_bshd(&tm_k, a.k, a.batch, a.seq, a.kv_heads, D, a.sk[0],
                        a.sk[1], a.sk[2], BN);
  if (err == cudaSuccess)
    err = make_map_bshd(&tm_v, a.v, a.batch, a.seq, a.kv_heads, D, a.sv[0],
                        a.sv[1], a.sv[2], BN);
  if (err != cudaSuccess) return err;
  static std::atomic<uint64_t> smem_set{0};
  err = allow_smem_once(
      smem_set,
      reinterpret_cast<const void*>(flash_fwd_sm90_kernel<D, NWG, RAGGED>),
      L::BYTES);
  if (err != cudaSuccess) return err;
  const int rows = 64 * NWG;
  const dim3 grid(a.batch * a.heads, (a.seq + rows - 1) / rows);
  flash_fwd_sm90_kernel<D, NWG, RAGGED>
      <<<grid, L::THREADS, L::BYTES, a.stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(a.o),
      static_cast<float*>(a.lse), a.seq, a.heads, a.kv_heads, a.so[0],
      a.so[1], a.so[2], a.causal, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 only; head_dim 64 (64 query rows a block) or 128 (128 rows); any
// seq >= 1.
// Strides are in elements (every head_dim stride is 1); q, k and v need a
// 16-byte aligned base and strides that are multiples of 8 elements, which
// the caller checks. Anything else returns cudaErrorInvalidValue. Returns
// the launch's cudaGetLastError().
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int seq, int heads, int kv_heads,
                   int head_dim, int64_t sq_b, int64_t sq_s, int64_t sq_h,
                   int64_t sk_b, int64_t sk_s, int64_t sk_h, int64_t sv_b,
                   int64_t sv_s, int64_t sv_h, int64_t so_b, int64_t so_s,
                   int64_t so_h, int causal, float scale, void* stream) {
  if (seq <= 0 || batch <= 0 || kv_heads <= 0 || heads % kv_heads)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, lse, batch, seq, heads, kv_heads,
               {sq_b, sq_s, sq_h}, {sk_b, sk_s, sk_h}, {sv_b, sv_s, sv_h},
               {so_b, so_s, so_h}, causal, scale,
               static_cast<cudaStream_t>(stream)};
  const bool ragged = seq % BN != 0;
  if (head_dim == 64)
    return ragged ? launch<64, 1, true>(a) : launch<64, 1, false>(a);
  if (head_dim == 128)
    return ragged ? launch<128, 2, true>(a) : launch<128, 2, false>(a);
  return cudaErrorInvalidValue;
}

const char* flash_fwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
