// Softmax cross-entropy over the padded logits for Hopper (sm_90a), forward
// and backward, plain C interface for ctypes.
//
// No Pallas kernel stands behind this one: on the TPU the training loss is
// cron_operator_tpu/workloads/train.py:44-49 (cross_entropy_loss), whose
// astype(f32), log_softmax and gather XLA fuses into reductions over the
// bf16 logits. The port's former path (ops/xent.py
// softmax_cross_entropy_reference, the plain version) cut the padded
// product to V columns and cast it to a fresh f32 [T, V], wrote log_softmax
// into a second, and its backward scattered into a third, ran
// log-softmax's backward into a fourth, cast that to bf16 and padded it
// back to Vp columns. This pair reads the [T, Vp] product as the GEMM wrote
// it and keeps only f32 [T] rows.
//
// Function (row t of T; the first V of its Vp columns count, Vp the row
// stride; g is the mean loss's incoming gradient):
//   forward   lse_t  = log sum_{j<V} exp(x_tj)       (f32, online max and sum)
//             loss_t = lse_t - x_{t,label_t}          (NaN for a label outside
//                                                      [0, V))
//   backward  dx_tj = (exp(x_tj - lse_t) - [j == label_t]) * (g / T), j < V,
//             in f32, rounded once to x's type; dx_tj = 0 for V <= j < Vp,
//             as the former slice's backward padded them.
// The mean over T is the wrapper's: one torch sum of loss_t, in one order.
//
// A slice of the vocab (a `tensor` rank's block of the tied table, the
// Megatron vocab-parallel loss): the row holds the global columns lo ..
// lo + Vp - 1, of which the first R (0 to Vp) are real, of a vocab of V.
// The forward then writes the slice's lse_t over its R columns (-inf for
// R = 0) and, in place of the loss, the label's logit x_{t,label_t - lo}
// when lo <= label_t < lo + R, else 0 (NaN for a label outside [0, V),
// decided on the whole vocab); the wrapper merges both over the group. The
// backward takes the merged lse_t and writes (exp(x_tj - lse_t) -
// [j + lo == label_t]) * (g / T) on the R real columns, exact zeros past
// them. The whole row is the slice lo = 0, R = V, and the forward writes
// the loss there: the same arithmetic, to the bit.
//
// Bound: bytes. The forward reads T * Vp elements, the backward reads as
// many and writes as many (labels, lse and loss are 16 bytes a row). GPT-2
// small's b 8 x 1024 (T 8192, Vp 50304) in bf16: 824.2 MB forward and
// 1648.4 MB backward, 0.246 and 0.492 ms at 3.35 TB/s; BERT-base's b 8 x
// 512 (T 4096, Vp 30528): 0.075 and 0.149 ms; a `tensor` rank's slice of
// GPT-2 small's at 2 ranks (T 8192, Vp 25152) half of GPT's, 0.123 and
// 0.246 ms. The arithmetic is one exp2
// and a few f32 operations an element: GPT's 412 M exps take about 0.11 ms
// at the special-function units' 16 a clock an SM, under the byte bound.
//
// Design "row": one block of 256 threads a row. Thread i reads vectors i,
// i + 256, ... of 16 bytes (8 bf16 or 4 f32 values), UNROLL loads started
// before any is used, so that each SM keeps some 100 KB of reads in flight.
// - Forward: each thread keeps an online (max m, sum s of exp(x - m)) over
//   its vectors, rescaling s when a vector raises m; the vector that holds
//   column V - 1 and the columns past it are read masked. The block merges
//   its 256 pairs by a shuffle butterfly in each warp (every lane ends with
//   the same bits: the merge is commutative) and the 8 warps' pairs in
//   order, and thread 0 writes lse and the loss.
// - Backward: each thread turns its vectors into the gradient and writes
//   it with 16-byte stores, exact zeros past V.
// Exponentials are exp2f((x - m) * log2 e): the subtraction is exact or
// rounds once, the product rounds once, exp2f is within 2 ulp.
// No atomics: every sum has one order, so reruns are bit-identical. Nothing
// allocates or synchronises, and g is read on the device, so a CUDA graph
// capture of the step holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr float LOG2E = 1.4426950408889634f;

// 16 bytes of T as they lie in memory (Raw) and widened to N floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static void unpack(const Raw& r, float (&v)[N]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static void store(float* p, const float (&v)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float one(const float* p) { return __ldg(p); }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // a word holds two bf16 values, the lower address in the low half; a
  // bf16 is the upper half of the f32 of the same value
  __device__ static void unpack(const Raw& r, float (&v)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

__device__ __forceinline__ float exp_of(float x, float m) {
  return exp2f((x - m) * LOG2E);
}

// Adds the first `valid` values of v to the online pair (m, s).
template <int N>
__device__ __forceinline__ void accumulate(const float (&v)[N], int valid,
                                           float& m, float& s) {
  float vm = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < valid) vm = fmaxf(vm, v[k]);
  if (vm > m) {
    s *= exp_of(m, vm);  // 0 while m is -inf
    m = vm;
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < valid) s += exp_of(v[k], m);
}

// (m, s) merged with (m2, s2); a pair that has seen nothing is (-inf, 0).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -CUDART_INF_F) return;
  s = s * exp_of(m, mx) + s2 * exp_of(m2, mx);
  m = mx;
}

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
    xent_fwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                    float* __restrict__ lse_out, float* __restrict__ loss_out,
                    int vp, int real, int lo, int vocab) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int row = blockIdx.x;
  const T* x = logits + static_cast<size_t>(row) * vp;
  const int full = real / N;  // vectors wholly inside the real columns
  float m = -CUDART_INF_F, s = 0.f;
  for (int base = threadIdx.x; base < full; base += THREADS * UNROLL) {
    typename V::Raw r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < full) r[u] = V::load(x + static_cast<size_t>(i) * N);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS < full) {
        float v[N];
        V::unpack(r[u], v);
        accumulate<N>(v, N, m, s);
      }
    }
  }
  const int tail = real - full * N;  // columns of vector `full` that count
  if (tail && threadIdx.x == (full % THREADS)) {
    float v[N];
    V::unpack(V::load(x + static_cast<size_t>(full) * N), v);
    accumulate<N>(v, tail, m, s);
  }

#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, s, m2, s2);
  }
  __shared__ float warp_m[WARPS], warp_s[WARPS];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    warp_m[warp] = m;
    warp_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = warp_m[0];
    s = warp_s[0];
    for (int w = 1; w < WARPS; ++w) merge(m, s, warp_m[w], warp_s[w]);
    const float lse = m + logf(s);  // -inf when no column is real
    const long long label = static_cast<long long>(labels[row]) - lo;
    const bool valid = label + lo >= 0 && label + lo < vocab;
    const float picked = !valid ? CUDART_NAN_F
                         : (label >= 0 && label < real) ? V::one(x + label)
                                                        : 0.f;
    lse_out[row] = lse;
    // the whole row's loss, or a slice's label logit for the merge
    loss_out[row] = (lo == 0 && real == vocab) ? lse - picked : picked;
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(THREADS)
    xent_bwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    T* __restrict__ dlogits, int rows, int vp, int real,
                    int lo) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const int row = blockIdx.x;
  const size_t offset = static_cast<size_t>(row) * vp;
  const T* x = logits + offset;
  T* dx = dlogits + offset;
  // d(mean)/d(loss_t), as the former mean's backward: g / T in f32
  const float scale = __ldg(g) / static_cast<float>(rows);
  const float l = __ldg(lse + row);
  // the label's column in this slice (outside [0, real): no column)
  const long long label = static_cast<long long>(labels[row]) - lo;
  const int vectors = vp / N;
  for (int base = threadIdx.x; base < vectors; base += THREADS * UNROLL) {
    typename V::Raw r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < vectors) r[u] = V::load(x + static_cast<size_t>(i) * N);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i < vectors) {
        float v[N];
        V::unpack(r[u], v);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int j = i * N + k;
          v[k] = j < real
                     ? (exp_of(v[k], l) - (j == label ? 1.f : 0.f)) * scale
                     : 0.f;
        }
        V::store(dx + static_cast<size_t>(i) * N, v);
      }
    }
  }
}

bool shape_ok(const void* a, int dtype, int label_bytes, int rows, int vp,
              int real, int lo, int vocab) {
  const int n = dtype == 1 ? 8 : 4;
  return (dtype == 0 || dtype == 1) &&
         (label_bytes == 4 || label_bytes == 8) && rows > 0 && vp > 0 &&
         vp % n == 0 && real >= 0 && real <= vp && lo >= 0 && vocab > 0 &&
         // a slice without a real column may start past the vocab's end
         (real == 0 || static_cast<long long>(lo) + real <= vocab) &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0;
}

// f.template operator()<T, L>() with the element type of dtype (0 float32,
// 1 bfloat16) and the label type of label_bytes (4 int32, 8 int64).
template <typename F>
int by_types(int dtype, int label_bytes, F&& f) {
  if (dtype == 1) {
    if (label_bytes == 4) return f(__nv_bfloat16{}, int32_t{});
    return f(__nv_bfloat16{}, int64_t{});
  }
  if (label_bytes == 4) return f(float{}, int32_t{});
  return f(float{}, int64_t{});
}

}  // namespace

extern "C" {

// logits [rows, vp] of dtype (0 float32, 1 bfloat16), rows contiguous and
// 16-byte aligned, the global columns lo .. lo + vp - 1 of a vocab of
// `vocab`, of which the first `real` count (lo 0 and real == vocab: the
// whole row); labels [rows] int32 or int64 (label_bytes 4 or 8); lse and
// loss f32 [rows] (loss: the label's logit for a slice). Returns the
// launch's cudaGetLastError(), cudaErrorInvalidValue for what the kernel
// does not take.
int xent_fwd(const void* logits, const void* labels, void* lse, void* loss,
             int dtype, int label_bytes, int rows, int vp, int real, int lo,
             int vocab, void* stream) {
  if (!shape_ok(logits, dtype, label_bytes, rows, vp, real, lo, vocab))
    return cudaErrorInvalidValue;
  return by_types(dtype, label_bytes, [&](auto t, auto l) {
    using T = decltype(t);
    using L = decltype(l);
    xent_fwd_kernel<T, L><<<rows, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(logits), static_cast<const L*>(labels),
        static_cast<float*>(lse), static_cast<float*>(loss), vp, real, lo,
        vocab);
    return static_cast<int>(cudaGetLastError());
  });
}

// As xent_fwd's, with lse f32 [rows] from it (merged over the slices), g
// the f32 gradient of the mean loss (one value on the device) and dlogits
// [rows, vp] of logits' dtype and alignment, every column written.
int xent_bwd(const void* logits, const void* labels, const void* lse,
             const void* g, void* dlogits, int dtype, int label_bytes,
             int rows, int vp, int real, int lo, int vocab, void* stream) {
  if (!shape_ok(logits, dtype, label_bytes, rows, vp, real, lo, vocab) ||
      reinterpret_cast<uintptr_t>(dlogits) % 16 != 0)
    return cudaErrorInvalidValue;
  return by_types(dtype, label_bytes, [&](auto t, auto l) {
    using T = decltype(t);
    using L = decltype(l);
    xent_bwd_kernel<T, L><<<rows, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(logits), static_cast<const L*>(labels),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<T*>(dlogits), rows, vp, real, lo);
    return static_cast<int>(cudaGetLastError());
  });
}

const char* xent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
