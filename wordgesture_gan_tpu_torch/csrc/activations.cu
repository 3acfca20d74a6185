// The port's elementwise activations for Hopper (sm_90a): gelu (the tanh
// approximation, `jax.nn.gelu`'s default) forward and backward, and
// leaky_relu's backward (slope given), each one pass over memory.
// leaky_relu's forward is PyTorch's `F.leaky_relu` with the slope in the
// dtype (ops/activations.py): one kernel that gives the plain chain's bits
// and runs faster than this file's did; its gradient at 0 is the slope
// where JAX's is 1, so the backward is here.
//
// Replaces no TPU kernel: the JAX package leaves these to XLA, which fuses
// each into its neighbours. The plain version, and the definition of every
// operation here, is wordgesture_gan_tpu_torch/models/layers.py
// (`plain_gelu`, `plain_leaky_relu`), which runs JAX's arithmetic op by op:
// one PyTorch kernel an op, each reading and writing a whole tensor.
//
// Bit-exactness. Each op rounds where the plain chain rounds:
//   * bfloat16: PyTorch computes an op in float32 and rounds the result to
//     bfloat16 (nearest even). Here +, - and * run as Hopper's packed
//     bfloat16 instructions (`mul.rn.bf16x2` and kin, two lanes a word),
//     which round the exact result once: the same number, since float32's
//     24 bits make the double rounding innocuous (see `BF16`). tanh is
//     float tanhf of each lane, then the rounding, as PyTorch's CUDA tanh
//     computes it. The constants are the plain path's, rounded to bfloat16:
//     0.044677734375, 0.796875, 0.5, 1, 3, and the slope the caller passes
//     (0.2001953125 for 0.2);
//   * float32: every op is an _rn intrinsic, so nvcc contracts no multiply
//     into an add that the plain path rounds apart; the multiply-adds the
//     plain path takes from XLA (`prng.fma`) are one double product (exact
//     for two floats) plus one double sum, rounded once to float, double
//     rounding included; tanh is XLA's CPU rational approximation with its
//     clamp, small-argument and saturation branches.
// The leaky_relu gradient is autograd's of where(x >= 0, x, x * slope):
// where(c, g, 0) + round(where(c, 0, g) * slope), so a -0 cotangent comes
// back +0 on either side. A NaN comes out where the plain path gives one
// (not necessarily with its payload).
//
// What bounds it: bytes, and for gelu the arithmetic nearly as much. At the
// transformer's critic-loop call, (1024, 128, 256) bfloat16, a forward reads
// 67 MB and writes 67 MB (0.040 ms at 3.35 TB/s), a backward reads 134 MB
// and writes 67 MB (0.060 ms). The op chain rounds to bfloat16 after each
// of gelu's ~9 forward and ~20 backward ops; a float32-to-bfloat16
// conversion issues at a fraction of the float32 rate, so one conversion an
// op kept gelu near 2.6 times its byte bound: the packed instructions round
// as they compute, and tanhf (two special-function instructions) is left as
// the largest cost. Design: a grid-stride loop over the tensor's storage
// (the wrapper hands over tensors that are non-overlapping and dense, in one
// layout, 16-byte aligned), one 16-byte load of x (and g) and one store a
// thread at a time (8 bfloat16 or 4 float32), the last few elements one a
// thread; no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op { kGeluFwd = 0, kGeluBwd = 1, kLeakyBwd = 2 };

// a * b + c rounded once to float: XLA's contracted multiply-add.
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(c)));
}

// XLA's CPU tanh for float32: the constants as the plain path rounds them
// (a Python float, a double, rounded to float).
__device__ float xla_tanh(float x) {
  const float clamp = static_cast<float>(7.99881172180175781);
  const float num[7] = {static_cast<float>(-2.76076847742355e-16),
                        static_cast<float>(2.00018790482477e-13),
                        static_cast<float>(-8.60467152213735e-11),
                        static_cast<float>(5.12229709037114e-08),
                        static_cast<float>(1.48572235717979e-05),
                        static_cast<float>(6.37261928875436e-04),
                        static_cast<float>(4.89352455891786e-03)};
  const float den[4] = {static_cast<float>(1.19825839466702e-06),
                        static_cast<float>(1.18534705686654e-04),
                        static_cast<float>(2.26843463243900e-03),
                        static_cast<float>(4.89352518554385e-03)};
  const float xc = isnan(x) ? x : fminf(fmaxf(x, -clamp), clamp);
  const float x2 = __fmul_rn(xc, xc);
  float p = fma_f32(x2, num[0], num[1]);
#pragma unroll
  for (int i = 2; i < 7; ++i) p = fma_f32(x2, p, num[i]);
  float q = fma_f32(x2, den[0], den[1]);
#pragma unroll
  for (int i = 2; i < 4; ++i) q = fma_f32(x2, q, den[i]);
  float r = __fdiv_rn(__fmul_rn(xc, p), q);
  const float ax = fabsf(x);
  if (ax < static_cast<float>(0.0004)) r = x;
  if (ax >= 20.0f) r = copysignf(1.0f, x);
  return r;
}

// The arithmetic of one dtype on one 32-bit word of a tensor: one float32,
// or two bfloat16 lanes. Each op rounds where the plain chain rounds.
struct F32 {
  using T = float;
  static constexpr int kBytes = 4;  // an element's
  static constexpr float kC1 = static_cast<float>(0.044715);
  static constexpr float kC2 = static_cast<float>(0.7978845608028654);
  static __device__ __forceinline__ T from_word(uint32_t w) { return __uint_as_float(w); }
  static __device__ __forceinline__ uint32_t to_word(T v) { return __float_as_uint(v); }
  static __device__ __forceinline__ T k(float c) { return c; }
  static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ T fused(T a, T b, T c) { return fma_f32(a, b, c); }
  static __device__ __forceinline__ T tanh(T v) { return xla_tanh(v); }
  // a where x >= 0, else b.
  static __device__ __forceinline__ T where_nonneg(T x, T a, T b) { return x >= 0.0f ? a : b; }
};

// bfloat16 pairs, with Hopper's packed bfloat16 instructions. PyTorch
// computes a bfloat16 op in float32 and rounds the float32 result to
// bfloat16; for +, - and * of two bfloat16 numbers that equals rounding the
// exact result once (float32's 24 bits are at least 2 * 8 + 2, so the double
// rounding is innocuous; below 2^-126, where float32 is subnormal too, an
// exact product within half a float32 subnormal step of a bfloat16 midpoint
// would need more than the 16 bits two 8-bit significands give), which is
// what `mul.rn.bf16x2` and its kin do, subnormals kept. The explicit .rn
// keeps ptxas from contracting a multiply and an add into one rounding.
struct BF16 {
  using T = uint32_t;
  static constexpr int kBytes = 2;
  static constexpr float kC1 = 0.044677734375f;
  static constexpr float kC2 = 0.796875f;
  static __device__ __forceinline__ T from_word(uint32_t w) { return w; }
  static __device__ __forceinline__ uint32_t to_word(T v) { return v; }
  static __device__ __forceinline__ float lo(T v) { return __uint_as_float(v << 16); }
  static __device__ __forceinline__ float hi(T v) { return __uint_as_float(v & 0xFFFF0000u); }
  // Both lanes from two floats, each rounded to nearest even.
  static __device__ __forceinline__ T pack(float hi_lane, float lo_lane) {
    T d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi_lane), "f"(lo_lane));
    return d;
  }
  // A constant that bfloat16 holds exactly, in both lanes.
  static __device__ __forceinline__ T k(float c) {
    const uint32_t h = __float_as_uint(c) >> 16;
    return h | (h << 16);
  }
  static __device__ __forceinline__ T mul(T a, T b) {
    T d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ T add(T a, T b) {
    T d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ T sub(T a, T b) {
    T d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ T fused(T a, T b, T c) { return add(mul(a, b), c); }
  static __device__ __forceinline__ T tanh(T v) { return pack(tanhf(hi(v)), tanhf(lo(v))); }
  static __device__ __forceinline__ T where_nonneg(T x, T a, T b) {
    const uint32_t keep = (lo(x) >= 0.0f ? 0x0000FFFFu : 0u) | (hi(x) >= 0.0f ? 0xFFFF0000u : 0u);
    return (a & keep) | (b & ~keep);
  }
};

// gelu's cdf 0.5 * (1 + tanh(c2 * (x + c1 * x^3))), with tanh and x^2 kept
// for the backward; `_Gelu.cdf` of layers.py. c1 = 0.044715 and c2 =
// sqrt(2 / pi), each rounded to the dtype.
template <typename A>
__device__ __forceinline__ typename A::T gelu_cdf(typename A::T x, typename A::T& t,
                                                  typename A::T& xx) {
  xx = A::mul(x, x);
  t = A::tanh(A::mul(A::fused(A::mul(xx, x), A::k(A::kC1), x), A::k(A::kC2)));
  return A::mul(A::add(t, A::k(1.0f)), A::k(0.5f));
}

// `_Gelu.backward` of layers.py: JAX's transposed JVP, op by op.
template <typename A>
__device__ __forceinline__ typename A::T gelu_grad(typename A::T x, typename A::T g) {
  using T = typename A::T;
  T t, xx;
  const T cdf = gelu_cdf<A>(x, t, xx);
  const T p = A::mul(A::mul(A::mul(x, g), A::k(0.5f)), A::sub(A::k(1.0f), t));
  const T r = A::fused(p, t, p);
  const T s = A::mul(r, A::k(A::kC2));
  const T xx3 = A::mul(xx, A::k(3.0f));
  if constexpr (A::kBytes == 4) {
    // float32: XLA folds c2 * c1 into one constant (the double product of
    // the two floats is exact) and fuses the two adds.
    constexpr float kC21 = static_cast<float>(static_cast<double>(A::kC2) *
                                              static_cast<double>(A::kC1));
    return fma_f32(A::mul(r, kC21), xx3, fma_f32(g, cdf, s));
  } else {
    return A::add(A::add(A::mul(g, cdf), s), A::mul(A::mul(s, A::k(A::kC1)), xx3));
  }
}

template <int OP, typename A>
__device__ __forceinline__ typename A::T apply(typename A::T x, typename A::T g,
                                               typename A::T slope) {
  using T = typename A::T;
  if constexpr (OP == kGeluFwd) {
    T t, xx;
    return A::mul(x, gelu_cdf<A>(x, t, xx));
  } else if constexpr (OP == kGeluBwd) {
    return gelu_grad<A>(x, g);
  } else {
    // autograd's where(c, g, 0) + where(c, 0, g) * slope.
    const T zero = A::k(0.0f);
    return A::add(A::where_nonneg(x, g, zero), A::mul(A::where_nonneg(x, zero, g), slope));
  }
}

// out = op(x, g) over n elements, all three arrays 16-byte aligned: one
// 16-byte load of x (and of g) and one store a thread at a time, four 32-bit
// words each, in a grid-stride loop; the last n % (16 / A::kBytes) elements
// one each by the first threads of the grid.
template <int OP, typename A>
__global__ void __launch_bounds__(256) activation_kernel(const uint4* __restrict__ x,
                                                         const uint4* __restrict__ g,
                                                         uint4* __restrict__ out, long long n,
                                                         float slope_f) {
  constexpr bool kGrad = OP != kGeluFwd;
  const typename A::T slope = A::k(slope_f);
  constexpr long long per_pack = 16 / A::kBytes;
  const long long packs = n / per_pack;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = first; i < packs; i += stride) {
    const uint4 xv = x[i];
    const uint4 gv = kGrad ? g[i] : xv;
    uint4 ov;
    ov.x = A::to_word(apply<OP, A>(A::from_word(xv.x), A::from_word(gv.x), slope));
    ov.y = A::to_word(apply<OP, A>(A::from_word(xv.y), A::from_word(gv.y), slope));
    ov.z = A::to_word(apply<OP, A>(A::from_word(xv.z), A::from_word(gv.z), slope));
    ov.w = A::to_word(apply<OP, A>(A::from_word(xv.w), A::from_word(gv.w), slope));
    out[i] = ov;
  }
  const long long j = packs * per_pack + first;
  if (j < n) {
    // One element in the low lane of a word (bfloat16: the high lane is 0).
    uint32_t xw, gw = 0;
    if constexpr (A::kBytes == 4) {
      xw = reinterpret_cast<const uint32_t*>(x)[j];
      if (kGrad) gw = reinterpret_cast<const uint32_t*>(g)[j];
    } else {
      xw = reinterpret_cast<const unsigned short*>(x)[j];
      if (kGrad) gw = reinterpret_cast<const unsigned short*>(g)[j];
    }
    const uint32_t ow = A::to_word(apply<OP, A>(A::from_word(xw), A::from_word(gw), slope));
    if constexpr (A::kBytes == 4)
      reinterpret_cast<uint32_t*>(out)[j] = ow;
    else
      reinterpret_cast<unsigned short*>(out)[j] = static_cast<unsigned short>(ow);
  }
}

template <int OP, typename A>
int launch(const void* x, const void* g, void* out, long long n, float slope, int max_blocks,
           cudaStream_t stream) {
  const int threads = 256;
  const long long packs = n / (16 / A::kBytes);
  const long long wanted = ((packs > 0 ? packs : 1) + threads - 1) / threads;
  const int blocks = static_cast<int>(wanted < max_blocks ? wanted : max_blocks);
  activation_kernel<OP, A><<<blocks, threads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(g), static_cast<uint4*>(out), n,
      slope);
  return static_cast<int>(cudaGetLastError());
}

template <typename A>
int launch_op(int op, const void* x, const void* g, void* out, long long n, float slope,
              int max_blocks, cudaStream_t stream) {
  switch (op) {
    case kGeluFwd: return launch<kGeluFwd, A>(x, g, out, n, slope, max_blocks, stream);
    case kGeluBwd: return launch<kGeluBwd, A>(x, g, out, n, slope, max_blocks, stream);
    case kLeakyBwd: return launch<kLeakyBwd, A>(x, g, out, n, slope, max_blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out = op(x[, g]) over n elements of one dtype (0 float32, 1 bfloat16), all
// three arrays in one layout and 16-byte aligned (`g` is read by the
// backwards only and may be null for the forward); `slope` is
// leaky_relu's, in the dtype; at most `max_blocks` blocks of 256 threads.
// Runs on `stream` without synchronising; returns the cudaError_t of the
// launch (0 on success), cudaErrorInvalidValue for arguments it does not
// take, cudaErrorMisalignedAddress for an array off 16-byte alignment.
int wgg_activation(int op, int dtype, const void* x, const void* g, void* out, long long n,
                   float slope, int max_blocks, cudaStream_t stream) {
  if (n < 1 || max_blocks < 1 || op < kGeluFwd || op > kLeakyBwd ||
      (op != kGeluFwd && g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (g == nullptr) g = x;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(out)) & 15u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == 0) return launch_op<F32>(op, x, g, out, n, slope, max_blocks, stream);
  if (dtype == 1) return launch_op<BF16>(op, x, g, out, n, slope, max_blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
