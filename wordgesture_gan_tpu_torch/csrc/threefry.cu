// The JAX package's random draws for Hopper (sm_90a): threefry2x32 bits,
// uniforms and normals, number for number as `jax.random` computes them
// (threefry2x32, partitionable bit generation, 32-bit mode).
//
// Replaces no TPU kernel: the JAX package draws with XLA's own lowering of
// `jax.random`. Its plain version, and the definition of every operation
// here, is wordgesture_gan_tpu_torch/utils/prng.py.
//
// One launch draws n_keys rows of m numbers: row k hashes the counters
// (j >> 32, j & 0xFFFFFFFF), j = 0..m-1, under key k (two uint32 words read
// from a device buffer, so a captured CUDA graph draws fresh numbers when
// the buffer is rewritten between replays). Bits are y0 ^ y1 of the hash;
// a uniform puts the top 23 bits under 1.0's exponent, subtracts 1, and
// scales with one fused multiply-add; a normal is sqrt(2) * erfinv(u) with
// XLA's float32 erfinv, whose log1p and log are XLA's CPU polynomials.
//
// Bit-exactness. Every float32 operation is written with an _rn intrinsic,
// so nvcc contracts nothing into an FMA; the multiply-adds that XLA fuses
// are computed as one double product (exact for two floats) plus one double
// sum, rounded once to float, as the plain version computes them. The
// kernel therefore equals the plain version bit for bit.
//
// What bounds it: a draw writes 4 bytes a number (8 for bits) and does about
// 120 integer operations of the hash and about 90 float operations of the
// normal per number; at the train step's 14 x 512 x 32 normals that is
// 0.9 MB and ~5e7 operations, under a microsecond either way, so a launch
// costs its launch latency. One thread per number, no shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][r]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// a * b + c rounded once to float: XLA's contracted multiply-add.
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(c)));
}

// XLA's CPU log (Cephes logf), for normal positive x.
__device__ float xla_log(float v) {
  int e_int;
  float x = frexpf(v, &e_int);  // v = x * 2^e, x in [0.5, 1)
  float e = static_cast<float>(e_int);
  const bool below = x < 0.707106781186547524f;
  const float tmp = below ? x : 0.0f;
  x = __fsub_rn(x, 1.0f);
  e = __fsub_rn(e, below ? 1.0f : 0.0f);
  x = __fadd_rn(x, tmp);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = fma_f32(x, 7.0376836292E-2f, -1.1514610310E-1f);
  float y1 = fma_f32(x, -1.2420140846E-1f, 1.4249322787E-1f);
  float y2 = fma_f32(x, 2.0000714765E-1f, -2.4999993993E-1f);
  y = fma_f32(y, x, 1.1676998740E-1f);
  y1 = fma_f32(y1, x, -1.6668057665E-1f);
  y2 = fma_f32(y2, x, 3.3333331174E-1f);
  y = fma_f32(y, x3, y1);
  y = fma_f32(y, x3, y2);
  y = fma_f32(y, x3, __fmul_rn(-2.12194440e-4f, e));
  float r = fma_f32(-x2, 0.5f, x);
  r = __fadd_rn(r, y);
  return fma_f32(0.693359375f, e, r);
}

// XLA's log1p: Cephes' rational form below |x| < sqrt(2) - 1, else log(1 + x).
__device__ float xla_log1p(float x) {
  if (fabsf(x) < 0.41421356237309504880f) {
    const float den[7] = {1.0f, 1.5062909083469192043167E1f, 8.3047565967967209469434E1f,
                          2.2176239823732856465394E2f, 3.0909872225312059774938E2f,
                          2.1642788614495947685003E2f, 6.0118660497603843919306E1f};
    const float num[7] = {4.5270000862445199635215E-5f, 4.9854102823193375972212E-1f,
                          6.5787325942061044846969E0f, 2.9911919328553073277375E1f,
                          6.0949667980987787057556E1f, 5.7112963590585538103336E1f,
                          2.0039553499201281259648E1f};
    float d = den[0], n = num[0];
#pragma unroll
    for (int i = 1; i < 7; ++i) {
      d = fma_f32(d, x, den[i]);
      n = fma_f32(n, x, num[i]);
    }
    const float x2 = __fmul_rn(x, x);
    float t = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(n, d));
    t = fma_f32(-0.5f, x2, t);
    return __fadd_rn(x, t);
  }
  return xla_log(__fadd_rn(x, 1.0f));
}

// XLA's float32 erfinv (Giles), highest coefficient first.
__device__ float xla_erfinv(float x) {
  const float lt5[9] = {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f,
                        0.00021858087f, -0.00125372503f, -0.00417768164f, 0.246640727f,
                        1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f,
                        0.00573950773f, -0.0076224613f, 0.00943887047f, 1.00167406f,
                        2.83297682f};
  const float w0 = -xla_log1p(__fmul_rn(-x, x));
  const bool lt = w0 < 5.0f;
  const float w = lt ? __fsub_rn(w0, 2.5f) : __fsub_rn(__fsqrt_rn(w0), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = fma_f32(p, w, lt ? lt5[i] : ge5[i]);
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7f800000));
  return __fmul_rn(p, x);
}

enum Mode { kBits = 0, kUniform = 1, kNormal = 2 };

__global__ void threefry_draw_kernel(const long long* __restrict__ keys, long long m,
                                     long long total, int mode, float lo, float hi,
                                     void* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long k = idx / m;
  const unsigned long long j = static_cast<unsigned long long>(idx - k * m);
  uint32_t x0 = static_cast<uint32_t>(j >> 32), x1 = static_cast<uint32_t>(j);
  threefry2x32(static_cast<uint32_t>(keys[2 * k]), static_cast<uint32_t>(keys[2 * k + 1]), x0, x1);
  const uint32_t bits = x0 ^ x1;
  if (mode == kBits) {
    static_cast<long long*>(out)[idx] = static_cast<long long>(bits);
    return;
  }
  const float unit = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float u = fmaxf(fma_f32(unit, __fsub_rn(hi, lo), lo), lo);
  static_cast<float*>(out)[idx] =
      mode == kUniform ? u : __fmul_rn(1.41421354f, xla_erfinv(u));
}

}  // namespace

extern "C" {

// Draw n_keys x m numbers into `out` (int64 bits for mode 0, float32
// uniforms on [lo, hi) for mode 1, float32 normals for mode 2) on `stream`,
// without synchronising; returns the cudaError_t of the launch (0 on
// success). `keys` holds n_keys pairs of uint32 words as int64.
int wgg_threefry_draw(const long long* keys, int n_keys, long long m, int mode, float lo,
                      float hi, void* out, cudaStream_t stream) {
  if (n_keys < 1 || m < 1 || mode < kBits || mode > kNormal)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n_keys) * m;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  threefry_draw_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      keys, m, total, mode, lo, hi, out);
  return static_cast<int>(cudaGetLastError());
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
