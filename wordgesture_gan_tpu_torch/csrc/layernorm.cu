// The transformer generator's layer norm for Hopper (sm_90a): over the last
// dimension D of a (rows, D) array, one launch forward and two launches
// backward (a row pass and a fixed-order sum of its column partials).
//
// Replaces no TPU kernel: the JAX package writes the norm as jnp ops
// (models/generators.py `_layernorm`) that XLA fuses. The plain version, and
// the definition of every operation here, is
// wordgesture_gan_tpu_torch/ops/layernorm.py (`plain_layernorm`), which runs
// that chain op by op: a float32 copy of x, a mean, a subtract, a square, a
// second mean, rsqrt, a multiply, a cast back, a scale and a bias, one
// PyTorch kernel an op, each reading and writing a whole (rows, D) tensor.
//
// Arithmetic: the chain's, in its precision; only the sums run in another
// order, so a result may differ from the chain's in its last bit.
//   * forward: the row's moments in float32, the mean as the sum times the
//     float32 reciprocal of D (as PyTorch's mean on the card), the
//     population variance in two passes, mean((x - mean)^2), rsqrtf of the
//     variance plus eps; the normalized value (x - mean) * rstd rounded to
//     x's dtype, times the scale rounded, plus the bias rounded. Every
//     multiply and add is an _rn intrinsic, so in float32 no multiply is
//     contracted into an add that the chain runs as two kernels;
//   * backward, the closed form of the chain's gradient: dy = g * scale
//     rounded to the dtype (the chain's product), dx = rstd * (dy - mean(dy)
//     - xhat * mean(dy * xhat)) with xhat the forward's float32 normalized
//     value, rounded to the dtype; dbias the column sums of g and dscale
//     those of g * round(xhat) rounded to the dtype first (the chain's
//     product), both summed in float32 and rounded once.
//
// What bounds it: bytes. At the critic loop's call, 131,072 rows of D = 64
// in bfloat16, a forward reads x and writes its output, 33.5 MB: 0.010 ms
// at 3.35 TB/s (0.020 ms for the float32 final norm). A backward at the
// joint step's 65,536 rows reads x and g and writes dx: 25.2 MB, 0.0075 ms.
// The chain moved ~500 MB a forward. Design: a row lives in the registers
// of a group of `tpr` threads (a power of two up to a warp), each holding
// up to 32 elements as vectors of V elements (16 bytes where D allows); the
// group's sums are xor-butterfly shuffles, so every lane holds the same
// bits. The forward runs one row a group; the backward's blocks walk the
// rows with a stride and keep column partials in registers, fold them over
// the block's groups in a fixed order and write one partial a block; the
// second launch sums those in block order. No atomics: two launches give
// the same bits, and a captured CUDA graph replays them.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Op { kForward = 0, kBackward = 1 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDim = 1024;
constexpr int kMaxPerThread = 32;      // elements of a row a thread holds
constexpr int kSumCols = 32;           // the partials' sum: columns a block
constexpr int kSumSlices = 16;         // and partial rows summed apart

struct F32 {
  using T = float;
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float load(T v) { return v; }
  static __device__ __forceinline__ T store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float load(T v) { return __bfloat162float(v); }
  static __device__ __forceinline__ T store(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ float round(float v) { return load(store(v)); }
};

// V elements, loaded and stored as one access of V * sizeof(T) bytes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// The sum over a group of `tpr` lanes (a power of two, aligned in the warp);
// every lane of the group gets the same bits.
__device__ __forceinline__ float group_sum(float v, int tpr) {
  for (int off = tpr >> 1; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename A, int V, int NV>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const typename A::T* __restrict__ x, const typename A::T* __restrict__ scale,
                     const typename A::T* __restrict__ bias, typename A::T* __restrict__ out,
                     float* __restrict__ mean_out, float* __restrict__ rstd_out, long long rows,
                     int d, int tpr, float inv_d, float eps) {
  using T = typename A::T;
  using VecT = Vec<T, V>;
  const int nvec = d / V;
  const int lane = threadIdx.x & (tpr - 1);
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / tpr;
  const bool live = row < rows;
  const VecT* xr = reinterpret_cast<const VecT*>(x + (live ? row : 0) * d);
  float v[NV][V];
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = lane + k * tpr;
    if (live && j < nvec) {
      const VecT a = xr[j];
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = A::load(a.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) sum = __fadd_rn(sum, v[k][i]);
  }
  const float mean = __fmul_rn(group_sum(sum, tpr), inv_d);
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + k * tpr < nvec) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v[k][i] = __fsub_rn(v[k][i], mean);
        sq = __fadd_rn(sq, __fmul_rn(v[k][i], v[k][i]));
      }
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(group_sum(sq, tpr), inv_d), eps));
  if (!live) return;
  VecT* orow = reinterpret_cast<VecT*>(out + row * d);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = lane + k * tpr;
    if (j < nvec) {
      const VecT s = reinterpret_cast<const VecT*>(scale)[j];
      const VecT b = reinterpret_cast<const VecT*>(bias)[j];
      VecT o;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float n = A::round(__fmul_rn(v[k][i], rstd));
        const float y = A::round(__fmul_rn(n, A::load(s.v[i])));
        o.v[i] = A::store(__fadd_rn(y, A::load(b.v[i])));
      }
      orow[j] = o;
    }
  }
  if (lane == 0 && mean_out != nullptr) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Row pass of the backward: dx, and the block's column partials of g (dbias)
// and of g * round(xhat) (dscale) into partials[blockIdx.x][0:d] and [d:2d].
template <typename A, int V, int NV>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const typename A::T* __restrict__ x, const typename A::T* __restrict__ scale,
                     const typename A::T* __restrict__ g, const float* __restrict__ mean,
                     const float* __restrict__ rstd, typename A::T* __restrict__ dx,
                     float* __restrict__ partials, long long rows, int d, int tpr, float inv_d) {
  using T = typename A::T;
  using VecT = Vec<T, V>;
  __shared__ float acc[2 * kMaxDim];
  const int nvec = d / V;
  const int lane = threadIdx.x & (tpr - 1);
  const int groups = kThreads / tpr;
  float s[NV][V], col_g[NV][V], col_gy[NV][V];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int j = lane + k * tpr;
    VecT sv;
    if (j < nvec) sv = reinterpret_cast<const VecT*>(scale)[j];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[k][i] = j < nvec ? A::load(sv.v[i]) : 0.0f;
      col_g[k][i] = col_gy[k][i] = 0.0f;
    }
  }
  // The loop's bounds are the block's alone, so its shuffles see every lane.
  for (long long base = static_cast<long long>(blockIdx.x) * groups; base < rows;
       base += static_cast<long long>(gridDim.x) * groups) {
    const long long row = base + threadIdx.x / tpr;
    const bool live = row < rows;
    const float m = live ? mean[row] : 0.0f;
    const float r = live ? rstd[row] : 0.0f;
    const VecT* xr = reinterpret_cast<const VecT*>(x + (live ? row : 0) * d);
    const VecT* gr = reinterpret_cast<const VecT*>(g + (live ? row : 0) * d);
    float n[NV][V], dy[NV][V];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = lane + k * tpr;
      if (live && j < nvec) {
        const VecT xv = xr[j], gv = gr[j];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float gf = A::load(gv.v[i]);
          n[k][i] = __fmul_rn(__fsub_rn(A::load(xv.v[i]), m), r);
          dy[k][i] = A::round(__fmul_rn(gf, s[k][i]));
          col_g[k][i] = __fadd_rn(col_g[k][i], gf);
          col_gy[k][i] = __fadd_rn(col_gy[k][i], A::round(__fmul_rn(gf, A::round(n[k][i]))));
          s1 = __fadd_rn(s1, dy[k][i]);
          s2 = __fadd_rn(s2, __fmul_rn(dy[k][i], n[k][i]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) n[k][i] = dy[k][i] = 0.0f;
      }
    }
    const float mean_dy = __fmul_rn(group_sum(s1, tpr), inv_d);
    const float mean_dyn = __fmul_rn(group_sum(s2, tpr), inv_d);
    if (!live) continue;
    VecT* dxr = reinterpret_cast<VecT*>(dx + row * d);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int j = lane + k * tpr;
      if (j < nvec) {
        VecT o;
#pragma unroll
        for (int i = 0; i < V; ++i)
          o.v[i] = A::store(__fmul_rn(r, __fsub_rn(__fsub_rn(dy[k][i], mean_dy),
                                                   __fmul_rn(n[k][i], mean_dyn))));
        dxr[j] = o;
      }
    }
  }
  // Fold the groups of a warp (lanes lane + m * tpr hold the same columns),
  // then the warps into shared memory, one after the other.
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      for (int off = tpr; off < 32; off <<= 1) {
        col_g[k][i] = __fadd_rn(col_g[k][i], __shfl_xor_sync(0xffffffffu, col_g[k][i], off));
        col_gy[k][i] = __fadd_rn(col_gy[k][i], __shfl_xor_sync(0xffffffffu, col_gy[k][i], off));
      }
    }
  }
  const int warp = threadIdx.x / 32;
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && (threadIdx.x & 31) < tpr) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int j = lane + k * tpr;
        if (j < nvec) {
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const int c = j * V + i;
            acc[c] = w ? __fadd_rn(acc[c], col_g[k][i]) : col_g[k][i];
            acc[d + c] = w ? __fadd_rn(acc[d + c], col_gy[k][i]) : col_gy[k][i];
          }
        }
      }
    }
    __syncthreads();
  }
  float* part = partials + static_cast<long long>(blockIdx.x) * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += kThreads) part[c] = acc[c];
}

// dbias and dscale: the `blocks` partials summed in block order (strided
// slices, then the slices in order), rounded once to the dtype.
template <typename A>
__global__ void __launch_bounds__(kSumCols * kSumSlices)
layernorm_bwd_sum_kernel(const float* __restrict__ partials, int blocks, int d,
                         typename A::T* __restrict__ dscale, typename A::T* __restrict__ dbias) {
  __shared__ float slice[kSumSlices][kSumCols];
  const int c = blockIdx.x * kSumCols + threadIdx.x;
  float sum = 0.0f;
  if (c < 2 * d)
    for (int p = threadIdx.y; p < blocks; p += kSumSlices)
      sum = __fadd_rn(sum, partials[static_cast<long long>(p) * 2 * d + c]);
  slice[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y != 0 || c >= 2 * d) return;
  float total = slice[0][threadIdx.x];
#pragma unroll
  for (int i = 1; i < kSumSlices; ++i) total = __fadd_rn(total, slice[i][threadIdx.x]);
  if (c < d)
    dbias[c] = A::store(total);
  else
    dscale[c - d] = A::store(total);
}

struct Args {
  const void* x;
  const void* scale;
  const void* bias;
  const void* g;
  void* out;
  float* mean;
  float* rstd;
  float* partials;
  void* dscale;
  void* dbias;
  long long rows;
  int d;
  int tpr;
  int sms;
  float eps;
  cudaStream_t stream;
};

template <typename A, int V, int NV>
int launch(int op, const Args& a) {
  using T = typename A::T;
  const float inv_d = 1.0f / static_cast<float>(a.d);
  if (op == kForward) {
    const long long blocks = (a.rows * a.tpr + kThreads - 1) / kThreads;
    layernorm_fwd_kernel<A, V, NV><<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.scale), static_cast<const T*>(a.bias),
        static_cast<T*>(a.out), a.mean, a.rstd, a.rows, a.d, a.tpr, inv_d, a.eps);
    return static_cast<int>(cudaGetLastError());
  }
  // As many blocks as stay resident (at most 8 a multiprocessor at 256
  // threads), fewer when the rows run out: a count fixed by the shape and
  // the card, so the sums' order is too.
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layernorm_bwd_kernel<A, V, NV>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int groups = kThreads / a.tpr;
  const long long wanted = (a.rows + groups - 1) / groups;
  const long long resident = static_cast<long long>(a.sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(wanted < resident ? wanted : resident);
  layernorm_bwd_kernel<A, V, NV><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale), static_cast<const T*>(a.g),
      a.mean, a.rstd, static_cast<T*>(a.out), a.partials, a.rows, a.d, a.tpr, inv_d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  layernorm_bwd_sum_kernel<A><<<(2 * a.d + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumSlices),
                                0, a.stream>>>(a.partials, blocks, a.d, static_cast<T*>(a.dscale),
                                               static_cast<T*>(a.dbias));
  return static_cast<int>(cudaGetLastError());
}

// The template of `nv` vectors a thread (a power of two, V * NV <= 32).
template <typename A, int V, int NV>
int launch_per_thread(int op, const Args& a, int nv) {
  if constexpr (V * NV > kMaxPerThread) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (nv == NV) return launch<A, V, NV>(op, a);
    return launch_per_thread<A, V, NV * 2>(op, a, nv);
  }
}

// The template of vector width `v` (elements, down from 16 bytes).
template <typename A, int V>
int launch_vec(int op, const Args& a, int v, int nv) {
  if (v == V) return launch_per_thread<A, V, 1>(op, a, nv);
  if constexpr (V > 1) return launch_vec<A, V / 2>(op, a, v, nv);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The thread layout read from D and the dtype: vectors of 16 bytes where D
// allows (else the widest power of two dividing D), `tpr` threads a row (the
// vectors' count rounded up to a power of two, at most 32), and each thread
// that many vectors more, rounded up to a power of two.
template <typename A>
int launch_dtype(int op, Args a) {
  int v = A::kVec;
  while (a.d % v) v /= 2;
  const int nvec = a.d / v;
  a.tpr = 1;
  while (a.tpr < nvec && a.tpr < 32) a.tpr *= 2;
  const int per = (nvec + a.tpr - 1) / a.tpr;
  int nv = 1;
  while (nv < per) nv *= 2;
  return launch_vec<A, A::kVec>(op, a, v, nv);
}

}  // namespace

extern "C" {

// op 0 (forward): out (rows, d) = the layer norm of x with scale and bias
// (each (d,)), and, unless `mean` is null, each row's float32 mean and rstd.
// op 1 (backward): from g, the forward's x, scale, mean and rstd: out = dx
// (rows, d), dscale and dbias (d,), through `partials`, float32 scratch of
// 8 * sms * 2 * d. dtype 0 float32, 1 bfloat16, for every array but the
// float32 statistics and partials; every array contiguous, x, g and out
// 16-byte aligned, scale and bias aligned to their element size times the
// vector width. 1 <= d <= 1024, rows >= 1. Runs on `stream` without
// synchronising; returns the cudaError_t of the launches (0 on success),
// cudaErrorInvalidValue for arguments it does not take,
// cudaErrorMisalignedAddress for an array off 16-byte alignment.
int wgg_layernorm(int op, int dtype, const void* x, const void* scale, const void* bias,
                  const void* g, void* out, float* mean, float* rstd, float* partials,
                  void* dscale, void* dbias, long long rows, int d, float eps, int sms,
                  cudaStream_t stream) {
  if (op < kForward || op > kBackward || rows < 1 || d < 1 || d > kMaxDim || sms < 1 ||
      x == nullptr || scale == nullptr || out == nullptr || (mean == nullptr) != (rstd == nullptr) ||
      (op == kForward && bias == nullptr) ||
      (op == kBackward && (g == nullptr || mean == nullptr || partials == nullptr ||
                           dscale == nullptr || dbias == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(out)) & 15u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Args a{x, scale, bias, g, out, mean, rstd, partials, dscale, dbias, rows, d, 0, sms,
               eps, stream};
  if (dtype == 0) return launch_dtype<F32>(op, a);
  if (dtype == 1) return launch_dtype<BF16>(op, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
