// The models' bias adds for Hopper (sm_90a): out = y + b, with b broadcast
// over y's leading dimensions, and out = residual + (y + b), the residual
// add of a transformer block folded into the same pass.
//
// Replaces no TPU kernel: the JAX package writes `x @ w + b` and
// `h + (...)` as jnp ops that XLA fuses into their neighbours. The plain
// version, and the definition of every operation here, is
// wordgesture_gan_tpu_torch/ops/bias.py (`plain_add_bias`): `y + b`, then
// `residual + (y + b)`, one PyTorch kernel an add. PyTorch sends a
// broadcast operand (a stride of 0) to its generic elementwise kernel, which
// works out every element's offsets from the shape and loads 2 bytes at a
// time: about 40% of the card's bandwidth.
//
// Arithmetic: the chain's. Each add is float(a) + float(b) rounded once to
// the dtype (bfloat16: __float2bfloat16_rn of the float32 sum; float32:
// __fadd_rn), and the residual's add rounds again, as the chain's second
// kernel does; so the output equals the chain's bit for bit.
//
// Indexing: y, the residual and the output share one dense layout (the
// wrapper sees to it), and the kernel walks their storage in memory order.
// The element at memory offset o reads b[(o / s) % P], where P = b.numel()
// and s is y's memory stride of b's last dimension: s = 1 for rows (a dense
// bias, the positions), s = L for a convolution's channel-first output read
// through its (B, L, C) view.
//
// What bounds it: bytes. At the transformer's largest call, 131,072 tokens
// of the MLP's 256 features in bfloat16, it reads y and writes the output:
// 134 MB, 0.040 ms at 3.35 TB/s; a residual add reads 50% more and saves
// the chain's second pass, which read two tensors and wrote one. Design: a
// grid-stride loop over 16-byte vectors (8 bfloat16 or 4 float32) wherever
// the arrays are 16-byte aligned and the vectors tile the storage; an
// array off alignment, or a ragged length, runs the same loop one element
// at a time. Each lane of a vector reads its own bias element, which two
// divisions find for the vector's first lane and a carry steps along the
// rest. The grid's stride is made a multiple of the bias pattern's period
// where it can be, so a thread's lanes read the same bias elements on
// every turn of its loop: they are found once, held in registers, and the
// loop holds no index arithmetic beyond the pointer's step.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Kind { kVector = 0, kScalar = 1 };

struct F32 {
  using T = float;
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
};

struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T add(T a, T b) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

// V elements, loaded and stored as one access of V * sizeof(T) bytes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int K>
__host__ __device__ constexpr int width() {
  return K == kVector ? 16 / static_cast<int>(sizeof(T)) : 1;
}

// The bias of each lane of unit i, elements i * V to i * V + V - 1, where
// element e reads b[(e / s) % p]: two divisions in the index type I (32
// bits where the storage allows: a 64-bit division is emulated in ~70
// instructions) for the first lane, a carry along the rest.
template <typename T, int V, typename I>
__device__ __forceinline__ Vec<T, V> lanes(const T* __restrict__ b, long long i, long long s,
                                           long long p) {
  const I e = static_cast<I>(i * V);
  const I q = e / static_cast<I>(s);
  I rem = e - q * static_cast<I>(s);
  I k = q % static_cast<I>(p);
  Vec<T, V> out;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    out.v[j] = b[k];
    if (++rem == static_cast<I>(s)) {
      rem = 0;
      if (++k == static_cast<I>(p)) k = 0;
    }
  }
  return out;
}

// out = y + b (+ r first: r + (y + b)) over `units` vectors of width<T, K>;
// with `fixed` every unit a thread visits has the lanes' bias of its first;
// `narrow`: every element offset fits 32 bits.
template <typename A, int K, bool R>
__global__ void __launch_bounds__(kThreads)
bias_kernel(const typename A::T* __restrict__ y, const typename A::T* __restrict__ b,
            const typename A::T* __restrict__ r, typename A::T* __restrict__ out, long long units,
            long long s, long long p, bool fixed, bool narrow) {
  using T = typename A::T;
  constexpr int V = width<T, K>();
  using U = Vec<T, V>;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  U bias;
  for (long long i = first; i < units; i += stride) {
    // y and r in flight while the bias is found.
    const U a = reinterpret_cast<const U*>(y)[i];
    const U c = R ? reinterpret_cast<const U*>(r)[i] : a;
    if (i == first || !fixed)
      bias = narrow ? lanes<T, V, unsigned int>(b, i, s, p) : lanes<T, V, long long>(b, i, s, p);
    U o;
#pragma unroll
    for (int j = 0; j < V; ++j) o.v[j] = A::add(a.v[j], bias.v[j]);
    if constexpr (R) {
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = A::add(c.v[j], o.v[j]);
    }
    reinterpret_cast<U*>(out)[i] = o;
  }
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename A, int K, bool R>
int launch(const void* y, const void* b, const void* r, void* out, long long n, long long s,
           long long p, int max_blocks, cudaStream_t stream) {
  using T = typename A::T;
  constexpr int V = width<T, K>();
  const long long units = n / V;
  // Units after which the lanes' bias elements repeat: s * p elements.
  const long long period = s * p / gcd(s * p, V);
  const long long wanted = (units + kThreads - 1) / kThreads;
  long long blocks = max_blocks;
  bool fixed = false;
  if (wanted <= max_blocks) {
    blocks = wanted;    // one unit a thread
    fixed = true;
  } else {
    const long long step = period / gcd(period, kThreads);   // blocks a multiple of it
    if (step <= max_blocks) {
      blocks = max_blocks / step * step;
      fixed = true;
    }
  }
  bias_kernel<A, K, R><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(b), static_cast<const T*>(r),
      static_cast<T*>(out), units, s, p, fixed, n <= 0xFFFFFFFFll);
  return static_cast<int>(cudaGetLastError());
}

template <typename A, bool R>
int launch_kind(int kind, const void* y, const void* b, const void* r, void* out, long long n,
                long long s, long long p, int max_blocks, cudaStream_t stream) {
  if (kind == kVector) return launch<A, kVector, R>(y, b, r, out, n, s, p, max_blocks, stream);
  return launch<A, kScalar, R>(y, b, r, out, n, s, p, max_blocks, stream);
}

template <typename A>
int launch_dtype(int kind, const void* y, const void* b, const void* r, void* out, long long n,
                 long long s, long long p, int max_blocks, cudaStream_t stream) {
  if (r != nullptr) return launch_kind<A, true>(kind, y, b, r, out, n, s, p, max_blocks, stream);
  return launch_kind<A, false>(kind, y, b, r, out, n, s, p, max_blocks, stream);
}

}  // namespace

extern "C" {

// Which loop a call takes (kVector 0, kScalar 1): 16-byte vectors when y, r
// and out are 16-byte aligned and n is a whole number of vectors.
int wgg_bias_kind(int dtype, const void* y, const void* r, const void* out, long long n) {
  const long long v = dtype == 1 ? 8 : 4;
  const bool aligned = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  return aligned && n % v == 0 ? kVector : kScalar;
}

// out = y + b[(o / s) % p] at every memory offset o < n of y's storage, or
// r + (y + b[...]) with `r` not null; y, r and out in one layout, b
// contiguous with p elements, n a multiple of p; dtype 0 float32, 1
// bfloat16; at most `max_blocks` blocks of 256 threads. Runs on `stream`
// without synchronising; returns the cudaError_t of the launch (0 on
// success), cudaErrorInvalidValue for arguments it does not take.
int wgg_bias(int dtype, const void* y, const void* b, const void* r, void* out, long long n,
             long long s, long long p, int max_blocks, cudaStream_t stream) {
  if (n < 1 || s < 1 || p < 1 || n % p || max_blocks < 1 || y == nullptr || b == nullptr ||
      out == nullptr || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kind = wgg_bias_kind(dtype, y, r, out, n);
  if (dtype == 0) return launch_dtype<F32>(kind, y, b, r, out, n, s, p, max_blocks, stream);
  return launch_dtype<BF16>(kind, y, b, r, out, n, s, p, max_blocks, stream);
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
