// Fused whole-stack BiLSTM inference forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of wordgesture_gan_tpu/ops/bilstm_fused.py
// (launched by `_fused_call`, wrapped by `fused_bilstm_fwd`): every layer and
// both directions of the generator's stacked bidirectional LSTM in one launch.
// Same function and the same casting contract as that kernel:
//   * gate order i, f, g, o; zero initial state;
//   * layer 1 reads the 2-d prototype plus a time-constant gate base, the
//     static latent z projected once in float32 (fp32 z, fp32 weights);
//   * layers >= 2 read the layer below's [fwd | bwd] hidden rows;
//   * gate sums, nonlinearities and the cell state c are float32; h is
//     rounded to the compute dtype T (float or bf16) every step;
//   * sequence weights are T, biases float32.
// Output: the last layer's (B, L, 2H) hidden rows in T.
//
// What bounds it on this card. At the serving shape (B=512, L=128, H=48,
// 4 layers) the stack is ~24 GFLOP and ~13 MB of compulsory traffic, i.e.
// ~25 us on the bf16 tensor cores and ~4 us of HBM time. Neither is the
// limit: the recurrence is a chain of 4 x 128 dependent steps, each a small
// (4H x 3H) by (3H x tile) product followed by the gate nonlinearities, and
// every step of every CTA reads its layer's weights again (110 KB in bf16,
// 221 KB in fp32). So this first version is bound by the load path from
// L1/L2 into the FMA units and by the per-step barrier latency.
//
// Design (simple and right first):
//   * one CTA owns a tile of samples for ALL layers, so layer k+1 needs no
//     cross-CTA synchronisation to see both directions of layer k;
//   * threadIdx.x = dir * H + unit: one thread computes the four gates of one
//     hidden unit of one direction for kSamplesPerThread samples, so the
//     cell update needs no gate exchange, and each weight load serves
//     several samples; threadIdx.y splits the tile into sample groups;
//   * the two directions advance together (forward at t, backward at L-1-t);
//   * weights are laid out (input row, dir, unit, gate) so one thread's four
//     gate weights are one 16-byte (fp32) or 8-byte (bf16) load and a warp's
//     loads are contiguous; they are read through the read-only cache, which
//     the launcher asks to be as large as possible (shared memory use is a
//     few KB: this step's input rows and the previous h, as float);
//   * the layer below's hidden rows go through a global buffer: the last
//     layer writes `out`, the layers under it alternate between `scratch`
//     and `out`, and each CTA only reads rows of its own tile.
// Later versions: weights resident in shared memory and the step product on
// the tensor cores (wgmma), as ROADMAP.md queues.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSamplesPerThread = 2;
constexpr int kSampleGroups = 2;  // blockDim.y

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The four gate weights (i, f, g, o) of one unit, stored contiguously.
__device__ __forceinline__ void load_gates(const float* p, float w[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void load_gates(const __nv_bfloat16* p, float w[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// Shapes (all contiguous):
//   proto   (B, L, 2)            T     prototype (x, y)
//   z       (B, Z)               f32   static latent
//   wseq1   (2, 2, H, 4)         T     layer-1 prototype weights (coord, dir, unit, gate)
//   wz      (Z, 2, H, 4)         f32   layer-1 latent weights
//   whh     (layers, H, 2, H, 4) T     recurrent weights
//   wih     (layers-1, 2H, 2, H, 4) T  input weights of layers >= 2
//   bias    (layers, 2, H, 4)    f32   b_ih + b_hh
//   out, scratch (B, L, 2H)      T
template <typename T>
__global__ void bilstm_fused_kernel(const T* __restrict__ proto, const float* __restrict__ z,
                                    const T* __restrict__ wseq1, const float* __restrict__ wz,
                                    const T* __restrict__ whh, const T* __restrict__ wih,
                                    const float* __restrict__ bias, T* out, T* scratch, int B,
                                    int L, int H, int Z, int layers) {
  constexpr int S = kSamplesPerThread;
  const int two_h = 2 * H;
  const int unit = threadIdx.x;  // dir * H + j
  const int dir = unit / H;
  const int tile = blockDim.y * S;  // samples per CTA
  const int b0 = blockIdx.x * tile;
  const int lb = threadIdx.y * S;  // this thread's first sample within the tile
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  extern __shared__ float smem[];
  float* xin = smem;                   // (2 dirs, 2H, tile): this step's input rows
  float* hs = smem + 2 * two_h * tile;  // (2 dirs, H, tile) = (2H, tile): previous h

  for (int layer = 0; layer < layers; ++layer) {
    T* dst = ((layers - 1 - layer) & 1) ? scratch : out;
    const T* src = ((layers - layer) & 1) ? scratch : out;  // the layer below's dst
    const T* w_in = wih + (size_t)(layer > 0 ? layer - 1 : 0) * two_h * two_h * 4;
    const T* w_hh = whh + (size_t)layer * H * two_h * 4;

    // Time-constant gate base: layer 1 adds the latent projection.
    float base[4][S];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int s = 0; s < S; ++s) base[g][s] = 0.0f;
    float wp[2][4];
    if (layer == 0) {
      for (int k = 0; k < Z; ++k) {
        float w[4];
        load_gates(wz + ((size_t)k * two_h + unit) * 4, w);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int b = b0 + lb + s;
          const float zv = b < B ? __ldg(z + (size_t)b * Z + k) : 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g) base[g][s] = fmaf(w[g], zv, base[g][s]);
        }
      }
      load_gates(wseq1 + (size_t)unit * 4, wp[0]);
      load_gates(wseq1 + ((size_t)two_h + unit) * 4, wp[1]);
    }
    {
      float bv[4];
      load_gates(bias + ((size_t)layer * two_h + unit) * 4, bv);
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int s = 0; s < S; ++s) base[g][s] += bv[g];
    }

    float c[S];
#pragma unroll
    for (int s = 0; s < S; ++s) c[s] = 0.0f;
    for (int i = tid; i < two_h * tile; i += nthreads) hs[i] = 0.0f;

    for (int t = 0; t < L; ++t) {
      const int tt = dir ? L - 1 - t : t;  // this thread's time index
      if (layer > 0) {
        // Stage both directions' input rows for this step.
        const int n = 2 * tile * two_h;
        for (int i = tid; i < n; i += nthreads) {
          const int k = i % two_h;
          const int r = i / two_h;
          const int s = r % tile;
          const int d = r / tile;
          const int b = b0 + s;
          const int ts = d ? L - 1 - t : t;
          xin[(d * two_h + k) * tile + s] =
              b < B ? to_float(src[((size_t)b * L + ts) * two_h + k]) : 0.0f;
        }
      }
      __syncthreads();  // xin staged, hs holds the previous step's h

      float acc[4][S];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[g][s] = base[g][s];

      if (layer == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int b = b0 + lb + s;
          float p0 = 0.0f, p1 = 0.0f;
          if (b < B) {
            const T* p = proto + ((size_t)b * L + tt) * 2;
            p0 = to_float(p[0]);
            p1 = to_float(p[1]);
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            acc[g][s] = fmaf(wp[0][g], p0, acc[g][s]);
            acc[g][s] = fmaf(wp[1][g], p1, acc[g][s]);
          }
        }
      } else {
        const float* x = xin + dir * two_h * tile + lb;
#pragma unroll 4
        for (int k = 0; k < two_h; ++k) {
          float w[4];
          load_gates(w_in + ((size_t)k * two_h + unit) * 4, w);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float xv = x[k * tile + s];
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[g][s] = fmaf(w[g], xv, acc[g][s]);
          }
        }
      }

      const float* hp = hs + dir * H * tile + lb;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        float w[4];
        load_gates(w_hh + ((size_t)k * two_h + unit) * 4, w);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float hv = hp[k * tile + s];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][s] = fmaf(w[g], hv, acc[g][s]);
        }
      }
      __syncthreads();  // every read of xin and hs for this step is done

#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float ig = sigmoid_f(acc[0][s]);
        const float fg = sigmoid_f(acc[1][s]);
        const float gg = tanhf(acc[2][s]);
        const float og = sigmoid_f(acc[3][s]);
        c[s] = fg * c[s] + ig * gg;
        const T h = from_float<T>(og * tanhf(c[s]));
        hs[unit * tile + lb + s] = to_float(h);
        const int b = b0 + lb + s;
        if (b < B) dst[((size_t)b * L + tt) * two_h + unit] = h;
      }
    }
    __syncthreads();  // this layer's rows are written before the next layer reads them
  }
}

template <typename T>
int launch(const void* proto, const float* z, const void* wseq1, const float* wz, const void* whh,
           const void* wih, const float* bias, void* out, void* scratch, int B, int L, int H, int Z,
           int layers, cudaStream_t stream) {
  const dim3 block(2 * H, kSampleGroups);
  const int tile = kSampleGroups * kSamplesPerThread;
  const dim3 grid((B + tile - 1) / tile);
  const size_t smem = (size_t)(2 * 2 * H + 2 * H) * tile * sizeof(float);
  // Shared memory holds only a few KB: leave the rest of the SM's memory to
  // the L1 cache that serves the weight reads.
  cudaFuncSetAttribute(bilstm_fused_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
                       0);
  bilstm_fused_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(proto), z, static_cast<const T*>(wseq1), wz,
      static_cast<const T*>(whh), static_cast<const T*>(wih), bias, static_cast<T*>(out),
      static_cast<T*>(scratch), B, L, H, Z, layers);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch
// (0 on success); cudaErrorInvalidValue for a shape it does not take
// (H > 256: 2H threads per sample group). The kernel runs on `stream` and
// is not synchronised.
int wgg_bilstm_fused_fwd(const void* proto, const float* z, const void* wseq1, const float* wz,
                         const void* whh, const void* wih, const float* bias, void* out,
                         void* scratch, int B, int L, int H, int Z, int layers, int dtype,
                         void* stream) {
  if (B < 1 || L < 1 || H < 1 || Z < 0 || layers < 1 || 2 * H * kSampleGroups > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(proto, z, wseq1, wz, whh, wih, bias, out, scratch, B, L, H, Z, layers, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(proto, z, wseq1, wz, whh, wih, bias, out, scratch, B, L, H, Z,
                                 layers, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
