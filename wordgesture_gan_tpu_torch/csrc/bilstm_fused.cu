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
// 4 layers) the stack is ~24 GFLOP and ~13 MB of compulsory traffic: ~25 us
// on the bf16 tensor cores (0.36 ms on the fp32 CUDA cores) and ~4 us of HBM
// time. Neither is the limit. The recurrence is a chain of layers x L = 512
// dependent steps, so the time of one step, times 512, is the kernel's time,
// and the design is about what is left on that chain.
//
// Three kernels, chosen by the wrapper from the dtype and the shape alone
// (ops/bilstm_fused.py:kernel_path):
//
// A. `bilstm_fused_mma_kernel<HT>`: bf16 at H = 16 HT in {16, 32, 48}. The
//    tensor-core step of bilstm_step.cuh, the one the training forward
//    (bilstm_train.cu) runs, without its residual rows:
//   * one CTA owns 8 samples (the n of `mma.sync.m16n8k16`) through all
//     layers, both directions, so nothing is synchronised between CTAs;
//   * W_hh stays in the chain warps' registers as A fragments for the whole
//     layer; a step of the chain is: take the position's gate sums from the
//     ring, h fragments from shared memory, HT x 4 `mma`, the cell update, h
//     back to shared memory (double-buffered), one named barrier per
//     direction;
//   * the input projection is off the chain: producer warps compute
//     x_t . W_ih + b (layer 1: z . W_z + b once in fp32, then two multiply-adds
//     per position) kGxStages positions ahead and hand the sums over through
//     an mbarrier ring;
//   * no residual staging: the chain threads store h straight to global
//     memory with 32-bit stores. The rows of the layers under the top one go
//     through two scratch buffers that alternate by layer, laid out
//     [tile][position][sample][2H] so a CTA's 192 KB stay together and L2
//     resident and the producers' B-fragment loads are two 32-bit words per
//     k-tile; the tile's last samples past the batch are computed from zeros
//     and stay in the scratch. The top layer writes `out` (B, L, 2H);
//   * grid: ceil(B / 8) CTAs of 128 HT threads, one per SM by registers.
//     B=512 is 64 CTAs on 132 SMs, the train step's 2B=1024 call 128 CTAs
//     (one wave), B=2048 two waves. The tile is not shrunk to fill the card
//     at B=512: the chain is latency bound, so 64 CTAs lose nothing.
//
// B. `bilstm_fused_fp32_kernel<HT, S>`: float32 at the same H, full float32
//    products on the CUDA cores (no TF32), expf / tanhf. Its body is
//    bilstm_step.cuh's `fp32_stack`, which the float32 training forward
//    (bilstm_train.cu) runs too, with residual rows. The same structure as A
//    where the hardware allows:
//   * a cluster of two CTAs owns a tile of S samples (8, or 4 for a small
//     batch), one direction per CTA, so a layer's weights fit in the
//     registers of one SM: 4H chain threads and 4H producer threads per CTA;
//   * thread (unit, quarter) holds the unit's four gate rows of W_hh over a
//     quarter of k (H registers; the producers W_ih over a quarter of its 2H
//     rows, 2H registers): one 16-byte broadcast load of h or x from shared
//     memory feeds 16 multiply-adds. Two shuffle rounds add the four quarters
//     and leave each thread the four gates of its unit for S / 4 samples, so
//     the cell update needs no further exchange; sums are added in a fixed
//     order;
//   * only h . W_hh is on the chain; the producers run kGxStages positions
//     ahead through the same kind of mbarrier ring; their x rows (the layer
//     below, both directions) arrive by one bulk copy per position into a
//     second ring, so no thread waits on L2;
//   * the rows pass between layers through the two alternating scratch
//     buffers in [tile][position][sample][2H] float32; the two CTAs of a
//     cluster write disjoint halves of a row and meet at a cluster barrier at
//     each layer boundary;
//   * weights in registers rather than shared memory: both directions' W_hh
//     and W_ih in float32 are 221 KB at H=48, which leaves no room for the
//     rings, and a register operand costs no load slot on the chain.
//
// C. `bilstm_fused_kernel<T>`: every other shape (any H <= 256, either
//    dtype), the first version of this port: one CTA owns a 4-sample tile
//    through all layers; thread (dir, unit) computes the unit's four gates
//    for two samples; weights are re-read through L1 every step and the input
//    projection sits on the chain, which sets its speed (about 12,000 clocks
//    a step at H=48 on an H100).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilstm_step.cuh"

namespace {

using namespace wgg;

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


// ===========================================================================
// A. The tensor-core kernel: bf16, H = 16 * HT (HT = 1, 2, 3).
// ===========================================================================

template <int HT>
constexpr size_t fused_mma_smem_bytes() {
  constexpr int H = 16 * HT;
  return (size_t)2 * kGxStages * HT * 128 * 16        // gx ring (float4)
         + (size_t)2 * 2 * kSampleTile * (H + 8) * 2  // h tiles
         + (size_t)4 * kGxStages * 8;                 // mbarriers
}

// One CTA = 8 samples through all layers; per direction HT chain warps (the
// recurrence) and HT producer warps (the input projection, kGxStages
// positions ahead).
//   proto (B, L, 2) bf16; z (B, Z) f32; wq / wf: the packed weights in bf16
//   and f32; out (B, L, 2H) bf16; scratch (min(layers - 1, 2), tiles, L, 8, 2H)
//   bf16, tiles = gridDim.x.
template <int HT>
__global__ void __launch_bounds__(128 * HT, 1)
    bilstm_fused_mma_kernel(const bf16* __restrict__ proto, const float* __restrict__ z,
                            const bf16* __restrict__ wq, const float* __restrict__ wf, bf16* out,
                            bf16* scratch, int B, int L, int Z, int layers) {
  constexpr int H = 16 * HT, HS = H + 8, R = kGxStages;
  constexpr int kDirThreads = 32 * HT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float4* gx = reinterpret_cast<float4*>(smem_raw);                              // [2][R][HT][4][32]
  bf16* hs = reinterpret_cast<bf16*>(gx + 2 * R * HT * 128);                     // [2][2][8][HS]
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * 2 * kSampleTile * HS);   // [2][R]
  uint64_t* empty = full + 2 * R;                                                // [2][R]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int dir = wid / (2 * HT);
  const int within = wid % (2 * HT);
  const bool producer = within >= HT;
  const int w = within % HT;
  const int r = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * kSampleTile;
  // A tile's rows in one scratch buffer, and one buffer.
  const size_t tile_rows = (size_t)L * kSampleTile * 2 * H;
  const size_t buffer = (size_t)gridDim.x * tile_rows;

  if (tid == 0) {
    for (int i = 0; i < 2 * R; ++i) {
      mbar_init(full + i, kDirThreads);
      mbar_init(empty + i, kDirThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float4* gx_d = gx + (size_t)dir * R * HT * 128;
  uint64_t* full_d = full + dir * R;
  uint64_t* empty_d = empty + dir * R;
  for (int layer = 0; layer < layers; ++layer) {
    const CellOffsets off = cell_offsets(layer, dir, H, Z);
    const int it0 = layer * L;
    // Layer k under the top writes buffer k & 1 and reads buffer (k - 1) & 1.
    bf16* dst = scratch + (size_t)(layer & 1) * buffer + blockIdx.x * tile_rows;
    const bf16* src = scratch + (size_t)((layer + 1) & 1) * buffer + blockIdx.x * tile_rows;
    if (producer) {
      // ---- the input projection of this layer, in the chain's order ----
      if (layer == 0) {
        produce_first_layer<HT>(proto, z, wq, wf, off, b0, B, L, Z, dir, w, lane, gx_d, full_d,
                                empty_d, it0);
      } else {
        // x^T fragments: sample r's [fwd | bwd] row of the layer below, features
        // 16kt + {2q, 2q+1, 2q+8, 2q+9}. Read at L2: another layer's reads may
        // have left older lines of this buffer in L1.
        produce_upper_layer<HT>(
            wq, wf, off, L, dir, w, lane, gx_d, full_d, empty_d, it0,
            [&](int pos, uint32_t (&bx)[2 * HT][2]) {
              const uint32_t* row = reinterpret_cast<const uint32_t*>(
                                        src + ((size_t)pos * kSampleTile + r) * 2 * H) + q;
#pragma unroll
              for (int kt = 0; kt < 2 * HT; ++kt) {
                bx[kt][0] = __ldcg(row + kt * 8);
                bx[kt][1] = __ldcg(row + kt * 8 + 4);
              }
            });
      }
    } else {
      // ---- the recurrence ----
      const bool top = layer == layers - 1;
      uint32_t a[4][HT][4];
      load_gate_fragments<HT>(a, wq + off.w_hh, H, 16 * w, lane);
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      bf16* hs_d = hs + dir * 2 * kSampleTile * HS;
      for (int i = w * 32 + lane; i < kSampleTile * HS; i += kDirThreads)
        hs_d[i] = __float2bfloat16_rn(0.0f);
      named_barrier(1 + dir, kDirThreads);
      const int unit = 16 * w + 2 * r;  // and unit + 1: pairs j and j + 2
      for (int t = 0; t < L; ++t) {
        const int pos = dir ? L - 1 - t : t;
        float acc[4][4];
        gx_take<HT>(gx_d, full_d, empty_d, it0 + t, w, lane, acc);
        uint32_t bh[HT][2];
        load_h_fragments<HT>(bh, hs_d + (t & 1) * kSampleTile * HS, lane);
        gate_product<HT>(acc, a, bh);
        bf16 h[4];
        lstm_cell(acc, c, h);
        bf16* hn = hs_d + ((t + 1) & 1) * kSampleTile * HS;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 2 * q + e;
          const uint32_t hh = pack_bf16(h[e], h[e + 2]);
          *reinterpret_cast<uint32_t*>(hn + s * HS + unit) = hh;
          if (!top)
            *reinterpret_cast<uint32_t*>(dst + ((size_t)pos * kSampleTile + s) * 2 * H + dir * H +
                                         unit) = hh;
          else if (b0 + s < B)
            *reinterpret_cast<uint32_t*>(out + ((size_t)(b0 + s) * L + pos) * 2 * H + dir * H +
                                         unit) = hh;
        }
        named_barrier(1 + dir, kDirThreads);
      }
    }
    __threadfence();
    __syncthreads();  // the layer above reads both directions at every position
  }
}

template <int HT>
int launch_mma(const void* proto, const float* z, const void* wq, const float* wf, void* out,
               void* scratch, int B, int L, int Z, int layers, cudaStream_t stream) {
  const size_t smem = fused_mma_smem_bytes<HT>();
  cudaError_t err = cudaFuncSetAttribute(bilstm_fused_mma_kernel<HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + kSampleTile - 1) / kSampleTile;
  bilstm_fused_mma_kernel<HT><<<tiles, 128 * HT, smem, stream>>>(
      static_cast<const bf16*>(proto), z, static_cast<const bf16*>(wq), wf,
      static_cast<bf16*>(out), static_cast<bf16*>(scratch), B, L, Z, layers);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// B. The float32 kernel: H = 16 * HT, S samples per cluster of two CTAs.
// ===========================================================================

// The shared float32 recurrence (bilstm_step.cuh: fp32_stack) without residual rows.
template <int HT, int S>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(128 * HT, 1)
    bilstm_fused_fp32_kernel(const float* __restrict__ proto, const float* __restrict__ z,
                             const float* __restrict__ wf, float* out, float* scratch, int B,
                             int L, int Z, int layers) {
  fp32_stack<HT, S, false>(proto, z, wf, out, scratch, nullptr, B, L, Z, layers);
}

template <int HT, int S>
constexpr size_t fused_fp32_smem_bytes() {
  return fp32_stack_smem_bytes<HT, S, false>();
}

template <int HT, int S>
int launch_fp32(const float* proto, const float* z, const float* wf, float* out, float* scratch,
                int B, int L, int Z, int layers, cudaStream_t stream) {
  const size_t smem = fused_fp32_smem_bytes<HT, S>();
  cudaError_t err = cudaFuncSetAttribute(bilstm_fused_fp32_kernel<HT, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + S - 1) / S;
  bilstm_fused_fp32_kernel<HT, S><<<2 * tiles, 128 * HT, smem, stream>>>(proto, z, wf, out,
                                                                        scratch, B, L, Z, layers);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int L, int H, int Z, int layers) {
  return B < 1 || L < 1 || H < 1 || Z < 0 || layers < 1;
}

}  // namespace

extern "C" {

// The general kernel. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch (0 on success); cudaErrorInvalidValue for a shape
// it does not take (H > 256: 2H threads per sample group). Every kernel here
// runs on `stream` and is not synchronised; every buffer is the caller's.
int wgg_bilstm_fused_fwd(const void* proto, const float* z, const void* wseq1, const float* wz,
                         const void* whh, const void* wih, const float* bias, void* out,
                         void* scratch, int B, int L, int H, int Z, int layers, int dtype,
                         void* stream) {
  if (bad_shape(B, L, H, Z, layers) || 2 * H * kSampleGroups > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(proto, z, wseq1, wz, whh, wih, bias, out, scratch, B, L, H, Z, layers, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(proto, z, wseq1, wz, whh, wih, bias, out, scratch, B, L, H, Z,
                                 layers, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bfloat16 only, H in {16, 32, 48} (the wrapper's
// dispatch rule; anything else returns cudaErrorInvalidValue). wq / wf are the
// packed weights (bilstm_step.cuh) in bf16 and f32; scratch holds
// min(layers - 1, 2) buffers of (ceil(B / 8), L, 8, 2H) bf16.
int wgg_bilstm_fused_fwd_mma(const void* proto, const float* z, const void* wq, const float* wf,
                             void* out, void* scratch, int B, int L, int H, int Z, int layers,
                             void* stream) {
  if (bad_shape(B, L, H, Z, layers)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 16) return launch_mma<1>(proto, z, wq, wf, out, scratch, B, L, Z, layers, s);
  if (H == 32) return launch_mma<2>(proto, z, wq, wf, out, scratch, B, L, Z, layers, s);
  if (H == 48) return launch_mma<3>(proto, z, wq, wf, out, scratch, B, L, Z, layers, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 kernel: H in {16, 32, 48}, `tile` = 4 or 8 samples per cluster
// (the wrapper's rule); scratch holds min(layers - 1, 2) buffers of
// (ceil(B / tile), L, tile, 2H) f32.
int wgg_bilstm_fused_fwd_fp32(const float* proto, const float* z, const float* wf, float* out,
                              float* scratch, int B, int L, int H, int Z, int layers, int tile,
                              void* stream) {
  if (bad_shape(B, L, H, Z, layers)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGG_FP32(HT)                                                                      \
  {                                                                                       \
    if (tile == 8) return launch_fp32<HT, 8>(proto, z, wf, out, scratch, B, L, Z, layers, s); \
    if (tile == 4) return launch_fp32<HT, 4>(proto, z, wf, out, scratch, B, L, Z, layers, s); \
  }
  if (H == 16) WGG_FP32(1)
  if (H == 32) WGG_FP32(2)
  if (H == 48) WGG_FP32(3)
#undef WGG_FP32
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per CTA (info[0]), threads per CTA (info[1]) and
// resident CTAs per SM (info[2]) of a kernel at this H: 0 = tensor-core,
// 1 = float32 with 8 samples per cluster, 2 = float32 with 4. Returns a
// cudaError_t.
int wgg_bilstm_fused_info(int H, int kernel, int* info) {
#define WGG_INFO(FN, SMEM, THREADS)                                                        \
  {                                                                                        \
    info[0] = (int)(SMEM);                                                                 \
    info[1] = (THREADS);                                                                   \
    cudaError_t err =                                                                      \
        cudaFuncSetAttribute(FN, cudaFuncAttributeMaxDynamicSharedMemorySize, info[0]);    \
    if (err == cudaSuccess)                                                                \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], FN, info[1], info[0]); \
    return static_cast<int>(err);                                                          \
  }
#define WGG_INFO_HT(HT)                                                                     \
  {                                                                                         \
    if (kernel == 0) WGG_INFO(bilstm_fused_mma_kernel<HT>, fused_mma_smem_bytes<HT>(), 128 * HT) \
    if (kernel == 1)                                                                        \
      WGG_INFO((bilstm_fused_fp32_kernel<HT, 8>), (fused_fp32_smem_bytes<HT, 8>()), 128 * HT)   \
    if (kernel == 2)                                                                        \
      WGG_INFO((bilstm_fused_fp32_kernel<HT, 4>), (fused_fp32_smem_bytes<HT, 4>()), 128 * HT)   \
  }
  if (H == 16) WGG_INFO_HT(1)
  if (H == 32) WGG_INFO_HT(2)
  if (H == 48) WGG_INFO_HT(3)
#undef WGG_INFO_HT
#undef WGG_INFO
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
