// Fused whole-stack BiLSTM training pair for Hopper (sm_90a): the forward
// with residual rows (kernel 2) and the backward-through-time (kernel 3).
//
// Replaces the TPU kernels of wordgesture_gan_tpu/ops/bilstm_train.py:
//   * `_fwd_kernel` (launched by `_fwd_call`): the inference recurrence of
//     ops/bilstm_fused.py that also writes, per (layer, direction, position),
//     the row [h | c | i | f | g | o] the backward needs;
//   * `_bwd_kernel` (launched by `_bwd_call`, tied in by the custom_vjp
//     `_train_core`): backprop through time, top layer down, both
//     directions; gate gradients from the residuals; dW_hh, dW_ih, db summed
//     over batch and time; dh through W_hh; the gradient of each layer's input
//     passed down; dz = W_z . sum_t dgates; the prototype gradient.
// Casting contract (the TPU pair's; ops/bilstm_train.py says it in full):
// forward as kernel 1 (fp32 gates and cell, h rounded to T each step, fp32
// latent base), every stored residual rounded to T; backward products in
// fp32 from T-rounded weights and residuals, the gradient passed down rounded
// to T per direction and the two directions added in T, dW/db/dz in fp32.
//
// What bounds it on this card. Neither bytes nor operations: at B=512 the
// forward moves 302 MB of residuals (~0.09 ms of HBM time) and does 24 GFLOP,
// the backward 48 GFLOP. Both are a chain of layers x L = 512 dependent steps
// (the forward's h and c, the backward's dh and dc carries), so the time of
// one step, times 512, is the kernel's time. The batch-wide sum of the weight
// gradients is the one part that is a real matrix product (a 65,536-row inner
// dimension at B=512).
//
// Three paths, chosen by the wrapper from the dtype and the shape alone
// (ops/bilstm_train.py:kernel_path):
//
// A. The tensor-core path: bf16, H in {16, 32, 48}. `*_mma_kernel` below and
//    the forward step in bilstm_step.cuh. What it does about the chain:
//   * samples are the narrow dimension of `mma.sync.m16n8k16` (bf16 in, fp32
//     accumulate), features the wide one: a CTA owns 8 samples through all
//     layers, both directions, so nothing is synchronised between CTAs; a
//     warp owns 16 hidden units of one direction, its accumulators holding
//     all four gates of the same (unit, sample) pairs;
//   * the layer's weights stay on chip for all L steps as A fragments in
//     registers (W_hh^T in the chain warps, W_ih^T / W_ih in the side warps),
//     built once per layer from the packed model-layout weights;
//   * only h . W_hh (forward) and dh = W_hh . dg (backward) are on the chain.
//     The input projection x_t . W_ih + b is produced up to kGxStages
//     positions ahead by producer warps and handed over in accumulator order
//     through an mbarrier ring; the backward's input gradient dx = W_ih . dg
//     is taken by side warps from the gate-gradient ring behind the chain;
//   * residual rows are staged in shared memory and written whole: one
//     `cp.async.bulk` of tile x 6H values per (layer, direction, position);
//     the backward loads each sample's row and its dy with bulk copies
//     kInStages positions ahead (c_prev is the next step's row); the layer
//     above reads h as 32-bit fragment loads of contiguous 2H-byte planes;
//   * the casting contract keeps the backward products in fp32: each fp32
//     gate gradient enters the tensor cores as hi = bf16(dg) and
//     lo = bf16(dg - hi), both products accumulated in fp32 (about 2^-17
//     relative); weights and residuals are exact in bf16. db, dz and the z
//     rows of dW_ih are summed from the fp32 values, the prototype's two rows
//     from hi + lo on the CUDA cores;
//   * the gate gradients are stored split, as (4H, 8 samples) bf16 tiles, hi
//     and lo. That one layout is the sweep's own B operand (through
//     `ldmatrix.trans`), one contiguous bulk store per step, and the B
//     fragment order of the weight-gradient product, whose left operand (h
//     planes of consecutive residual rows) is copied 16 bytes at a time with
//     zero fill past the ends and read through `ldmatrix.trans`: no
//     per-element gather. Partial sums (splits over positions, sample tiles)
//     are added in a fixed order by a last kernel: deterministic.
//
// B. The float32 path: float32, H in {16, 32, 48}. Full float32 products on
//    the CUDA cores (no TF32), on the float32 inference kernel's design
//    (bilstm_fused.cu, B.), which keeps a layer's weights on chip by giving
//    each direction its own CTA of a two-CTA cluster:
//   * the forward is that kernel's recurrence, one source for both
//     (bilstm_step.cuh: fp32_stack), plus the residual rows: each chain
//     thread stages its unit's [h | c | i | f | g | o] for its samples and
//     one lane a sample copies the rows out with bulk stores; the output is
//     bit-equal to kernel 1's;
//   * the sweep (`train_bwd_sweep_fp32_kernel`) runs the same shape of chain
//     in reverse: chain thread (unit, quarter) holds W_hh's row of its unit
//     against one gate's columns, so dh = W_hh . dg is four partial sums
//     added by the forward's two shuffle rounds, and nothing else is on the
//     chain; side threads hold W_ih (2H x 4H per direction, 2H registers a
//     thread) and take dx = W_ih . dg from the gate-gradient ring behind the
//     chain, copy each step's gate gradients out in one bulk store, and keep
//     the residual / dy ring full with bulk copies; the two CTAs write
//     disjoint input-gradient streams and meet at a cluster barrier per
//     layer;
//   * the weight gradients are a separate product
//     (`train_bwd_wgrad_fp32_kernel`): per (layer, direction, operand part,
//     split) [h planes]^T . dg over 16-byte cp.async copies, kFwStages deep,
//     4 x H/4 outputs a thread; the splits, and the sweep's per-tile bias,
//     prototype and z rows, are added in a fixed order by the tensor-core
//     path's last kernel: deterministic.
//
// C. The general path: any other H <= 256 in either dtype. CUDA cores,
//    every product in full fp32 (first version of these kernels):
//   * one CTA owns a tile of 4 samples through ALL layers, so the
//     recurrence carries, the input gradients passed between layers and dz
//     are per CTA and need no cross-CTA synchronisation;
//   * thread (dir, unit) owns the four gates of one hidden unit of one
//     direction for kSamplesPerThread samples; weights are re-read through L1
//     every step, which sets this path's speed;
//   * the gradient of layer k's input is stored per direction (two T
//     streams), so the two directions never write the same row; the layer
//     below adds the two in T when it reads them (ping-pong between layers);
//   * the weight gradients go in a second pass: the sweep writes the fp32
//     gate gradients to global memory, and a tiled split-K product reduces
//     [x | h_prev | 1]^T . dgates per layer and direction; the splits'
//     partial sums are added in a fixed order by a third kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilstm_step.cuh"

namespace {

using namespace wgg;

constexpr int kSamplesPerThread = 2;
constexpr int kSampleGroups = 2;  // blockDim.y of the recurrent kernels
// Weight-gradient product tile: 64 x 64 outputs, 32 rows of the sum per stage,
// 256 threads with 4 x 4 outputs each.
constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 32;
constexpr int kGemmThreads = 256;

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

// Round to T and back: the value a T store would keep.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

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

// ---------------------------------------------------------------------------
// Kernel 2: training forward.
//   proto (B, L, 2) T; z (B, Z) f32; wseq1 (2, 2, H, 4) T; wz (Z, 2, H, 4) f32;
//   whh (layers, H, 2, H, 4) T; wih (layers-1, 2H, 2, H, 4) T;
//   bias (layers, 2, H, 4) f32 (b_ih + b_hh) — kernel 1's layouts;
//   res (layers, 2, L, B, 6H) T; out (B, L, 2H) T (the top layer's h rows).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void train_fwd_kernel(const T* __restrict__ proto, const float* __restrict__ z,
                                 const T* __restrict__ wseq1, const float* __restrict__ wz,
                                 const T* __restrict__ whh, const T* __restrict__ wih,
                                 const float* __restrict__ bias, T* res, T* out, int B, int L,
                                 int H, int Z, int layers) {
  constexpr int S = kSamplesPerThread;
  const int two_h = 2 * H;
  const int unit = threadIdx.x;  // dir * H + j
  const int dir = unit / H;
  const int j = unit - dir * H;
  const int tile = blockDim.y * S;
  const int b0 = blockIdx.x * tile;
  const int lb = threadIdx.y * S;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  extern __shared__ float smem[];
  float* xin = smem;                    // (2 dirs, 2H, tile): this step's input rows
  float* hs = smem + 2 * two_h * tile;  // (2H, tile): previous h

  for (int layer = 0; layer < layers; ++layer) {
    const T* w_in = wih + (size_t)(layer > 0 ? layer - 1 : 0) * two_h * two_h * 4;
    const T* w_hh = whh + (size_t)layer * H * two_h * 4;

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
      const int tt = dir ? L - 1 - t : t;  // this thread's position
      if (layer > 0) {
        // Both directions' input rows for this step: the h plane of the layer
        // below, written by this CTA (plain loads, not the read-only path).
        const int n = 2 * tile * two_h;
        for (int i = tid; i < n; i += nthreads) {
          const int k = i % two_h;
          const int r = i / two_h;
          const int s = r % tile;
          const int d = r / tile;
          const int b = b0 + s;
          const int ts = d ? L - 1 - t : t;
          xin[(d * two_h + k) * tile + s] =
              b < B ? to_float(res[res_row(layer - 1, k / H, ts, b, L, B, H) + k % H]) : 0.0f;
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
        if (b < B) {
          T* r = res + res_row(layer, dir, tt, b, L, B, H) + j;
          r[0] = h;
          r[H] = from_float<T>(c[s]);
          r[2 * H] = from_float<T>(ig);
          r[3 * H] = from_float<T>(fg);
          r[4 * H] = from_float<T>(gg);
          r[5 * H] = from_float<T>(og);
          if (layer == layers - 1) out[((size_t)b * L + tt) * two_h + unit] = h;
        }
      }
    }
    __syncthreads();  // this layer's rows are written before the next layer reads them
  }
}

// ---------------------------------------------------------------------------
// Kernel 3, pass 1: the reverse sweep.
//   res (layers, 2, L, B, 6H) T; dy (B, L, 2H) T (already rounded);
//   whhT (layers, 4H, 2, H) T; wihT (layers-1, 4H, 2, 2H) T; wpT (4H, 2, 2) T;
//   wz (2, Z, 4H) T (layer 1's static rows);
//   gates (layers, 2, L, B, 4H) f32: every gate gradient, for pass 2;
//   dxbuf (2 ping-pong, 2 dirs, B, L, 2H) T: the gradient of a layer's input,
//     per direction, read by the layer below;
//   dpa (2 dirs, B, L, 2) T: the prototype gradient streams; dz (B, Z) f32.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void train_bwd_sweep_kernel(const T* __restrict__ res, const T* __restrict__ dy,
                                       const T* __restrict__ whhT, const T* __restrict__ wihT,
                                       const T* __restrict__ wpT, const T* __restrict__ wz,
                                       float* gates, T* dxbuf, T* dpa, float* dz, int B, int L,
                                       int H, int Z, int layers) {
  constexpr int S = kSamplesPerThread;
  const int two_h = 2 * H;
  const int four_h = 4 * H;
  const int unit = threadIdx.x;  // dir * H + j
  const int dir = unit / H;
  const int j = unit - dir * H;
  const int tile = blockDim.y * S;
  const int b0 = blockIdx.x * tile;
  const int lb = threadIdx.y * S;

  extern __shared__ float smem[];
  float* dgs = smem;  // (2 dirs, 4H, tile): this step's gate gradients
  const size_t stream = (size_t)B * L * two_h;  // one direction's input-gradient stream

  float dgsum[4][S];  // layer 1's sum over t of the gate gradients, for dz
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int s = 0; s < S; ++s) dgsum[g][s] = 0.0f;

  for (int layer = layers - 1; layer >= 0; --layer) {
    const bool top = layer == layers - 1;
    const T* dy_in = dxbuf + (size_t)((layer + 1) & 1) * 2 * stream;  // unless top
    T* dx_out = dxbuf + (size_t)(layer & 1) * 2 * stream;
    const T* w_hh = whhT + (size_t)layer * four_h * two_h;
    const T* w_ih = wihT + (size_t)(layer > 0 ? layer - 1 : 0) * four_h * 2 * two_h;
    float dh[S], dc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) dh[s] = dc[s] = 0.0f;

    for (int u = 0; u < L; ++u) {
      const int pos = dir ? u : L - 1 - u;
      const int prev = dir ? u + 1 : L - 2 - u;
      const bool has_prev = u + 1 < L;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int b = b0 + lb + s;
        float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (b < B) {
          const T* r = res + res_row(layer, dir, pos, b, L, B, H) + j;
          const float c_t = to_float(r[H]);
          const float ig = to_float(r[2 * H]);
          const float fg = to_float(r[3 * H]);
          const float gg = to_float(r[4 * H]);
          const float og = to_float(r[5 * H]);
          const float c_prev =
              has_prev ? to_float(res[res_row(layer, dir, prev, b, L, B, H) + H + j]) : 0.0f;
          const size_t yi = ((size_t)b * L + pos) * two_h + dir * H + j;
          const float dyv = top ? to_float(dy[yi])
                                : round_to<T>(to_float(dy_in[yi]) + to_float(dy_in[stream + yi]));
          const float dhv = dh[s] + dyv;
          const float tc = tanhf(c_t);
          const float dov = dhv * tc;
          const float dcv = dc[s] + dhv * og * (1.0f - tc * tc);
          dg[0] = dcv * gg * ig * (1.0f - ig);
          dg[1] = dcv * c_prev * fg * (1.0f - fg);
          dg[2] = dcv * ig * (1.0f - gg * gg);
          dg[3] = dov * og * (1.0f - og);
          dc[s] = dcv * fg;
          float* gr = gates + (res_row(layer, dir, pos, b, L, B, H) / 6) * 4 + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) gr[g * H] = dg[g];
          if (layer == 0) {
#pragma unroll
            for (int g = 0; g < 4; ++g) dgsum[g][s] += dg[g];
          }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) dgs[(dir * four_h + g * H + j) * tile + lb + s] = dg[g];
      }
      __syncthreads();  // the step's gate gradients of both directions are in dgs

      // dh through W_hh^T, and the input gradient through W_ih^T (layers >= 2).
      const float* dgp = dgs + dir * four_h * tile + lb;
      float ah[S], ax0[S], ax1[S];
#pragma unroll
      for (int s = 0; s < S; ++s) ah[s] = ax0[s] = ax1[s] = 0.0f;
      if (layer > 0) {
#pragma unroll 4
        for (int g = 0; g < four_h; ++g) {
          const float wh = to_float(__ldg(w_hh + ((size_t)g * 2 + dir) * H + j));
          const T* wx = w_ih + ((size_t)g * 2 + dir) * two_h + j;
          const float wx0 = to_float(__ldg(wx));
          const float wx1 = to_float(__ldg(wx + H));
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float v = dgp[g * tile + s];
            ah[s] = fmaf(wh, v, ah[s]);
            ax0[s] = fmaf(wx0, v, ax0[s]);
            ax1[s] = fmaf(wx1, v, ax1[s]);
          }
        }
      } else {
#pragma unroll 4
        for (int g = 0; g < four_h; ++g) {
          const float wh = to_float(__ldg(w_hh + ((size_t)g * 2 + dir) * H + j));
#pragma unroll
          for (int s = 0; s < S; ++s) ah[s] = fmaf(wh, dgp[g * tile + s], ah[s]);
        }
        // The prototype gradient: coordinate cc of this direction's stream.
        for (int cc = j; cc < 2; cc += H) {
          float ap[S];
#pragma unroll
          for (int s = 0; s < S; ++s) ap[s] = 0.0f;
          for (int g = 0; g < four_h; ++g) {
            const float wp = to_float(__ldg(wpT + ((size_t)g * 2 + dir) * 2 + cc));
#pragma unroll
            for (int s = 0; s < S; ++s) ap[s] = fmaf(wp, dgp[g * tile + s], ap[s]);
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int b = b0 + lb + s;
            if (b < B)
              dpa[(size_t)dir * B * L * 2 + ((size_t)b * L + pos) * 2 + cc] = from_float<T>(ap[s]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        dh[s] = ah[s];
        const int b = b0 + lb + s;
        if (layer > 0 && b < B) {
          T* o = dx_out + dir * stream + ((size_t)b * L + pos) * two_h;
          o[j] = from_float<T>(ax0[s]);
          o[H + j] = from_float<T>(ax1[s]);
        }
      }
      __syncthreads();  // dgs is free for the next step
    }
  }

  // dz = sum over directions of W_z . sum_t dgates, per sample.
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int g = 0; g < 4; ++g) dgs[(dir * four_h + g * H + j) * tile + lb + s] = dgsum[g][s];
  __syncthreads();
  for (int k = threadIdx.x; k < Z; k += blockDim.x) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int b = b0 + lb + s;
      float acc = 0.0f;
      for (int d = 0; d < 2; ++d) {
        const T* w = wz + ((size_t)d * Z + k) * four_h;
        const float* v = dgs + d * four_h * tile + lb + s;
        for (int g = 0; g < four_h; ++g) acc = fmaf(to_float(__ldg(w + g)), v[g * tile], acc);
      }
      if (b < B) dz[(size_t)b * Z + k] = acc;
    }
  }
}

// Row m of the weight-gradient product's left operand at (layer, dir, pos, b):
// [layer input (2 + Z for layer 1: prototype, z; 2H above) | h_prev (H) | 1].
template <typename T>
__device__ __forceinline__ float grad_lhs(const T* res, const T* proto, const T* zq, int layer,
                                          int dir, int pos, int b, int m, int din, int B, int L,
                                          int H, int Z) {
  if (m < din) {
    if (layer == 0)
      return m < 2 ? to_float(proto[((size_t)b * L + pos) * 2 + m])
                   : to_float(zq[(size_t)b * Z + m - 2]);
    const int d = m / H;
    return to_float(res[res_row(layer - 1, d, pos, b, L, B, H) + m - d * H]);
  }
  if (m < din + H) {
    const int prev = dir ? pos + 1 : pos - 1;
    if (prev < 0 || prev >= L) return 0.0f;
    return to_float(res[res_row(layer, dir, prev, b, L, B, H) + m - din]);
  }
  return 1.0f;
}

// ---------------------------------------------------------------------------
// Kernel 3, pass 2: ws[split, layer*2+dir, m, n] = sum over this split's rows
// r = pos*B + b of lhs(r, m) * gates[layer, dir, r, n]. Grid: (m-tiles x
// n-tiles, layers*2, splits); 256 threads, each a 4 x 4 block of outputs.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    train_bwd_wgrad_kernel(const T* __restrict__ res, const T* __restrict__ proto,
                           const T* __restrict__ zq, const float* __restrict__ gates,
                           float* __restrict__ ws, int B, int L, int H, int Z, int m_max,
                           int rows_per_split) {
  __shared__ __align__(16) float As[kTileK][kTileM];
  __shared__ __align__(16) float Bs[kTileK][kTileN];
  const int kd = blockIdx.y;
  const int layer = kd >> 1;
  const int dir = kd & 1;
  const int N = 4 * H;
  const int din = layer == 0 ? 2 + Z : 2 * H;
  const int M = din + H + 1;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int m0 = (blockIdx.x / n_tiles) * kTileM;
  const int n0 = (blockIdx.x % n_tiles) * kTileN;
  if (m0 >= M) return;  // rows past this layer's M are never read
  const int K = L * B;
  const int r_begin = blockIdx.z * rows_per_split;
  const int r_end = min(K, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* g_rows = gates + (size_t)kd * K * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += kTileK) {
#pragma unroll
    for (int it = 0; it < kTileK * kTileM / kGemmThreads; ++it) {
      const int e = tid + it * kGemmThreads;
      const int rr = e / kTileM;
      const int cc = e % kTileM;
      const int r = r0 + rr;
      float a = 0.0f, bv = 0.0f;
      if (r < r_end) {
        const int pos = r / B;
        const int b = r - pos * B;
        if (m0 + cc < M) a = grad_lhs(res, proto, zq, layer, dir, pos, b, m0 + cc, din, B, L, H, Z);
        if (n0 + cc < N) bv = g_rows[(size_t)r * N + n0 + cc];
      }
      As[rr][cc] = a;
      Bs[rr][cc] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bq = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bw[q], acc[i][q]);
    }
    __syncthreads();
  }
  float* out = ws + ((size_t)blockIdx.z * gridDim.y + kd) * m_max * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n < N) out[(size_t)m * N + n] = acc[i][q];
    }
  }
}

// Kernel 3, pass 3: dw = the splits' partial sums added in split order, laid
// out per layer and direction as [dW_ih (din rows); dW_hh (H rows); db (1 row)]
// x 4H.
__global__ void train_bwd_wgrad_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                           int H, int Z, int layers, int m_max, int splits) {
  const int N = 4 * H;
  const size_t first = (size_t)2 * (2 + Z + H + 1) * N;  // layer 1's two matrices
  const size_t rest = (size_t)2 * (3 * H + 1) * N;
  const size_t total = first + (layers - 1) * rest;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    int layer;
    size_t rem;
    int M;
    if (idx < first) {
      layer = 0;
      rem = idx;
      M = 2 + Z + H + 1;
    } else {
      layer = 1 + (int)((idx - first) / rest);
      rem = (idx - first) % rest;
      M = 3 * H + 1;
    }
    const int dir = (int)(rem / ((size_t)M * N));
    const size_t mn = rem % ((size_t)M * N);
    const int m = (int)(mn / N);
    const int n = (int)(mn % N);
    const int kd = layer * 2 + dir;
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += ws[(((size_t)z * layers * 2 + kd) * m_max + m) * N + n];
    dw[idx] = s;
  }
}

template <typename T>
int launch_fwd(const void* proto, const float* z, const void* wseq1, const float* wz,
               const void* whh, const void* wih, const float* bias, void* res, void* out, int B,
               int L, int H, int Z, int layers, cudaStream_t stream) {
  const dim3 block(2 * H, kSampleGroups);
  const int tile = kSampleGroups * kSamplesPerThread;
  const dim3 grid((B + tile - 1) / tile);
  const size_t smem = (size_t)(2 * 2 * H + 2 * H) * tile * sizeof(float);
  // A few KB of shared memory: leave the rest to the L1 that serves the weights.
  cudaFuncSetAttribute(train_fwd_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  train_fwd_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(proto), z, static_cast<const T*>(wseq1), wz,
      static_cast<const T*>(whh), static_cast<const T*>(wih), bias, static_cast<T*>(res),
      static_cast<T*>(out), B, L, H, Z, layers);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* res, const void* dy, const void* proto, const void* zq,
               const void* whhT, const void* wihT, const void* wpT, const void* wz, float* gates,
               void* dxbuf, void* dpa, float* dz, float* ws, float* dw, int B, int L, int H,
               int Z, int layers, int splits, cudaStream_t stream) {
  const T* res_t = static_cast<const T*>(res);
  const T* proto_t = static_cast<const T*>(proto);
  const T* zq_t = static_cast<const T*>(zq);
  {
    const dim3 block(2 * H, kSampleGroups);
    const int tile = kSampleGroups * kSamplesPerThread;
    const dim3 grid((B + tile - 1) / tile);
    const size_t smem = (size_t)2 * 4 * H * tile * sizeof(float);
    cudaFuncSetAttribute(train_bwd_sweep_kernel<T>,
                         cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    train_bwd_sweep_kernel<T><<<grid, block, smem, stream>>>(
        res_t, static_cast<const T*>(dy), static_cast<const T*>(whhT),
        static_cast<const T*>(wihT), static_cast<const T*>(wpT), static_cast<const T*>(wz), gates,
        static_cast<T*>(dxbuf), static_cast<T*>(dpa), dz, B, L, H, Z, layers);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int m_first = 2 + Z + H + 1;
  const int m_max = layers > 1 && 3 * H + 1 > m_first ? 3 * H + 1 : m_first;
  const int K = L * B;
  int rows = (K + splits - 1) / splits;
  rows = (rows + kTileK - 1) / kTileK * kTileK;
  {
    const int n_tiles = (4 * H + kTileN - 1) / kTileN;
    const int m_tiles = (m_max + kTileM - 1) / kTileM;
    const dim3 grid(m_tiles * n_tiles, layers * 2, splits);
    train_bwd_wgrad_kernel<T><<<grid, kGemmThreads, 0, stream>>>(res_t, proto_t, zq_t, gates, ws,
                                                                 B, L, H, Z, m_max, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t total = (size_t)2 * (m_first + (size_t)(layers - 1) * (3 * H + 1)) * 4 * H;
  const size_t wanted = (total + 255) / 256;
  const int blocks = wanted < 4096 ? (int)wanted : 4096;
  train_bwd_wgrad_sum_kernel<<<blocks, 256, 0, stream>>>(ws, dw, H, Z, layers, m_max, splits);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// The tensor-core path: bf16, H = 16 * HT (HT = 1, 2, 3). See the note at the
// head of this file.
// ===========================================================================

constexpr int kInStages = 6;  // ring of residual / dy rows ahead of the sweep
constexpr int kDgStages = 3;  // ring of gate-gradient tiles behind the sweep

template <int HT>
constexpr size_t fwd_mma_smem_bytes() {
  constexpr int H = 16 * HT;
  return (size_t)2 * kGxStages * HT * 128 * 16      // gx ring (float4)
         + (size_t)2 * 2 * kSampleTile * (6 * H + 8) * 2  // residual row staging
         + (size_t)2 * 2 * kSampleTile * (H + 8) * 2  // h tiles
         + (size_t)4 * kGxStages * 8;                 // mbarriers
}

// ---------------------------------------------------------------------------
// Kernel 2, tensor-core path. One CTA = 8 samples through all layers; per
// direction HT chain warps (the recurrence) and HT producer warps (the input
// projection, kGxStages positions ahead).
//   proto (B, L, 2) bf16; z (B, Z) f32; wq / wf: the packed weights in bf16
//   and f32; res (layers, 2, L, B, 6H) bf16; out (B, L, 2H) bf16.
// ---------------------------------------------------------------------------
template <int HT>
__global__ void __launch_bounds__(128 * HT, 1)
    train_fwd_mma_kernel(const bf16* __restrict__ proto, const float* __restrict__ z,
                         const bf16* __restrict__ wq, const float* __restrict__ wf, bf16* res,
                         bf16* out, int B, int L, int Z, int layers) {
  constexpr int H = 16 * HT, HS = H + 8, ROW = 6 * H, R = kGxStages;
  constexpr int SROW = ROW + 8;  // staged rows 16 bytes apart from a bank-aligned stride
  constexpr int kDirThreads = 32 * HT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float4* gx = reinterpret_cast<float4*>(smem_raw);               // [2][R][HT][4][32]
  bf16* stage = reinterpret_cast<bf16*>(gx + 2 * R * HT * 128);   // [2][2][8][SROW]
  bf16* hs = stage + 2 * 2 * kSampleTile * SROW;                  // [2][2][8][HS]
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * 2 * kSampleTile * HS);  // [2][R]
  uint64_t* empty = full + 2 * R;                                                 // [2][R]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int dir = wid / (2 * HT);
  const int within = wid % (2 * HT);
  const bool producer = within >= HT;
  const int w = within % HT;
  const int r = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * kSampleTile;
  const int nb = min(kSampleTile, B - b0);
  // Lane s of a direction's first chain warp copies sample s's staged row out.
  const bool copier = !producer && w == 0 && lane < nb;

  if (tid == 0) {
    for (int i = 0; i < 2 * R; ++i) {
      mbar_init(full + i, kDirThreads);
      mbar_init(empty + i, kDirThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  for (int layer = 0; layer < layers; ++layer) {
    const CellOffsets off = cell_offsets(layer, dir, H, Z);
    const int it0 = layer * L;
    float4* gx_d = gx + (size_t)dir * R * HT * 128;
    uint64_t* full_d = full + dir * R;
    uint64_t* empty_d = empty + dir * R;
    if (producer) {
      // ---- the input projection of this layer, in the chain's order ----
      if (layer == 0) {
        produce_first_layer<HT>(proto, z, wq, wf, off, b0, B, L, Z, dir, w, lane, gx_d, full_d,
                                empty_d, it0);
      } else {
        // x^T fragments: the h planes of the layer below at this position,
        // sample r of the tile, features 16kt + {2q, 2q+1, 2q+8, 2q+9}.
        const bool valid = b0 + r < B;
        produce_upper_layer<HT>(
            wq, wf, off, L, dir, w, lane, gx_d, full_d, empty_d, it0,
            [&](int pos, uint32_t (&bx)[2 * HT][2]) {
#pragma unroll
              for (int kt = 0; kt < 2 * HT; ++kt) {
                bx[kt][0] = bx[kt][1] = 0u;
                if (valid) {
                  const uint32_t* src = reinterpret_cast<const uint32_t*>(
                      res + res_row(layer - 1, kt / HT, pos, b0 + r, L, B, H) + (kt % HT) * 16 +
                      2 * q);
                  bx[kt][0] = src[0];
                  bx[kt][1] = src[4];
                }
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
        bf16* st = stage + (size_t)(dir * 2 + (t & 1)) * kSampleTile * SROW;
        const int unit = 16 * w + 2 * r;  // and unit + 1: pairs j and j + 2
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 2 * q + e;
          const uint32_t hh = pack_bf16(h[e], h[e + 2]);
          *reinterpret_cast<uint32_t*>(hn + s * HS + unit) = hh;
          uint32_t* row = reinterpret_cast<uint32_t*>(st + s * SROW + unit);
          row[0] = hh;
          row[H / 2] = pack_bf16(c[e], c[e + 2]);
#pragma unroll
          for (int g = 0; g < 4; ++g) row[(2 + g) * H / 2] = pack_bf16(acc[g][e], acc[g][e + 2]);
          if (top && b0 + s < B)
            *reinterpret_cast<uint32_t*>(out + ((size_t)(b0 + s) * L + pos) * 2 * H + dir * H +
                                         unit) = hh;
        }
        fence_async_shared();
        if (copier) bulk_wait_read();  // the row staged two steps ago has left its buffer
        named_barrier(1 + dir, kDirThreads);
        if (copier) {
          // A sample's whole row [h | c | i | f | g | o] in one copy; the tile's
          // rows at one position are consecutive in res.
          bulk_store(res + res_row(layer, dir, pos, b0 + lane, L, B, H), st + lane * SROW, ROW * 2);
          bulk_commit();
        }
      }
      if (copier) {
        bulk_wait_all();  // this layer's rows are in global memory
        fence_async_all();
      }
    }
    __threadfence();
    __syncthreads();  // the layer above reads both directions at every position
  }
}

template <int HT>
constexpr size_t sweep_mma_smem_bytes() {
  constexpr int H = 16 * HT;
  return (size_t)2 * kInStages * kSampleTile * (6 * H * 2 + 16)    // residual rows
         + (size_t)2 * kInStages * 2 * kSampleTile * (H * 2 + 16)  // dy rows (two streams)
         + (size_t)2 * kDgStages * 2 * 4 * H * 16                  // gate-gradient tiles
         + (size_t)2 * 4 * H * kSampleTile * 4                     // per-sample sums
         + (size_t)2 * (kInStages + 2 * kDgStages) * 8;            // mbarriers
}

// hi = bf16(v), lo = bf16(v - hi): v = hi + lo to about 2^-17 relative.
__device__ __forceinline__ void split_bf16(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// ---------------------------------------------------------------------------
// Kernel 3, pass 1, tensor-core path: the reverse sweep. One CTA = 8 samples
// through all layers, top down; per direction HT chain warps (gate gradients
// and dh = W_hh . dg, the dependent chain) and HT side warps (the gradient of
// the layer's input, dx = W_ih . dg, the copies in and out).
//   res (layers, 2, L, B, 6H) bf16; dyT (L, B, 2H) bf16; proto (B, L, 2) bf16;
//   zq (B, Z) bf16; wq: the packed bf16 weights;
//   dg (layers*2, L, tiles, 2 [hi, lo], 4H, 8) bf16: the split gate gradients;
//   dxbuf (2 ping-pong, 2 dirs, L, B, 2H) bf16; dpa (2, B, L, 2) bf16;
//   dz (B, Z) f32; per-tile partial sums wsb (tiles, layers*2, 4H) (bias),
//   wsp (tiles, 2, 2, 4H) (prototype rows), wsz (tiles, 2, Z, 4H) (z rows).
// ---------------------------------------------------------------------------
template <int HT>
__global__ void __launch_bounds__(128 * HT, 1)
    train_bwd_sweep_mma_kernel(const bf16* __restrict__ res, const bf16* __restrict__ dyT,
                               const bf16* __restrict__ proto, const bf16* __restrict__ zq,
                               const bf16* __restrict__ wq, bf16* dg, bf16* dxbuf, bf16* dpa,
                               float* dz, float* wsb, float* wsp, float* wsz, int B, int L, int Z,
                               int layers) {
  constexpr int H = 16 * HT, G = 4 * H, ROW = 6 * H, RI = kInStages, RD = kDgStages;
  constexpr int RS = ROW * 2 + 16;  // bytes between staged residual rows (bank spread)
  constexpr int DS = H * 2 + 16;    // bytes between staged dy rows
  constexpr int KT = 4 * HT;        // k-tiles of the 4H gate rows
  constexpr int kDirThreads = 32 * HT;
  constexpr int kDwpWarp = HT > 1 ? 1 : 0;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* res_ring = smem_raw;                                     // [2][RI][8][RS]
  unsigned char* dy_ring = res_ring + 2 * RI * kSampleTile * RS;          // [2][RI][2][8][DS]
  bf16* dg_ring = reinterpret_cast<bf16*>(dy_ring + 2 * RI * 2 * kSampleTile * DS);  // [2][RD][2][G][8]
  float* sums = reinterpret_cast<float*>(dg_ring + 2 * RD * 2 * G * 8);   // [2][G][8]
  uint64_t* full_in = reinterpret_cast<uint64_t*>(sums + 2 * G * kSampleTile);  // [2][RI]
  uint64_t* full_dg = full_in + 2 * RI;                                          // [2][RD]
  uint64_t* empty_dg = full_dg + 2 * RD;                                         // [2][RD]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int dir = wid / (2 * HT);
  const int within = wid % (2 * HT);
  const bool side = within >= HT;
  const int w = within % HT;
  const int r = lane >> 2, q = lane & 3;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int b0 = tile * kSampleTile;
  const int nb = min(kSampleTile, B - b0);
  const size_t stream = (size_t)L * B * 2 * H;  // one direction's input-gradient stream

  // Rows of samples past B are never loaded: zero them once so that their
  // gate gradients are exact zeros.
  for (int i = tid * 4; i < 2 * RI * kSampleTile * (RS + 2 * DS); i += nthreads * 4)
    *reinterpret_cast<uint32_t*>(smem_raw + i) = 0u;
  if (tid == 0) {
    for (int i = 0; i < 2 * RI; ++i) mbar_init(full_in + i, 1);
    for (int i = 0; i < 2 * RD; ++i) {
      mbar_init(full_dg + i, kDirThreads);
      mbar_init(empty_dg + i, kDirThreads);
    }
    mbar_init_fence();
  }
  fence_async_shared();
  __syncthreads();

  for (int layer = layers - 1; layer >= 0; --layer) {
    const bool top = layer == layers - 1;
    const CellOffsets off = cell_offsets(layer, dir, H, Z);
    const int it0 = (layers - 1 - layer) * L;
    const int kd = layer * 2 + dir;
    const bf16* dx_in = dxbuf + (size_t)((layer + 1) & 1) * 2 * stream;  // unless top
    bf16* dx_out = dxbuf + (size_t)(layer & 1) * 2 * stream;

    // One position's rows for this direction into ring slot it % RI: the
    // residual row of each sample and its dy (the top layer's cotangent, or
    // the two per-direction streams the layer above wrote). Called by one
    // warp; lane s copies sample s.
    auto start_loads = [&](int u) {
      const int it = it0 + u;
      const int slot = it % RI;
      const int pos = dir ? u : L - 1 - u;
      uint64_t* bar = full_in + dir * RI + slot;
      const uint32_t per_sample = ROW * 2 + H * 2 * (top ? 1 : 2);
      if (lane == 0) mbar_arrive_expect_tx(bar, (uint32_t)nb * per_sample);
      __syncwarp();
      if (lane < nb) {
        const int b = b0 + lane;
        bulk_load(res_ring + ((size_t)(dir * RI + slot) * kSampleTile + lane) * RS,
                  res + res_row(layer, dir, pos, b, L, B, H), ROW * 2, bar);
        unsigned char* dyd = dy_ring + ((size_t)(dir * RI + slot) * 2 * kSampleTile + lane) * DS;
        const size_t row = ((size_t)pos * B + b) * 2 * H + dir * H;
        if (top) {
          bulk_load(dyd, dyT + row, H * 2, bar);
        } else {
          bulk_load(dyd, dx_in + row, H * 2, bar);
          bulk_load(dyd + kSampleTile * DS, dx_in + stream + row, H * 2, bar);
        }
      }
    };

    if (side) {
      // ---- off the chain: copies, dx = W_ih . dg, the prototype's parts ----
      // Layer 1 has no layer below: tile 0 of warp 0 holds the prototype's two
      // weight rows (zero padded) instead, giving the prototype gradient.
      uint32_t a[2][KT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          const int m = 16 * (2 * w + mt) + 2 * r;  // tile rows r, r+8: features m, m+1
          const int k = 16 * kt + 2 * q;
          const int rows = layer == 0 ? 2 : 2 * H;
          const uint32_t* lo_row =
              reinterpret_cast<const uint32_t*>(wq + off.w_ih + (size_t)m * G + k);
          const uint32_t* hi_row =
              reinterpret_cast<const uint32_t*>(wq + off.w_ih + (size_t)(m + 1) * G + k);
          a[mt][kt][0] = m < rows ? __ldg(lo_row) : 0u;
          a[mt][kt][1] = m + 1 < rows ? __ldg(hi_row) : 0u;
          a[mt][kt][2] = m < rows ? __ldg(lo_row + 4) : 0u;
          a[mt][kt][3] = m + 1 < rows ? __ldg(hi_row + 4) : 0u;
        }
      float dwp[G / 32][2];  // layer 1, one warp: sum over (t, tile) of proto . dg
#pragma unroll
      for (int i = 0; i < G / 32; ++i) dwp[i][0] = dwp[i][1] = 0.0f;

      if (w == 0)
        for (int u = 0; u < min(RI, L); ++u) start_loads(u);

      for (int u = 0; u < L; ++u) {
        const int pos = dir ? u : L - 1 - u;
        const int it = it0 + u;
        const int slot = it % RD;
        const bf16* tile_hi = dg_ring + (size_t)(dir * RD + slot) * 2 * G * 8;
        float pc[kSampleTile][2];
        if (layer == 0 && w == kDwpWarp) {
#pragma unroll
          for (int s = 0; s < kSampleTile; ++s) {
            pc[s][0] = pc[s][1] = 0.0f;
            if (s < nb) {
              const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
                  proto + ((size_t)(b0 + s) * L + pos) * 2);
              pc[s][0] = __bfloat162float(v.x);
              pc[s][1] = __bfloat162float(v.y);
            }
          }
        }
        mbar_wait(full_dg + dir * RD + slot, (it / RD) & 1);
        if (w == 0) {
          // The chain has read ring slot it % RI for the last time.
          if (u + RI < L) start_loads(u + RI);
          if (lane == 0) {
            bulk_store(dg + (((size_t)kd * L + pos) * tiles + tile) * 2 * G * 8, tile_hi,
                       2 * G * 16);
            bulk_commit();
          }
        }
        if (layer > 0 || w == 0) {
          float acc[2][2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hl = 0; hl < 2; ++hl)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][hl][e] = 0.0f;
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
#pragma unroll
            for (int kp = 0; kp < KT / 2; ++kp) {
              uint32_t bfr[4];
              ldmatrix_x4_trans(bfr, tile_hi + ((size_t)hl * G + 32 * kp + lane) * 8);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                mma_bf16(acc[mt][hl], a[mt][2 * kp], bfr[0], bfr[1]);
                mma_bf16(acc[mt][hl], a[mt][2 * kp + 1], bfr[2], bfr[3]);
              }
            }
          if (layer > 0) {
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = 16 * (2 * w + mt) + 2 * r;
                const int b = b0 + 2 * q + e;
                if (b < B)
                  *reinterpret_cast<uint32_t*>(dx_out + dir * stream +
                                               ((size_t)pos * B + b) * 2 * H + m) =
                      pack_bf16(acc[mt][0][e] + acc[mt][1][e], acc[mt][0][e + 2] + acc[mt][1][e + 2]);
              }
          } else if (r == 0) {
            // Tile rows 0 and 8 are the prototype's two coordinates.
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int b = b0 + 2 * q + e;
              if (b < B)
                *reinterpret_cast<uint32_t*>(dpa + (size_t)dir * B * L * 2 +
                                             ((size_t)b * L + pos) * 2) =
                    pack_bf16(acc[0][0][e] + acc[0][1][e], acc[0][0][e + 2] + acc[0][1][e + 2]);
            }
          }
        }
        if (layer == 0 && w == kDwpWarp) {
#pragma unroll
          for (int i = 0; i < G / 32; ++i) {
            const int n = lane + 32 * i;
            const uint4 vh = *reinterpret_cast<const uint4*>(tile_hi + (size_t)n * 8);
            const uint4 vl = *reinterpret_cast<const uint4*>(tile_hi + (size_t)(G + n) * 8);
            const uint32_t wh[4] = {vh.x, vh.y, vh.z, vh.w};
            const uint32_t wl[4] = {vl.x, vl.y, vl.z, vl.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 fh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wh[e]));
              const float2 fl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wl[e]));
              const float g0 = fh.x + fl.x, g1 = fh.y + fl.y;
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                dwp[i][cc] = fmaf(pc[2 * e][cc], g0, dwp[i][cc]);
                dwp[i][cc] = fmaf(pc[2 * e + 1][cc], g1, dwp[i][cc]);
              }
            }
          }
        }
        if (w == 0 && lane == 0) bulk_wait_read();  // the tile's copy out has read it
        mbar_arrive(empty_dg + dir * RD + slot);
      }
      if (layer == 0 && w == kDwpWarp) {
#pragma unroll
        for (int i = 0; i < G / 32; ++i)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            wsp[((size_t)(tile * 2 + dir) * 2 + cc) * G + lane + 32 * i] = dwp[i][cc];
      }
    } else {
      // ---- the dependent chain ----
      uint32_t a[KT][4];  // W_hh rows 16w + {2r, 2r+1} (tile rows r, r+8), all 4H columns
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const uint32_t* lo_row = reinterpret_cast<const uint32_t*>(
            wq + off.w_hh + (size_t)(16 * w + 2 * r) * G + 16 * kt + 2 * q);
        const uint32_t* hi_row = lo_row + G / 2;
        a[kt][0] = __ldg(lo_row);
        a[kt][1] = __ldg(hi_row);
        a[kt][2] = __ldg(lo_row + 4);
        a[kt][3] = __ldg(hi_row + 4);
      }
      float dh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float dgsum[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) dgsum[g][j] = 0.0f;

      for (int u = 0; u < L; ++u) {
        const int it = it0 + u;
        const int slot_in = it % RI;
        const int slot = it % RD;
        const bool has_prev = u + 1 < L;
        mbar_wait(full_in + dir * RI + slot_in, (it / RI) & 1);
        if (has_prev) mbar_wait(full_in + dir * RI + (it + 1) % RI, ((it + 1) / RI) & 1);
        const unsigned char* rows = res_ring + (size_t)(dir * RI + slot_in) * kSampleTile * RS;
        const unsigned char* prev_rows =
            res_ring + (size_t)(dir * RI + (it + 1) % RI) * kSampleTile * RS;
        const unsigned char* dys = dy_ring + (size_t)(dir * RI + slot_in) * 2 * kSampleTile * DS;
        // This step's factors, independent of the carried dh and dc.
        // Pair j is unit 16w + 2r + j / 2, sample 2q + j % 2: a sample's two
        // units are one 32-bit word of each plane.
        float dyv[4], tc[4], ig[4], fg[4], gg[4], og[4], c_prev[4];
        const int unit = 16 * w + 2 * r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 2 * q + e;
          const uint32_t* row = reinterpret_cast<const uint32_t*>(rows + s * RS) + unit / 2;
          const auto two = [](uint32_t word) {
            return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&word));
          };
          const float2 cv = two(row[H / 2]), iv = two(row[H]), fv = two(row[3 * H / 2]),
                       gv = two(row[2 * H]), ov = two(row[5 * H / 2]);
          const float2 pv =
              has_prev ? two(reinterpret_cast<const uint32_t*>(prev_rows + s * RS)[(H + unit) / 2])
                       : make_float2(0.0f, 0.0f);
          float2 dv = two(reinterpret_cast<const uint32_t*>(dys + s * DS)[unit / 2]);
          if (!top) {
            const float2 d2 =
                two(reinterpret_cast<const uint32_t*>(dys + (kSampleTile + s) * DS)[unit / 2]);
            dv.x = __bfloat162float(__float2bfloat16_rn(dv.x + d2.x));
            dv.y = __bfloat162float(__float2bfloat16_rn(dv.y + d2.y));
          }
          tc[e] = tanh_fast(cv.x), tc[e + 2] = tanh_fast(cv.y);
          ig[e] = iv.x, ig[e + 2] = iv.y;
          fg[e] = fv.x, fg[e + 2] = fv.y;
          gg[e] = gv.x, gg[e + 2] = gv.y;
          og[e] = ov.x, og[e + 2] = ov.y;
          c_prev[e] = pv.x, c_prev[e + 2] = pv.y;
          dyv[e] = dv.x, dyv[e + 2] = dv.y;
        }
        if (u > 0) {
          // dh = W_hh . dg of the previous step, hi and lo parts, four
          // independent accumulation chains.
          const bf16* prev_tile = dg_ring + (size_t)(dir * RD + (it - 1) % RD) * 2 * G * 8;
          float acc[2][2][4];
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
#pragma unroll
            for (int par = 0; par < 2; ++par)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[hl][par][e] = 0.0f;
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
#pragma unroll
            for (int kp = 0; kp < KT / 2; ++kp) {
              uint32_t bfr[4];
              ldmatrix_x4_trans(bfr, prev_tile + ((size_t)hl * G + 32 * kp + lane) * 8);
              mma_bf16(acc[hl][0], a[2 * kp], bfr[0], bfr[1]);
              mma_bf16(acc[hl][1], a[2 * kp + 1], bfr[2], bfr[3]);
            }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dh[e] = (acc[0][0][e] + acc[0][1][e]) + (acc[1][0][e] + acc[1][1][e]);
        }
        mbar_wait(empty_dg + dir * RD + slot, ((it / RD) & 1) ^ 1);
        bf16* out_hi = dg_ring + (size_t)(dir * RD + slot) * 2 * G * 8;
        float v[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float dhv = dh[j] + dyv[j];
          const float dov = dhv * tc[j];
          const float dcv = dc[j] + dhv * og[j] * (1.0f - tc[j] * tc[j]);
          v[0][j] = dcv * gg[j] * ig[j] * (1.0f - ig[j]);
          v[1][j] = dcv * c_prev[j] * fg[j] * (1.0f - fg[j]);
          v[2][j] = dcv * ig[j] * (1.0f - gg[j] * gg[j]);
          v[3][j] = dov * og[j] * (1.0f - og[j]);
          dc[j] = dcv * fg[j];
        }
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            bf16 h0, l0, h1, l1;
            split_bf16(v[g][2 * half], h0, l0);
            split_bf16(v[g][2 * half + 1], h1, l1);
            const int n = g * H + 16 * w + 2 * r + half;
            // Samples 2q and 2q+1 of gate row n: one 32-bit store each.
            reinterpret_cast<uint32_t*>(out_hi + (size_t)n * 8)[q] = pack_bf16(h0, h1);
            reinterpret_cast<uint32_t*>(out_hi + (size_t)(G + n) * 8)[q] = pack_bf16(l0, l1);
            dgsum[g][2 * half] += v[g][2 * half];
            dgsum[g][2 * half + 1] += v[g][2 * half + 1];
          }
        fence_async_shared();
        mbar_arrive(full_dg + dir * RD + slot);   // to the side warps
        named_barrier(1 + dir, kDirThreads);      // the chain's own exchange of the tile
      }
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sums[((size_t)dir * G + g * H + 16 * w + 2 * r + (j >> 1)) * kSampleTile + 2 * q +
               (j & 1)] = dgsum[g][j];
    }
    __threadfence();
    fence_async_all();  // the dx rows written here are bulk-loaded by the layer below
    __syncthreads();
    // The bias gradient's part of this tile: the sum over its samples.
    for (int i = tid; i < 2 * G; i += nthreads) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < kSampleTile; ++e) s += sums[(size_t)i * kSampleTile + e];
      wsb[((size_t)tile * layers * 2 + layer * 2 + i / G) * G + i % G] = s;
    }
    if (layer == 0) {
      // dz = W_z . sum_t dg per sample, and this tile's part of dW_z = z^T . sum_t dg.
      for (int i = tid; i < kSampleTile * Z; i += nthreads) {
        const int s = i / Z, k = i % Z;
        if (s >= nb) continue;
        float acc = 0.0f;
        for (int d = 0; d < 2; ++d) {
          const bf16* wrow = wq + cell_offsets(0, d, H, Z).w_ih + (size_t)(2 + k) * G;
          const float* v = sums + (size_t)d * G * kSampleTile + s;
          for (int n = 0; n < G; ++n)
            acc = fmaf(__bfloat162float(__ldg(wrow + n)), v[n * kSampleTile], acc);
        }
        dz[(size_t)(b0 + s) * Z + k] = acc;
      }
      for (int i = tid; i < 2 * Z * G; i += nthreads) {
        const int d = i / (Z * G), k = (i / G) % Z, n = i % G;
        float acc = 0.0f;
        for (int s = 0; s < nb; ++s)
          acc = fmaf(__bfloat162float(__ldg(zq + (size_t)(b0 + s) * Z + k)),
                     sums[((size_t)d * G + n) * kSampleTile + s], acc);
        wsz[(size_t)tile * 2 * Z * G + i] = acc;
      }
    }
    __syncthreads();
  }
}

constexpr int kWgStages = 3;    // cp.async ring of the weight-gradient product
constexpr int kWgRows = 64;     // rows of the sum per stage: four k-steps of 16
constexpr int kWgThreads = 384; // 3 row groups (the operand's parts) x 4 column groups

template <int HT>
constexpr size_t wgrad_mma_smem_bytes() {
  constexpr int H = 16 * HT;
  return (size_t)kWgStages * (3 * kWgRows * (H * 2 + 16) + (kWgRows / 8) * 2 * 4 * H * 16);
}

__device__ __forceinline__ void cp_async16(void* dst_smem, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst_smem)),
               "l"(src), "r"(bytes)
               : "memory");
}

// ---------------------------------------------------------------------------
// Kernel 3, pass 2, tensor-core path. Per (layer, direction) kd and split of
// the positions: ws[split, kd] (3H x 4H) = lhs^T . (dg_hi + dg_lo) over the
// split's rows r = pos * B + b, where lhs = [h of the layer below, forward |
// the same, backward | this layer's h one step earlier]: the h planes of
// consecutive residual rows, copied 16 bytes at a time (rows past the ends
// zero-filled), never gathered by element. Both operands have the summed
// index as their slow one: lhs^T comes out of shared memory through
// ldmatrix.trans, and dg was stored by the sweep with its 8 samples
// innermost, which is the B fragment's order. Layer 1's input parts (the
// prototype, z) are summed by the sweep itself.
// Grid (layers * 2, splits); warp (part, ng) owns rows part*H.. and a quarter
// of the 4H columns.
// ---------------------------------------------------------------------------
template <int HT>
__global__ void __launch_bounds__(kWgThreads, 1)
    train_bwd_wgrad_mma_kernel(const bf16* __restrict__ res, const bf16* __restrict__ dg,
                               float* __restrict__ ws, int B, int L, int tiles,
                               int pos_per_split) {
  constexpr int H = 16 * HT, G = 4 * H;
  constexpr int AS = H * 2 + 16;                // bytes per staged lhs row
  constexpr int A_STAGE = 3 * kWgRows * AS;
  constexpr int B_TILE = 2 * G * 16;            // one 8-sample tile: hi and lo planes
  constexpr int STAGE = A_STAGE + (kWgRows / 8) * B_TILE;
  constexpr int NT = 2 * HT;                    // 8-column tiles per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const int part = wid >> 2, ng = wid & 3;
  const int r = lane >> 2, q = lane & 3;
  const int kd = blockIdx.x;
  const int layer = kd >> 1, dir = kd & 1;
  const int split = blockIdx.y;
  const int p_begin = split * pos_per_split;
  const int p_end = min(L, p_begin + pos_per_split);
  const int chunks = (B + kWgRows - 1) / kWgRows;
  const int n_iter = max(0, p_end - p_begin) * chunks;
  const bool active = layer > 0 || part == 2;

  auto load = [&](int iter) {
    unsigned char* st = smem_raw + (size_t)(iter % kWgStages) * STAGE;
    const int pos = p_begin + iter / chunks;
    const int c = iter % chunks;
    for (int i = tid; i < 3 * kWgRows * NT; i += kWgThreads) {
      const int p = i / (kWgRows * NT);
      const int row = (i / NT) % kWgRows;
      const int ch = i % NT;
      const int b = c * kWgRows + row;
      bool valid = b < B;
      size_t src = 0;
      if (p < 2) {
        valid = valid && layer > 0;
        if (valid) src = res_row(layer - 1, p, pos, b, L, B, H);
      } else {
        const int prev = dir ? pos + 1 : pos - 1;
        valid = valid && prev >= 0 && prev < L;
        if (valid) src = res_row(layer, dir, prev, b, L, B, H);
      }
      cp_async16(st + (size_t)(p * kWgRows + row) * AS + ch * 16, res + src + ch * 8, valid);
    }
    for (int i = tid; i < (kWgRows / 8) * 2 * G; i += kWgThreads) {
      const int t8 = i / (2 * G);
      const int rem = i % (2 * G);
      const int tl = c * (kWgRows / 8) + t8;
      const bool valid = tl < tiles;
      const size_t src = valid ? ((((size_t)kd * L + pos) * tiles + tl) * 2 * G + rem) * 8 : 0;
      cp_async16(st + A_STAGE + (size_t)i * 16, dg + src, valid);
    }
  };

  float acc[HT][NT][4];
#pragma unroll
  for (int mt = 0; mt < HT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < n_iter) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int iter = 0; iter < n_iter; ++iter) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kWgStages - 2) : "memory");
    __syncthreads();  // stage iter has landed; stage iter - 1 is free
    if (iter + kWgStages - 1 < n_iter) load(iter + kWgStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (!active) continue;
    const unsigned char* st = smem_raw + (size_t)(iter % kWgStages) * STAGE;
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) {
      uint32_t af[HT][4];
#pragma unroll
      for (int mt = 0; mt < HT; ++mt)
        ldmatrix_x4_trans(af[mt], st + (size_t)(part * kWgRows + 16 * kk + (lane & 7) +
                                                ((lane >> 4) << 3)) * AS +
                                          (16 * mt + ((lane >> 3) & 1) * 8) * 2);
      const unsigned char* t0 = st + A_STAGE + (size_t)(2 * kk) * B_TILE;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = (ng * NT + nt) * 8 + r;
#pragma unroll
        for (int hl = 0; hl < 2; ++hl) {
          const uint32_t b0 =
              *reinterpret_cast<const uint32_t*>(t0 + (size_t)(hl * G + n) * 16 + q * 4);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(t0 + B_TILE +
                                                                 (size_t)(hl * G + n) * 16 + q * 4);
#pragma unroll
          for (int mt = 0; mt < HT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  float* out = ws + ((size_t)split * gridDim.x + kd) * 3 * H * G;
#pragma unroll
  for (int mt = 0; mt < HT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = part * H + 16 * mt + r + 8 * half;
        const int n = (ng * NT + nt) * 8 + 2 * q;
        *reinterpret_cast<float2*>(out + (size_t)m * G + n) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
}

// Kernel 3, pass 3, tensor-core path: dw = every partial sum added in a fixed
// order (splits of pass 2; sample tiles of the sweep's bias, prototype and z
// parts), laid out per layer and direction as [dW_ih; dW_hh; db] x 4H.
__global__ void train_bwd_assemble_kernel(const float* __restrict__ ws,
                                          const float* __restrict__ wsb,
                                          const float* __restrict__ wsp,
                                          const float* __restrict__ wsz, float* __restrict__ dw,
                                          int H, int Z, int layers, int splits, int tiles) {
  const int G = 4 * H;
  const size_t first = (size_t)2 * (2 + Z + H + 1) * G;
  const size_t rest = (size_t)2 * (3 * H + 1) * G;
  const size_t total = first + (layers - 1) * rest;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int layer = idx < first ? 0 : 1 + (int)((idx - first) / rest);
    const size_t rem = idx < first ? idx : (idx - first) % rest;
    const int din = layer == 0 ? 2 + Z : 2 * H;
    const int M = din + H + 1;
    const int dir = (int)(rem / ((size_t)M * G));
    const int m = (int)((rem % ((size_t)M * G)) / G);
    const int n = (int)(rem % G);
    const int kd = layer * 2 + dir;
    float s = 0.0f;
    if (m == din + H) {
      for (int t = 0; t < tiles; ++t) s += wsb[((size_t)t * layers * 2 + kd) * G + n];
    } else if (layer == 0 && m < 2) {
      for (int t = 0; t < tiles; ++t) s += wsp[((size_t)(t * 2 + dir) * 2 + m) * G + n];
    } else if (layer == 0 && m < din) {
      for (int t = 0; t < tiles; ++t) s += wsz[((size_t)(t * 2 + dir) * Z + m - 2) * G + n];
    } else {
      const int row = m < din ? m : 2 * H + m - din;
      for (int z = 0; z < splits; ++z)
        s += ws[(((size_t)z * layers * 2 + kd) * 3 * H + row) * G + n];
    }
    dw[idx] = s;
  }
}

template <int HT>
int launch_fwd_mma(const void* proto, const float* z, const void* wq, const float* wf, void* res,
                   void* out, int B, int L, int Z, int layers, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem_bytes<HT>();
  cudaError_t err = cudaFuncSetAttribute(train_fwd_mma_kernel<HT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + kSampleTile - 1) / kSampleTile;
  train_fwd_mma_kernel<HT><<<tiles, 128 * HT, smem, stream>>>(
      static_cast<const bf16*>(proto), z, static_cast<const bf16*>(wq), wf,
      static_cast<bf16*>(res), static_cast<bf16*>(out), B, L, Z, layers);
  return static_cast<int>(cudaGetLastError());
}

template <int HT>
int launch_bwd_mma(const void* res, const void* dyT, const void* proto, const void* zq,
                   const void* wq, void* dg, void* dxbuf, void* dpa, float* dz, float* ws,
                   float* wsb, float* wsp, float* wsz, float* dw, int B, int L, int Z, int layers,
                   int splits, cudaStream_t stream) {
  constexpr int H = 16 * HT;
  const int tiles = (B + kSampleTile - 1) / kSampleTile;
  const bf16* res_t = static_cast<const bf16*>(res);
  {
    const size_t smem = sweep_mma_smem_bytes<HT>();
    cudaError_t err = cudaFuncSetAttribute(train_bwd_sweep_mma_kernel<HT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    train_bwd_sweep_mma_kernel<HT><<<tiles, 128 * HT, smem, stream>>>(
        res_t, static_cast<const bf16*>(dyT), static_cast<const bf16*>(proto),
        static_cast<const bf16*>(zq), static_cast<const bf16*>(wq), static_cast<bf16*>(dg),
        static_cast<bf16*>(dxbuf), static_cast<bf16*>(dpa), dz, wsb, wsp, wsz, B, L, Z, layers);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    const size_t smem = wgrad_mma_smem_bytes<HT>();
    cudaError_t err = cudaFuncSetAttribute(train_bwd_wgrad_mma_kernel<HT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int pos_per_split = (L + splits - 1) / splits;
    train_bwd_wgrad_mma_kernel<HT><<<dim3(layers * 2, splits), kWgThreads, smem, stream>>>(
        res_t, static_cast<const bf16*>(dg), ws, B, L, tiles, pos_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t total =
      (size_t)2 * ((2 + Z + H + 1) + (size_t)(layers - 1) * (3 * H + 1)) * 4 * H;
  const size_t wanted = (total + 255) / 256;
  const int blocks = wanted < 4096 ? (int)wanted : 4096;
  train_bwd_assemble_kernel<<<blocks, 256, 0, stream>>>(ws, wsb, wsp, wsz, dw, H, Z, layers,
                                                        splits, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// The float32 path: float32 at H = 16 * HT (HT = 1, 2, 3), S = 4 or 8 samples
// per cluster of two CTAs. See the note at the head of this file.
// ===========================================================================

// Kernel 2, float32 path: the shared float32 recurrence (bilstm_step.cuh:
// fp32_stack) with its residual rows. Same sums in the same order as the
// float32 inference kernel: the output is bit-equal to kernel 1's at the same
// sample tile.
//   proto (B, L, 2) f32; z (B, Z) f32; wf: the packed weights in f32;
//   res (layers, 2, L, B, 6H) f32; out (B, L, 2H) f32; scratch as kernel 1's.
template <int HT, int S>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(128 * HT, 1)
    train_fwd_fp32_kernel(const float* __restrict__ proto, const float* __restrict__ z,
                          const float* __restrict__ wf, float* res, float* out, float* scratch,
                          int B, int L, int Z, int layers) {
  fp32_stack<HT, S, true>(proto, z, wf, out, scratch, res, B, L, Z, layers);
}

constexpr int kFpInStages = 6;  // ring of residual / dy rows ahead of the float32 sweep
constexpr int kFpDgStages = 3;  // ring of gate-gradient rows behind it

// Row strides (floats) of the float32 sweep's staged rows, 16 bytes past
// their width so the four samples a warp touches fall in different banks:
// residual rows (6H: the forward's fp32_stage_row), dy / input-gradient rows
// (H). Gate-gradient rows (also the layout of the `gates` rows in global
// memory) hold each gate's H values in a block of H + 4, so the four gate
// blocks the four quarters of a unit read at once fall in different banks,
// and the row in 4 (H + 4) + 20 = 4H + 36 floats, again 16 bytes past a
// multiple of 128.
template <int HT>
__host__ __device__ constexpr int fp32_dx_stride() { return 16 * HT + 4; }
template <int HT>
__host__ __device__ constexpr int fp32_gate_block() { return 16 * HT + 4; }
template <int HT>
__host__ __device__ constexpr int fp32_gate_stride() { return 4 * 16 * HT + 36; }

template <int HT, int S>
constexpr size_t sweep_fp32_smem_bytes() {
  constexpr int H = 16 * HT;
  return (size_t)kFpInStages * S * fp32_stage_row<HT>() * 4        // residual rows
         + (size_t)kFpInStages * 2 * S * fp32_dx_stride<HT>() * 4   // dy rows (two streams)
         + (size_t)kFpDgStages * S * fp32_gate_stride<HT>() * 4     // gate gradients
         + (size_t)4 * H * S * 4                                     // per-sample sums
         + (size_t)2 * (kFpInStages + kFpDgStages) * 8;              // mbarriers
}

// ---------------------------------------------------------------------------
// Kernel 3, pass 1, float32 path: the reverse sweep. A cluster of two CTAs =
// S samples through all layers, top down, CTA rank = direction. Threads
// 0 .. 4H-1 are the chain, 4H .. 8H-1 the side; thread (unit, kq) = (index /
// 4, index % 4) within either.
//   * chain thread (unit, kq) holds W_hh[unit, kq H .. kq H + H) (the unit's
//     row against gate kq's columns) and, for its S / 4 samples, carries dh
//     and dc: per step it reads its unit's residual values and dy, computes
//     the four gate gradients, writes them to the gate-gradient ring, and
//     after the chain's barrier takes dh = W_hh . dg as four partial sums
//     over the gates added by the forward's two shuffle rounds;
//   * side thread (unit, kq) holds W_ih[k, kq H .. kq H + H) for k = unit and
//     H + unit (layer 1: the prototype's two rows, unit 0 only) and takes
//     the ring's gate gradients behind the chain: dx = W_ih . dg into this
//     direction's stream of the gradient passed down (layer 1: the prototype
//     stream), and at layer 1 the prototype rows of dW_ih for column
//     kq H + unit. Its thread 0 copies each step's gate gradients out (one
//     bulk store, for the weight-gradient product); its first warp keeps the
//     input ring full (per position: the tile's residual rows, one bulk copy
//     a sample, and the dy rows of this direction, one or two copies);
//   * between layers both CTAs meet at a cluster barrier: the input gradient
//     streams they wrote are the layer below's dy. Per-layer sums over the
//     tile (db, and at layer 1 dz and z^T . sum_t dg) come from the chain's
//     per-sample sums over t; dz adds direction 1's part to direction 0's.
//   res (layers, 2, L, B, 6H) f32; dyh (2 halves, tiles, L, S, DX) f32: the
//   top layer's cotangent, half d the features of direction d; proto (B, L,
//   2), zq (B, Z) f32; wf: the packed weights in f32;
//   gates (layers*2, L, tiles*S, GS) f32: every gate gradient;
//   dxbuf (2 ping-pong, 2 streams, 2 halves, tiles, L, S, DX) f32;
//   dpa (2, B, L, 2) f32; dz (B, Z) f32, dzp (B, Z) f32 scratch;
//   wsb (tiles, layers*2, 4H), wsp (tiles, 2, 2, 4H), wsz (tiles, 2, Z, 4H).
// ---------------------------------------------------------------------------
template <int HT, int S>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(128 * HT, 1)
    train_bwd_sweep_fp32_kernel(const float* __restrict__ res, const float* __restrict__ dyh,
                                const float* __restrict__ proto, const float* __restrict__ zq,
                                const float* __restrict__ wf, float* gates, float* dxbuf,
                                float* dpa, float* dz, float* dzp, float* wsb, float* wsp,
                                float* wsz, int B, int L, int Z, int layers) {
  constexpr int H = 16 * HT, G = 4 * H, SQ = S / 4, RI = kFpInStages, RD = kFpDgStages;
  constexpr int RS = fp32_stage_row<HT>(), DX = fp32_dx_stride<HT>(), GS = fp32_gate_stride<HT>();
  constexpr int GB = fp32_gate_block<HT>();
  constexpr int kRole = 4 * H;  // threads of either role
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* res_ring = reinterpret_cast<float*>(smem_raw);           // [RI][S][RS]
  float* dy_ring = res_ring + RI * S * RS;                         // [RI][2][S][DX]
  float* dg_ring = dy_ring + RI * 2 * S * DX;                      // [RD][S][GS]
  float* sums = dg_ring + RD * S * GS;                             // [G][S]
  uint64_t* full_in = reinterpret_cast<uint64_t*>(sums + G * S);  // [RI]
  uint64_t* empty_in = full_in + RI;                               // [RI]
  uint64_t* full_dg = empty_in + RI;                               // [RD]
  uint64_t* empty_dg = full_dg + RD;                               // [RD]

  const int tid = threadIdx.x;
  const bool side = tid >= kRole;
  const int rt = side ? tid - kRole : tid;
  const int unit = rt >> 2, kq = rt & 3;
  const int dir = blockIdx.x & 1;
  const int tile = blockIdx.x >> 1;
  const int tiles = gridDim.x >> 1;
  const int b0 = tile * S;
  const int nb = min(S, B - b0);
  const int s0 = (S / 2) * (kq & 1) + SQ * (kq >> 1);  // the thread's first sample
  const bool loader = side && rt < 32;

  // Rows of samples past B are never loaded: zero them once so that their
  // gate gradients are exact zeros.
  for (int i = tid; i < RI * S * RS; i += blockDim.x) res_ring[i] = 0.0f;
  if (tid == 0) {
    for (int i = 0; i < RI; ++i) {
      mbar_init(full_in + i, 1);
      mbar_init(empty_in + i, kRole);
    }
    for (int i = 0; i < RD; ++i) {
      mbar_init(full_dg + i, kRole);
      mbar_init(empty_dg + i, kRole);
    }
    mbar_init_fence();
  }
  fence_async_shared();
  __syncthreads();

  // The (S, DX) block of rows of one position in the input-gradient buffers.
  auto dx_block = [&](int pp, int stream, int half, int pos) {
    return dxbuf + ((((size_t)(pp * 2 + stream) * 2 + half) * tiles + tile) * L + pos) * S * DX;
  };

  for (int layer = layers - 1; layer >= 0; --layer) {
    const bool top = layer == layers - 1;
    const CellOffsets off = cell_offsets(layer, dir, H, Z);
    const int it0 = (layers - 1 - layer) * L;
    const int kd = layer * 2 + dir;
    const int pin = (layer + 1) & 1, pout = layer & 1;  // the input-gradient ping-pong

    // One position's rows into input slot it % RI (the first side warp).
    auto start_loads = [&](int u) {
      const int it = it0 + u;
      const int slot = it % RI;
      const int pos = dir ? u : L - 1 - u;
      mbar_wait(empty_in + slot, ((it / RI) & 1) ^ 1);
      const uint32_t rows = (uint32_t)nb * 6 * H * 4, dys = S * DX * 4;
      if (rt == 0) mbar_arrive_expect_tx(full_in + slot, rows + (top ? 1u : 2u) * dys);
      __syncwarp();
      if (rt < nb)
        bulk_load(res_ring + ((size_t)slot * S + rt) * RS,
                  res + res_row(layer, dir, pos, b0 + rt, L, B, H), 6 * H * 4, full_in + slot);
      if (rt == 0) {
        float* dyd = dy_ring + (size_t)slot * 2 * S * DX;
        if (top) {
          bulk_load(dyd, dyh + (((size_t)dir * tiles + tile) * L + pos) * S * DX, dys,
                    full_in + slot);
        } else {
          bulk_load(dyd, dx_block(pin, 0, dir, pos), dys, full_in + slot);
          bulk_load(dyd + S * DX, dx_block(pin, 1, dir, pos), dys, full_in + slot);
        }
      }
    };

    if (side) {
      // ---- off the chain: copies in and out, dx = W_ih . dg, the prototype's parts ----
      // At layer 1 only unit 0 has rows; the rest of its warp multiplies
      // zeros, since the shuffles of the sum need the whole warp.
      const bool first = layer == 0;
      const bool works = !first || rt < 32;
      float w[2][H];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = first ? r : r * H + unit;
#pragma unroll
        for (int i = 0; i < H; ++i)
          w[r][i] = !first || unit == 0 ? __ldg(wf + off.w_ih + (size_t)k * G + kq * H + i) : 0.0f;
      }
      float dwp[2] = {0.0f, 0.0f};  // layer 1: sum over (t, tile) of proto . dg, column kq H + unit
      if (loader) {
        fence_async_all();  // the layer above's input gradients were written with plain stores
        for (int u = 0; u < RI - 1 && u < L; ++u) start_loads(u);
      }
      for (int u = 0; u < L; ++u) {
        const int it = it0 + u;
        const int pos = dir ? u : L - 1 - u;
        if (loader && u + RI - 1 < L) start_loads(u + RI - 1);
        const int slot = it % RD;
        const float* dgs = dg_ring + (size_t)slot * S * GS;
        mbar_wait(full_dg + slot, (it / RD) & 1);
        if (rt == 0) {
          bulk_store(gates + (((size_t)kd * L + pos) * tiles * S + b0) * GS, dgs, S * GS * 4);
          bulk_commit();
        }
        if (works) {
          float acc[2][S];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int s = 0; s < S; ++s) acc[r][s] = 0.0f;
          quarter_product<H, S, 2>(acc, w, dgs + kq * GB, GS);
          float v[2][SQ];
          reduce_quarters<S, 2>(acc, kq, v);
#pragma unroll
          for (int j = 0; j < SQ; ++j) {
            const int s = s0 + j;
            if (!first) {
              dx_block(pout, dir, 0, pos)[s * DX + unit] = v[0][j];
              dx_block(pout, dir, 1, pos)[s * DX + unit] = v[1][j];
            } else if (unit == 0 && b0 + s < B) {
              *reinterpret_cast<float2*>(dpa + (size_t)dir * B * L * 2 +
                                         ((size_t)(b0 + s) * L + pos) * 2) =
                  make_float2(v[0][j], v[1][j]);
            }
          }
        }
        if (first) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            float2 p = make_float2(0.0f, 0.0f);
            if (b0 + s < B)
              p = __ldg(reinterpret_cast<const float2*>(proto + ((size_t)(b0 + s) * L + pos) * 2));
            const float g = dgs[s * GS + kq * GB + unit];
            dwp[0] = fmaf(p.x, g, dwp[0]);
            dwp[1] = fmaf(p.y, g, dwp[1]);
          }
        }
        if (rt == 0) bulk_wait_read();  // the step's copy out has read the slot
        mbar_arrive(empty_dg + slot);
      }
      if (first) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wsp[((size_t)(tile * 2 + dir) * 2 + c) * G + kq * H + unit] = dwp[c];
      }
      if (rt == 0) bulk_wait_all();
    } else {
      // ---- the dependent chain ----
      float w[1][H];
#pragma unroll
      for (int i = 0; i < H; ++i) w[0][i] = __ldg(wf + off.w_hh + (size_t)unit * G + kq * H + i);
      float dh[SQ], dc[SQ], dgsum[4][SQ];
#pragma unroll
      for (int j = 0; j < SQ; ++j) {
        dh[j] = dc[j] = 0.0f;
#pragma unroll
        for (int g = 0; g < 4; ++g) dgsum[g][j] = 0.0f;
      }
      for (int u = 0; u < L; ++u) {
        const int it = it0 + u;
        const int slot_in = it % RI;
        const int slot = it % RD;
        const bool has_prev = u + 1 < L;
        mbar_wait(full_in + slot_in, (it / RI) & 1);
        if (has_prev) mbar_wait(full_in + (it + 1) % RI, ((it + 1) / RI) & 1);
        const float* rows = res_ring + (size_t)slot_in * S * RS;
        const float* prev_rows = res_ring + (size_t)((it + 1) % RI) * S * RS;
        const float* dys = dy_ring + (size_t)slot_in * 2 * S * DX;
        float v[4][SQ];
#pragma unroll
        for (int j = 0; j < SQ; ++j) {
          const int s = s0 + j;
          const float* row = rows + s * RS + unit;
          const float c_t = row[H], ig = row[2 * H], fg = row[3 * H], gg = row[4 * H],
                      og = row[5 * H];
          const float c_prev = has_prev ? prev_rows[s * RS + H + unit] : 0.0f;
          const float dyv = top ? dys[s * DX + unit] : dys[s * DX + unit] + dys[(S + s) * DX + unit];
          const float dhv = dh[j] + dyv;
          const float tc = tanhf(c_t);
          const float dov = dhv * tc;
          const float dcv = dc[j] + dhv * og * (1.0f - tc * tc);
          v[0][j] = dcv * gg * ig * (1.0f - ig);
          v[1][j] = dcv * c_prev * fg * (1.0f - fg);
          v[2][j] = dcv * ig * (1.0f - gg * gg);
          v[3][j] = dov * og * (1.0f - og);
          dc[j] = dcv * fg;
        }
        mbar_arrive(empty_in + slot_in);
        mbar_wait(empty_dg + slot, ((it / RD) & 1) ^ 1);
        float* dgo = dg_ring + (size_t)slot * S * GS;
#pragma unroll
        for (int j = 0; j < SQ; ++j)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            dgo[(s0 + j) * GS + g * GB + unit] = v[g][j];
            dgsum[g][j] += v[g][j];
          }
        fence_async_shared();                  // the slot is copied out by a bulk store
        mbar_arrive(full_dg + slot);           // to the side threads
        named_barrier(1, kRole);               // the tile's gate gradients are in the slot
        float acc[1][S];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[0][s] = 0.0f;
        quarter_product<H, S, 1>(acc, w, dgo + kq * GB, GS);
        float red[1][SQ];
        reduce_quarters<S, 1>(acc, kq, red);
#pragma unroll
        for (int j = 0; j < SQ; ++j) dh[j] = red[0][j];
      }
#pragma unroll
      for (int j = 0; j < SQ; ++j)
#pragma unroll
        for (int g = 0; g < 4; ++g) sums[(g * H + unit) * S + s0 + j] = dgsum[g][j];
    }
    // Both directions' input gradients are written before either CTA's next
    // layer loads them (with bulk copies: the async proxy); the sums are in.
    __threadfence();
    fence_async_all();
    cluster_sync();
    // The bias gradient's part of this tile: the sum over its samples.
    for (int i = tid; i < G; i += blockDim.x) {
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < S; ++e) s += sums[i * S + e];
      wsb[((size_t)tile * layers * 2 + kd) * G + i] = s;
    }
    if (layer == 0) {
      // This direction's part of dz = W_z . sum_t dg per sample (direction 0
      // into dz, direction 1 into dzp), and its part of dW_z = z^T . sum_t dg.
      for (int i = tid; i < nb * Z; i += blockDim.x) {
        const int s = i / Z, k = i % Z;
        const float* wrow = wf + off.w_ih + (size_t)(2 + k) * G;
        float acc = 0.0f;
        for (int n = 0; n < G; ++n) acc = fmaf(__ldg(wrow + n), sums[n * S + s], acc);
        (dir ? dzp : dz)[(size_t)(b0 + s) * Z + k] = acc;
      }
      for (int i = tid; i < Z * G; i += blockDim.x) {
        const int k = i / G, n = i % G;
        float acc = 0.0f;
        for (int s = 0; s < nb; ++s)
          acc = fmaf(__ldg(zq + (size_t)(b0 + s) * Z + k), sums[n * S + s], acc);
        wsz[((size_t)(tile * 2 + dir) * Z + k) * G + n] = acc;
      }
    }
    __syncthreads();  // the sums are free for the next layer
  }
  __threadfence();
  cluster_sync();  // direction 1's part of dz is written
  if (dir == 0)
    for (int i = tid; i < nb * Z; i += blockDim.x)
      dz[(size_t)b0 * Z + i] += dzp[(size_t)b0 * Z + i];
}

constexpr int kFwStages = 3;  // cp.async ring of the float32 weight-gradient product
constexpr int kFwRows = 32;   // rows of the sum per stage

template <int HT>
constexpr size_t wgrad_fp32_smem_bytes() {
  return (size_t)kFwStages * kFwRows * 5 * 16 * HT * 4;  // [lhs part (H) | gate grads (4H)]
}

// ---------------------------------------------------------------------------
// Kernel 3, pass 2, float32 path. Per (layer, direction) kd, part p of the
// left operand and split of the rows r = pos * Bp + b (Bp = tiles * S):
// ws[split, kd, p H .. p H + H) (H x 4H) = lhs_p^T . dg over the split's
// rows, where lhs_0 / lhs_1 are the h planes of the layer below (forward /
// backward) at pos and lhs_2 this layer's h one step earlier: 16-byte
// cp.async copies of residual-row planes (zero fill past the batch and the
// ends) and of the gate-gradient rows, kFwStages deep, no per-element
// gather. Layer 1's input rows (the prototype, z) and the bias row are
// summed by the sweep. Grid (3, layers * 2, splits), the three parts of one
// (kd, split) next to each other so their shared gate-gradient rows are read
// from L2; 4H threads, (H / 4 row groups) x 16 column groups, each 4 rows x
// H / 4 columns (4 tx + 64 j .. + 3), full float32 FMAs.
// ---------------------------------------------------------------------------
template <int HT>
__global__ void __launch_bounds__(64 * HT)
    train_bwd_wgrad_fp32_kernel(const float* __restrict__ res, const float* __restrict__ gates,
                                float* __restrict__ ws, int B, int L, int Bp,
                                int rows_per_split) {
  constexpr int H = 16 * HT, G = 4 * H, GS = fp32_gate_stride<HT>(), NJ = H / 16;
  constexpr int GB = fp32_gate_block<HT>();
  constexpr int NT = 64 * HT;
  constexpr int STAGE = kFwRows * 5 * H;  // floats per stage: [rows][H] then [rows][G]
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int part = blockIdx.x, kd = blockIdx.y, split = blockIdx.z;
  const int layer = kd >> 1, dir = kd & 1;
  if (layer == 0 && part < 2) return;  // layer 1's input rows come from the sweep
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int K = L * Bp;
  const int r_begin = split * rows_per_split;
  const int r_end = min(K, r_begin + rows_per_split);
  const int n_iter = r_end > r_begin ? (r_end - r_begin + kFwRows - 1) / kFwRows : 0;

  auto load = [&](int iter) {
    float* a = smem + (size_t)(iter % kFwStages) * STAGE;
    float* g = a + kFwRows * H;
    const int r0 = r_begin + iter * kFwRows;
    for (int i = tid; i < kFwRows * (H / 4); i += NT) {
      const int row = i / (H / 4), ch = i % (H / 4);
      const int r = r0 + row;
      const int pos = r / Bp, b = r - pos * Bp;
      bool valid = r < r_end && b < B;
      size_t src = 0;
      if (part < 2) {
        if (valid) src = res_row(layer - 1, part, pos, b, L, B, H);
      } else {
        const int prev = dir ? pos + 1 : pos - 1;
        valid = valid && prev >= 0 && prev < L;
        if (valid) src = res_row(layer, dir, prev, b, L, B, H);
      }
      cp_async16(a + row * H + ch * 4, res + src + ch * 4, valid);
    }
    for (int i = tid; i < kFwRows * (G / 4); i += NT) {
      const int row = i / (G / 4), ch = i % (G / 4);
      const int r = r0 + row;
      const bool valid = r < r_end;
      // Gate ch / (H / 4) of the row sits in its own block of GB floats.
      cp_async16(g + row * G + ch * 4,
                 gates + ((size_t)kd * K + (valid ? r : 0)) * GS + ch / (H / 4) * GB +
                     ch % (H / 4) * 4,
                 valid);
    }
  };

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4 * NJ; ++n) acc[i][n] = 0.0f;

  for (int s = 0; s < kFwStages - 1; ++s) {
    if (s < n_iter) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int iter = 0; iter < n_iter; ++iter) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kFwStages - 2) : "memory");
    __syncthreads();  // stage iter has landed; stage iter - 1 is free
    if (iter + kFwStages - 1 < n_iter) load(iter + kFwStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* a = smem + (size_t)(iter % kFwStages) * STAGE;
    const float* g = a + kFwRows * H;
#pragma unroll 4
    for (int k = 0; k < kFwRows; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(a + k * H + 4 * ty);
      const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(g + k * G + 4 * tx + 64 * j);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * j] = fmaf(am[i], bv.x, acc[i][4 * j]);
          acc[i][4 * j + 1] = fmaf(am[i], bv.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(am[i], bv.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(am[i], bv.w, acc[i][4 * j + 3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  float* out = ws + ((size_t)split * gridDim.y + kd) * 3 * H * G;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(out + (size_t)(part * H + 4 * ty + i) * G + 4 * tx + 64 * j) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
}

template <int HT, int S>
int launch_fwd_fp32(const float* proto, const float* z, const float* wf, float* res, float* out,
                    float* scratch, int B, int L, int Z, int layers, cudaStream_t stream) {
  const size_t smem = fp32_stack_smem_bytes<HT, S, true>();
  cudaError_t err = cudaFuncSetAttribute(train_fwd_fp32_kernel<HT, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (B + S - 1) / S;
  train_fwd_fp32_kernel<HT, S><<<2 * tiles, 128 * HT, smem, stream>>>(proto, z, wf, res, out,
                                                                     scratch, B, L, Z, layers);
  return static_cast<int>(cudaGetLastError());
}

template <int HT, int S>
int launch_bwd_fp32(const float* res, const float* dyh, const float* proto, const float* zq,
                    const float* wf, float* gates, float* dxbuf, float* dpa, float* dz, float* dzp,
                    float* ws, float* wsb, float* wsp, float* wsz, float* dw, int B, int L, int Z,
                    int layers, int splits, cudaStream_t stream) {
  constexpr int H = 16 * HT;
  const int tiles = (B + S - 1) / S;
  {
    const size_t smem = sweep_fp32_smem_bytes<HT, S>();
    cudaError_t err = cudaFuncSetAttribute(train_bwd_sweep_fp32_kernel<HT, S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    train_bwd_sweep_fp32_kernel<HT, S><<<2 * tiles, 128 * HT, smem, stream>>>(
        res, dyh, proto, zq, wf, gates, dxbuf, dpa, dz, dzp, wsb, wsp, wsz, B, L, Z, layers);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    const size_t smem = wgrad_fp32_smem_bytes<HT>();
    cudaError_t err = cudaFuncSetAttribute(train_bwd_wgrad_fp32_kernel<HT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int K = L * tiles * S;
    int rows = (K + splits - 1) / splits;
    rows = (rows + kFwRows - 1) / kFwRows * kFwRows;
    train_bwd_wgrad_fp32_kernel<HT><<<dim3(3, layers * 2, splits), 64 * HT, smem, stream>>>(
        res, gates, ws, B, L, tiles * S, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t total =
      (size_t)2 * ((2 + Z + H + 1) + (size_t)(layers - 1) * (3 * H + 1)) * 4 * H;
  const size_t wanted = (total + 255) / 256;
  const int blocks = wanted < 4096 ? (int)wanted : 4096;
  train_bwd_assemble_kernel<<<blocks, 256, 0, stream>>>(ws, wsb, wsp, wsz, dw, H, Z, layers,
                                                        splits, tiles);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int L, int H, int Z, int layers) {
  return B < 1 || L < 1 || H < 1 || Z < 0 || layers < 1 || 2 * H * kSampleGroups > 1024;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of its
// launches (0 on success), cudaErrorInvalidValue for a shape it does not take
// (H > 256: 2H threads per sample group). Kernels run on `stream` and are not
// synchronised; every buffer is allocated by the caller.
int wgg_bilstm_train_fwd(const void* proto, const float* z, const void* wseq1, const float* wz,
                         const void* whh, const void* wih, const float* bias, void* res,
                         void* out, int B, int L, int H, int Z, int layers, int dtype,
                         void* stream) {
  if (bad_shape(B, L, H, Z, layers)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(proto, z, wseq1, wz, whh, wih, bias, res, out, B, L, H, Z, layers, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(proto, z, wseq1, wz, whh, wih, bias, res, out, B, L, H, Z,
                                     layers, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ws: (splits, layers*2, m_max, 4H) f32 scratch, m_max = max(2+Z+H+1, 3H+1)
// (2+Z+H+1 for one layer); dw: the per-(layer, direction) matrices
// [dW_ih; dW_hh; db] of (din + H + 1) x 4H, din = 2+Z for layer 1, 2H above.
int wgg_bilstm_train_bwd(const void* res, const void* dy, const void* proto, const void* zq,
                         const void* whhT, const void* wihT, const void* wpT, const void* wz,
                         float* gates, void* dxbuf, void* dpa, float* dz, float* ws, float* dw,
                         int B, int L, int H, int Z, int layers, int splits, int dtype,
                         void* stream) {
  if (bad_shape(B, L, H, Z, layers) || splits < 1 || (long long)L * B > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(res, dy, proto, zq, whhT, wihT, wpT, wz, gates, dxbuf, dpa, dz, ws,
                             dw, B, L, H, Z, layers, splits, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(res, dy, proto, zq, whhT, wihT, wpT, wz, gates, dxbuf, dpa,
                                     dz, ws, dw, B, L, H, Z, layers, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core path: bfloat16 only, H in {16, 32, 48} (the wrapper's
// dispatch rule; anything else returns cudaErrorInvalidValue). wq / wf are the
// packed weights (bilstm_step.cuh) in bf16 and f32.
int wgg_bilstm_train_fwd_mma(const void* proto, const float* z, const void* wq, const float* wf,
                             void* res, void* out, int B, int L, int H, int Z, int layers,
                             void* stream) {
  if (bad_shape(B, L, H, Z, layers)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 16) return launch_fwd_mma<1>(proto, z, wq, wf, res, out, B, L, Z, layers, s);
  if (H == 32) return launch_fwd_mma<2>(proto, z, wq, wf, res, out, B, L, Z, layers, s);
  if (H == 48) return launch_fwd_mma<3>(proto, z, wq, wf, res, out, B, L, Z, layers, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dyT (L, B, 2H) bf16; dg (layers*2, L, tiles, 2, 4H, 8) bf16 with tiles =
// ceil(B / 8); ws (splits, layers*2, 3H, 4H) f32, splits <= L; wsb (tiles,
// layers*2, 4H), wsp (tiles, 2, 2, 4H), wsz (tiles, 2, Z, 4H) f32; dw as for
// wgg_bilstm_train_bwd.
int wgg_bilstm_train_bwd_mma(const void* res, const void* dyT, const void* proto, const void* zq,
                             const void* wq, void* dg, void* dxbuf, void* dpa, float* dz,
                             float* ws, float* wsb, float* wsp, float* wsz, float* dw, int B,
                             int L, int H, int Z, int layers, int splits, void* stream) {
  if (bad_shape(B, L, H, Z, layers) || splits < 1 || splits > L ||
      (long long)L * B > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGG_BWD_MMA(HT)                                                                        \
  return launch_bwd_mma<HT>(res, dyT, proto, zq, wq, dg, dxbuf, dpa, dz, ws, wsb, wsp, wsz, dw, \
                            B, L, Z, layers, splits, s)
  if (H == 16) WGG_BWD_MMA(1);
  if (H == 32) WGG_BWD_MMA(2);
  if (H == 48) WGG_BWD_MMA(3);
#undef WGG_BWD_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per CTA (info[0]), threads per CTA (info[1]) and
// resident CTAs per SM (info[2]) of a tensor-core kernel: 0 = forward,
// 1 = sweep, 2 = weight-gradient product. Returns a cudaError_t.
int wgg_bilstm_train_mma_info(int H, int kernel, int* info) {
#define WGG_INFO(FN, SMEM, THREADS)                                                            \
  {                                                                                            \
    info[0] = (int)(SMEM);                                                                     \
    info[1] = (THREADS);                                                                       \
    cudaError_t err =                                                                          \
        cudaFuncSetAttribute(FN, cudaFuncAttributeMaxDynamicSharedMemorySize, info[0]);        \
    if (err == cudaSuccess)                                                                    \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], FN, info[1], info[0]);     \
    return static_cast<int>(err);                                                              \
  }
#define WGG_INFO_HT(HT)                                                                        \
  {                                                                                            \
    if (kernel == 0) WGG_INFO(train_fwd_mma_kernel<HT>, fwd_mma_smem_bytes<HT>(), 128 * HT)    \
    if (kernel == 1)                                                                           \
      WGG_INFO(train_bwd_sweep_mma_kernel<HT>, sweep_mma_smem_bytes<HT>(), 128 * HT)           \
    if (kernel == 2)                                                                           \
      WGG_INFO(train_bwd_wgrad_mma_kernel<HT>, wgrad_mma_smem_bytes<HT>(), kWgThreads)         \
  }
  if (H == 16) WGG_INFO_HT(1)
  if (H == 32) WGG_INFO_HT(2)
  if (H == 48) WGG_INFO_HT(3)
#undef WGG_INFO_HT
#undef WGG_INFO
  return static_cast<int>(cudaErrorInvalidValue);
}

// The float32 path: float32 only, H in {16, 32, 48}, `tile` = 4 or 8 samples
// per cluster (the wrapper's rule; anything else returns
// cudaErrorInvalidValue). wf: the packed weights in f32; scratch as for the
// float32 inference kernel, (min(layers - 1, 2), ceil(B / tile), L, tile, 2H).
int wgg_bilstm_train_fwd_fp32(const float* proto, const float* z, const float* wf, float* res,
                              float* out, float* scratch, int B, int L, int H, int Z, int layers,
                              int tile, void* stream) {
  if (bad_shape(B, L, H, Z, layers)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGG_FWD_FP32(HT)                                                                     \
  {                                                                                          \
    if (tile == 8) return launch_fwd_fp32<HT, 8>(proto, z, wf, res, out, scratch, B, L, Z, layers, s); \
    if (tile == 4) return launch_fwd_fp32<HT, 4>(proto, z, wf, res, out, scratch, B, L, Z, layers, s); \
  }
  if (H == 16) WGG_FWD_FP32(1)
  if (H == 32) WGG_FWD_FP32(2)
  if (H == 48) WGG_FWD_FP32(3)
#undef WGG_FWD_FP32
  return static_cast<int>(cudaErrorInvalidValue);
}

// With T = tiles * tile and DX = H + 4, GS = 4H + 36: dyh (2, tiles, L, tile,
// DX) f32; gates (layers*2, L, T, GS) f32; dxbuf (2, 2, 2, tiles, L, tile,
// DX) f32 (unused by one layer); dpa (2, B, L, 2), dz and dzp (B, Z) f32; ws
// (splits, layers*2, 3H, 4H), wsb (tiles, layers*2, 4H), wsp (tiles, 2, 2,
// 4H), wsz (tiles, 2, Z, 4H) f32; dw as for wgg_bilstm_train_bwd.
int wgg_bilstm_train_bwd_fp32(const float* res, const float* dyh, const float* proto,
                              const float* zq, const float* wf, float* gates, float* dxbuf,
                              float* dpa, float* dz, float* dzp, float* ws, float* wsb, float* wsp,
                              float* wsz, float* dw, int B, int L, int H, int Z, int layers,
                              int splits, int tile, void* stream) {
  if (bad_shape(B, L, H, Z, layers) || splits < 1 || (long long)L * (B + tile) > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define WGG_BWD_FP32(HT, S)                                                                  \
  return launch_bwd_fp32<HT, S>(res, dyh, proto, zq, wf, gates, dxbuf, dpa, dz, dzp, ws, wsb,  \
                                wsp, wsz, dw, B, L, Z, layers, splits, s)
#define WGG_BWD_FP32_HT(HT)       \
  {                               \
    if (tile == 8) WGG_BWD_FP32(HT, 8); \
    if (tile == 4) WGG_BWD_FP32(HT, 4); \
  }
  if (H == 16) WGG_BWD_FP32_HT(1)
  if (H == 32) WGG_BWD_FP32_HT(2)
  if (H == 48) WGG_BWD_FP32_HT(3)
#undef WGG_BWD_FP32_HT
#undef WGG_BWD_FP32
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per CTA (info[0]), threads per CTA (info[1]) and
// resident CTAs per SM (info[2]) of a float32-path kernel at this H and
// sample tile: 0 = forward, 1 = sweep, 2 = weight-gradient product (which
// has no sample tile). Returns a cudaError_t.
int wgg_bilstm_train_fp32_info(int H, int tile, int kernel, int* info) {
#define WGG_INFO(FN, SMEM, THREADS)                                                            \
  {                                                                                            \
    info[0] = (int)(SMEM);                                                                     \
    info[1] = (THREADS);                                                                       \
    cudaError_t err =                                                                          \
        cudaFuncSetAttribute(FN, cudaFuncAttributeMaxDynamicSharedMemorySize, info[0]);        \
    if (err == cudaSuccess)                                                                    \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], FN, info[1], info[0]);     \
    return static_cast<int>(err);                                                              \
  }
#define WGG_INFO_S(HT, S)                                                                       \
  {                                                                                             \
    if (kernel == 0)                                                                            \
      WGG_INFO((train_fwd_fp32_kernel<HT, S>), (fp32_stack_smem_bytes<HT, S, true>()), 128 * HT) \
    if (kernel == 1)                                                                            \
      WGG_INFO((train_bwd_sweep_fp32_kernel<HT, S>), (sweep_fp32_smem_bytes<HT, S>()), 128 * HT) \
    if (kernel == 2)                                                                            \
      WGG_INFO(train_bwd_wgrad_fp32_kernel<HT>, wgrad_fp32_smem_bytes<HT>(), 64 * HT)           \
  }
#define WGG_INFO_HT(HT)              \
  {                                  \
    if (tile == 8) WGG_INFO_S(HT, 8) \
    if (tile == 4) WGG_INFO_S(HT, 4) \
  }
  if (H == 16) WGG_INFO_HT(1)
  if (H == 32) WGG_INFO_HT(2)
  if (H == 48) WGG_INFO_HT(3)
#undef WGG_INFO_HT
#undef WGG_INFO_S
#undef WGG_INFO
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
