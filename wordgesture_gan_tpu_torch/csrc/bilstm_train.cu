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
// What bounds it on this card. Forward: as kernel 1 (a chain of 4 x 128
// dependent steps, each a small product from weights read through L1), plus
// the residual stream, 6H values per (layer, direction, step, sample): 302 MB
// in bf16 at B=512, ~0.09 ms of HBM time, small beside the chain. Backward:
// the same chain of dependent steps (dh and dc carries), each step three
// small products per sample (dh through W_hh^T, the input gradient through
// W_ih^T, both from the step's gate gradients), then the weight gradients:
// sum over (t, b) of [x | h_prev | 1]^T . dgates, a product with a 65,536-row
// inner dimension at B=512 (~29 GFLOP in fp32 for the flagship stack), on the
// fp32 CUDA cores here.
//
// Design (simple and right first; no wgmma/TMA yet):
//   * as kernel 1, one CTA owns a tile of samples through ALL layers, so the
//     recurrence carries, the input gradients passed between layers and dz
//     are per CTA and need no cross-CTA synchronisation; shared memory and
//     registers per CTA do not depend on B (the TPU backward's VMEM scratch
//     grew with B and did not compile at B=2048);
//   * thread (dir, unit) owns the four gates of one hidden unit of one
//     direction for kSamplesPerThread samples: the gate gradients of a unit
//     need no exchange; the step's 4H gate gradients of a sample go through
//     shared memory for the products with the transposed weights, which are
//     laid out so that a warp reads consecutive addresses;
//   * the gradient of layer k's input is stored per direction (two T
//     streams), so the two directions never write the same row; the layer
//     below adds the two in T when it reads them (ping-pong between layers);
//   * the weight gradients, the one sum over the batch, go in a second pass
//     (design (a)): the sweep writes the fp32 gate gradients of every
//     (layer, direction, position, sample) to global memory, and a tiled
//     split-K product reduces [x | h_prev | 1]^T . dgates into
//     [dW_ih; dW_hh; db] per layer and direction, the bias as the product
//     with a column of ones and dW_z as the product with z (constant over
//     t). The splits' partial sums go to a workspace and a third kernel adds
//     them in a fixed order, so the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// Offset of residual row (layer, dir, pos, b): res is (layers, 2, L, B, 6H).
__device__ __forceinline__ size_t res_row(int layer, int dir, int pos, int b, int L, int B,
                                          int H) {
  return ((((size_t)layer * 2 + dir) * L + pos) * B + b) * 6 * H;
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

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
