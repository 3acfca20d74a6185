// The BiLSTM forward step on Hopper's tensor cores, and the small device
// helpers (mbarriers, bulk copies, mma/ldmatrix wrappers, the packed weight
// layout) the fused BiLSTM kernels share.
//
// The step replaces the per-step body of the TPU kernels `_kernel`
// (wordgesture_gan_tpu/ops/bilstm_fused.py) and `_fwd_kernel`
// (wordgesture_gan_tpu/ops/bilstm_train.py): gates = x_t.W_ih + h.W_hh + b,
// the nonlinearities, c and h. The recurrence is a chain of layers x L
// dependent steps, so it is bound by the latency of one step, not by bytes or
// operations. The step here keeps only h.W_hh on that chain:
//   * samples are the narrow dimension of `mma.sync.m16n8k16` (bf16 in, fp32
//     accumulate): gates^T[4H, 8] = W_hh^T[4H, H] . h^T[H, 8], a tile of 8
//     samples per CTA;
//   * warp w of a direction owns hidden units 16w..16w+15: four 16-row tiles,
//     one per gate, so a thread's accumulators hold i, f, g and o of the same
//     (unit, sample) pairs and the cell update needs no exchange. Tile rows
//     r and r+8 (the two a thread holds) are units 2r and 2r+1, so a thread's
//     values for one sample are two neighbouring units: one 32-bit store;
//   * W_hh stays in registers as A fragments for the whole layer (4 gate
//     tiles x H/16 k-tiles x 4 = H registers a thread);
//   * h goes back through a double-buffered (8, H+8) bf16 tile in shared
//     memory (one 32-bit load per B-fragment register, conflict free), one
//     named barrier per step and direction.
// The input projection (x_t.W_ih + b, not on the chain) is produced up to
// kGxStages positions ahead by other warps with the same fragment layout
// (`produce_first_layer`, `produce_upper_layer`: `gate_product` with the W_ih
// fragments) and handed over in accumulator order through an mbarrier ring
// (`gx_publish`, `gx_take`). The inference kernel (bilstm_fused.cu) and the
// training forward (bilstm_train.cu) run this step from this one source; they
// differ in where the layer below's rows come from (`load_x`) and in what the
// chain stores after a step.
//
// Packed weights: one flat buffer holding, for layer 0.., direction fwd, bwd:
// w_ih (din, 4H), w_hh (H, 4H), b_ih (4H), b_hh (4H), each row-major as the
// model stores them (din = 2 + Z for layer 0, 2H above); once in float32 and
// once rounded to bf16 (ops/bilstm_fused.py:packed_weights).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgg {

typedef __nv_bfloat16 bf16;

constexpr int kSampleTile = 8;  // samples per CTA: the n of m16n8k16
constexpr int kGxStages = 4;    // ring of input projections ahead of the chain

// ---------------------------------------------------------------------------
// Packed weight layout
// ---------------------------------------------------------------------------

struct CellOffsets {
  size_t w_ih, w_hh, b_ih, b_hh;
  int din;
};

__host__ __device__ __forceinline__ CellOffsets cell_offsets(int layer, int dir, int H, int Z) {
  const size_t G = 4 * (size_t)H;
  const size_t first = (size_t)(2 + Z + H + 2) * G;
  const size_t rest = (size_t)(3 * H + 2) * G;
  CellOffsets o;
  o.din = layer == 0 ? 2 + Z : 2 * H;
  const size_t cell = layer == 0 ? first : rest;
  o.w_ih = (layer == 0 ? 0 : 2 * first + (size_t)(layer - 1) * 2 * rest) + (size_t)dir * cell;
  o.w_hh = o.w_ih + (size_t)o.din * G;
  o.b_ih = o.w_hh + (size_t)H * G;
  o.b_hh = o.b_ih + G;
  return o;
}

// Offset of residual row (layer, dir, pos, b): res is (layers, 2, L, B, 6H).
__device__ __forceinline__ size_t res_row(int layer, int dir, int pos, int b, int L, int B,
                                          int H) {
  return ((((size_t)layer * 2 + dir) * L + pos) * B + b) * 6 * H;
}

// ---------------------------------------------------------------------------
// Barriers and copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barrier over `threads` threads (ids 1..15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's shared-memory writes before later bulk (async proxy)
// copies that read them.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Orders this thread's writes (any space) before later async-proxy accesses.
__device__ __forceinline__ void fence_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Bulk copy global -> shared, `bytes` a multiple of 16, both 16-byte aligned;
// completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst_smem, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst_smem)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bulk copy shared -> global (one contiguous block), tracked by bulk groups.
__device__ __forceinline__ void bulk_store(void* dst, const void* src_smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src_smem)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Every committed bulk store has finished reading its shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Every committed bulk store has completed (its writes are visible).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Tensor-core wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16 x 16, row) . b (16 x 8, col); fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8 x 8 b16 matrices; lane i gives the address of row i % 8
// of matrix i / 8 (16 bytes a row).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// ---------------------------------------------------------------------------
// The forward step
// ---------------------------------------------------------------------------

// Sigmoid and tanh from one exponential and one fast division: absolute error
// of a few 1e-7, far inside the rounding of h and the residuals to bf16.
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 2.0f * sigmoid_fast(2.0f * x) - 1.0f;
}

// A fragments of W^T for the four gate tiles of units unit0..unit0+15, from a
// (K, 4H) row-major bf16 matrix W (w_hh: KT = H/16; w_ih above layer 1:
// KT = 2H/16). Tile g, k-tile kt: tile rows {r, r+8} are gate rows
// g*H + unit0 + {2r, 2r+1}; columns 16kt + {2q, 2q+1, 2q+8, 2q+9}
// (r = lane / 4, q = lane % 4).
template <int KT>
__device__ __forceinline__ void load_gate_fragments(uint32_t (&a)[4][KT][4], const bf16* w, int H,
                                                    int unit0, int lane) {
  const int r = lane >> 2, q = lane & 3;
  const size_t G = 4 * (size_t)H;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const size_t m = (size_t)g * H + unit0 + 2 * r;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const size_t k = (size_t)kt * 16 + 2 * q;
      a[g][kt][0] = pack_bf16(__ldg(w + k * G + m), __ldg(w + (k + 1) * G + m));
      a[g][kt][1] = pack_bf16(__ldg(w + k * G + m + 1), __ldg(w + (k + 1) * G + m + 1));
      a[g][kt][2] = pack_bf16(__ldg(w + (k + 8) * G + m), __ldg(w + (k + 9) * G + m));
      a[g][kt][3] = pack_bf16(__ldg(w + (k + 8) * G + m + 1), __ldg(w + (k + 9) * G + m + 1));
    }
  }
}

// acc[g] += W^T tile g . b: the step's product, KT k-tiles deep.
template <int KT>
__device__ __forceinline__ void gate_product(float (&acc)[4][4], const uint32_t (&a)[4][KT][4],
                                             const uint32_t (&b)[KT][2]) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int g = 0; g < 4; ++g) mma_bf16(acc[g], a[g][kt], b[kt][0], b[kt][1]);
}

// B fragments of h^T from the (8, H + 8) bf16 tile `hs` ([sample][unit]).
template <int HT>
__device__ __forceinline__ void load_h_fragments(uint32_t (&b)[HT][2], const bf16* hs, int lane) {
  constexpr int HS = 16 * HT + 8;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(hs + (lane >> 2) * HS) + (lane & 3);
#pragma unroll
  for (int kt = 0; kt < HT; ++kt) {
    b[kt][0] = row[kt * 8];
    b[kt][1] = row[kt * 8 + 4];
  }
}

// The cell update for a thread's four (unit, sample) pairs: pair j is unit
// unit0 + 2r + j / 2, sample 2q + j % 2. acc holds the gate sums and
// returns the gates after the nonlinearities; c is carried in fp32; h is
// rounded to bf16.
__device__ __forceinline__ void lstm_cell(float (&acc)[4][4], float (&c)[4], bf16 (&h)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float ig = sigmoid_fast(acc[0][j]);
    const float fg = sigmoid_fast(acc[1][j]);
    const float gg = tanh_fast(acc[2][j]);
    const float og = sigmoid_fast(acc[3][j]);
    c[j] = fg * c[j] + ig * gg;
    h[j] = __float2bfloat16_rn(og * tanh_fast(c[j]));
    acc[0][j] = ig;
    acc[1][j] = fg;
    acc[2][j] = gg;
    acc[3][j] = og;
  }
}

// ---------------------------------------------------------------------------
// The ring of input projections between a direction's producer warps and its
// chain warps. `gx` is the direction's [kGxStages][HT][4][32] float4 slots,
// `full` / `empty` its kGxStages mbarriers each (count: the 32 * HT threads of
// either side); `it` counts positions across layers, so the phase parity
// carries over the layer boundary.
// ---------------------------------------------------------------------------

// Hands one position's gate sums to the chain, in accumulator order.
template <int HT>
__device__ __forceinline__ void gx_publish(float4* gx, uint64_t* full, uint64_t* empty, int it,
                                           int w, int lane, const float (&acc)[4][4]) {
  const int slot = it % kGxStages;
  mbar_wait(empty + slot, ((it / kGxStages) & 1) ^ 1);
  float4* dst = gx + ((size_t)slot * HT + w) * 128 + lane;
#pragma unroll
  for (int g = 0; g < 4; ++g) dst[g * 32] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  mbar_arrive(full + slot);
}

// The chain's side: the position's gate sums into the accumulators.
template <int HT>
__device__ __forceinline__ void gx_take(const float4* gx, uint64_t* full, uint64_t* empty, int it,
                                        int w, int lane, float (&acc)[4][4]) {
  const int slot = it % kGxStages;
  mbar_wait(full + slot, (it / kGxStages) & 1);
  const float4* src = gx + ((size_t)slot * HT + w) * 128 + lane;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 v = src[g * 32];
    acc[g][0] = v.x;
    acc[g][1] = v.y;
    acc[g][2] = v.z;
    acc[g][3] = v.w;
  }
  mbar_arrive(empty + slot);
}

// b_ih + b_hh of a thread's gate rows (tile rows r and r + 8 of each gate).
__device__ __forceinline__ void load_gate_bias(float (&bias)[4][2], const float* wf,
                                               const CellOffsets& off, int H, int unit0, int lane) {
  const int r = lane >> 2;
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t m = (size_t)g * H + unit0 + 2 * r + half;
      bias[g][half] = __ldg(wf + off.b_ih + m) + __ldg(wf + off.b_hh + m);
    }
}

// Producer warp w of a direction, layer 1: z . W_z + b once per (gate, pair) in
// fp32, then two multiply-adds per position for the prototype's coordinates.
//   proto (B, L, 2) bf16; z (B, Z) f32; wq / wf: the packed weights.
template <int HT>
__device__ __forceinline__ void produce_first_layer(const bf16* proto, const float* z,
                                                    const bf16* wq, const float* wf,
                                                    const CellOffsets& off, int b0, int B, int L,
                                                    int Z, int dir, int w, int lane, float4* gx,
                                                    uint64_t* full, uint64_t* empty, int it0) {
  constexpr int H = 16 * HT, G = 4 * H;
  const int r = lane >> 2, q = lane & 3;
  float bias[4][2];
  load_gate_bias(bias, wf, off, H, 16 * w, lane);
  float base[4][4], wp[2][4][2];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t m = (size_t)g * H + 16 * w + 2 * r + half;
      base[g][2 * half] = base[g][2 * half + 1] = bias[g][half];
      wp[0][g][half] = __bfloat162float(__ldg(wq + off.w_ih + m));
      wp[1][g][half] = __bfloat162float(__ldg(wq + off.w_ih + G + m));
    }
  for (int k = 0; k < Z; ++k) {
    const float z0 = b0 + 2 * q < B ? __ldg(z + (size_t)(b0 + 2 * q) * Z + k) : 0.0f;
    const float z1 = b0 + 2 * q + 1 < B ? __ldg(z + (size_t)(b0 + 2 * q + 1) * Z + k) : 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float wv =
            __ldg(wf + off.w_ih + (size_t)(2 + k) * G + (size_t)g * H + 16 * w + 2 * r + half);
        base[g][2 * half] = fmaf(wv, z0, base[g][2 * half]);
        base[g][2 * half + 1] = fmaf(wv, z1, base[g][2 * half + 1]);
      }
  }
  for (int t = 0; t < L; ++t) {
    const int pos = dir ? L - 1 - t : t;
    float p[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int b = b0 + 2 * q + s;
      p[s][0] = p[s][1] = 0.0f;
      if (b < B) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(proto + ((size_t)b * L + pos) * 2);
        p[s][0] = __bfloat162float(v.x);
        p[s][1] = __bfloat162float(v.y);
      }
    }
    float acc[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[g][j] = fmaf(wp[0][g][j >> 1], p[j & 1][0], base[g][j]);
        acc[g][j] = fmaf(wp[1][g][j >> 1], p[j & 1][1], acc[g][j]);
      }
    gx_publish<HT>(gx, full, empty, it0 + t, w, lane, acc);
  }
}

// Producer warp w of a direction, layers >= 2: x_t . W_ih + b on the tensor
// cores, W_ih^T held as A fragments for the whole layer. `load_x(pos, bx)`
// fills the B fragments of x^T at a position: the layer below's [fwd | bwd]
// hidden row of sample lane / 4 of the tile, features
// 16kt + {2q, 2q+1} in bx[kt][0] and 16kt + {2q+8, 2q+9} in bx[kt][1]
// (q = lane % 4), zeros for a sample past the batch.
template <int HT, typename LoadX>
__device__ __forceinline__ void produce_upper_layer(const bf16* wq, const float* wf,
                                                    const CellOffsets& off, int L, int dir, int w,
                                                    int lane, float4* gx, uint64_t* full,
                                                    uint64_t* empty, int it0, LoadX load_x) {
  constexpr int H = 16 * HT;
  float bias[4][2];
  load_gate_bias(bias, wf, off, H, 16 * w, lane);
  uint32_t a[4][2 * HT][4];
  load_gate_fragments<2 * HT>(a, wq + off.w_ih, H, 16 * w, lane);
  for (int t = 0; t < L; ++t) {
    const int pos = dir ? L - 1 - t : t;
    uint32_t bx[2 * HT][2];
    load_x(pos, bx);
    float acc[4][4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][j] = bias[g][j >> 1];
    gate_product<2 * HT>(acc, a, bx);
    gx_publish<HT>(gx, full, empty, it0 + t, w, lane, acc);
  }
}

// ===========================================================================
// The float32 recurrence on the CUDA cores (two-CTA clusters, weights in
// registers): its building blocks, and the body of the float32 inference
// kernel (bilstm_fused.cu) and of the float32 training forward
// (bilstm_train.cu), which adds the residual rows. The training backward's
// float32 sweep (bilstm_train.cu) uses the same blocks.
// ===========================================================================

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

constexpr int kXStages = 4;  // ring of the layer below's rows ahead of the producers

// Floats between two residual rows staged by the float32 training forward:
// 16 bytes past 6H, so the four samples a warp writes fall in different banks.
template <int HT>
__host__ __device__ constexpr int fp32_stage_row() { return 6 * 16 * HT + 4; }

// Dynamic shared memory of `fp32_stack`: kResiduals adds the double-buffered
// staging of the training forward's residual rows.
template <int HT, int S, bool kResiduals>
constexpr size_t fp32_stack_smem_bytes() {
  constexpr int H = 16 * HT;
  return (size_t)kGxStages * S * H * 16         // gx ring: [stage][sample][unit] float4
         + (size_t)kXStages * S * 2 * H * 4     // x ring: [stage][sample][2H] float
         + (size_t)2 * S * (H + 4) * 4          // h tiles
         + (kResiduals ? (size_t)2 * S * fp32_stage_row<HT>() * 4 : 0)  // residual rows
         + (size_t)2 * (kGxStages + kXStages) * 8;  // mbarriers
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The four k-quarters' partial sums of NG outputs (the four gates in the
// forward; threads kq = 0..3 of a unit, four neighbouring lanes) added in two
// shuffle rounds; each thread is left the full sums of S / 4 samples, the
// first of them (S / 2) (kq & 1) + (S / 4) (kq >> 1).
template <int S, int NG = 4>
__device__ __forceinline__ void reduce_quarters(const float (&acc)[NG][S], int kq,
                                                float (&red)[NG][S / 4]) {
  const bool upper0 = kq & 1, upper1 = kq & 2;
  float half[NG][S / 2];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < S / 2; ++j) {
      const float keep = upper0 ? acc[g][j + S / 2] : acc[g][j];
      const float send = upper0 ? acc[g][j] : acc[g][j + S / 2];
      half[g][j] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < S / 4; ++j) {
      const float keep = upper1 ? half[g][j + S / 4] : half[g][j];
      const float send = upper1 ? half[g][j] : half[g][j + S / 4];
      red[g][j] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
}

// acc[g][s] += sum_i w[g][i] * x[s * stride + i], g < NG, i < K (K a
// multiple of 4; x 16-byte aligned, in shared memory).
template <int K, int S, int NG = 4>
__device__ __forceinline__ void quarter_product(float (&acc)[NG][S], const float (&w)[NG][K],
                                                const float* x, int stride) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int c = 0; c < K / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(x + s * stride + 4 * c);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[g][s] = fmaf(w[g][4 * c], v.x, acc[g][s]);
        acc[g][s] = fmaf(w[g][4 * c + 1], v.y, acc[g][s]);
        acc[g][s] = fmaf(w[g][4 * c + 2], v.z, acc[g][s]);
        acc[g][s] = fmaf(w[g][4 * c + 3], v.w, acc[g][s]);
      }
    }
}

// Rows kq * K .. kq * K + K of a (rows, 4H) weight matrix, the four gate
// columns of `unit`.
template <int K>
__device__ __forceinline__ void load_quarter(float (&w)[4][K], const float* m, int H, int unit,
                                             int kq) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int i = 0; i < K; ++i)
      w[g][i] = __ldg(m + (size_t)(kq * K + i) * 4 * H + (size_t)g * H + unit);
}

// One slot of the x ring: one bulk copy of the tile's rows at a position,
// once the slot's consumers have released it (`it` counts positions across
// layers, so the phase parity carries over the layer boundary).
__device__ __forceinline__ void x_ring_fetch(float* ring, int slot_floats, const float* src,
                                             uint32_t bytes, uint64_t* full, uint64_t* empty,
                                             int it) {
  const int slot = it % kXStages;
  mbar_wait(empty + slot, ((it / kXStages) & 1) ^ 1);
  mbar_arrive_expect_tx(full + slot, bytes);
  bulk_load(ring + (size_t)slot * slot_floats, src, bytes, full + slot);
}

// The float32 recurrence of a cluster of two CTAs (both float32 kernels'
// body: the inference forward, and the training forward with kResiduals):
// S samples through all layers, CTA rank = direction. Threads 0 .. 4H-1 are
// the chain, 4H .. 8H-1 the producers; thread (unit, kq) = (index / 4,
// index % 4) within either.
//   proto (B, L, 2) f32; z (B, Z) f32; wf: the packed weights in f32; out
//   (B, L, 2H) f32; scratch (min(layers - 1, 2), tiles, L, S, 2H) f32, tiles =
//   gridDim.x / 2; res (layers, 2, L, B, 6H) f32, written only with
//   kResiduals: per step each chain thread stages its unit's [h | c | i | f |
//   g | o] for its samples, and after the step's barrier lane s < nb of the
//   first chain warp copies sample s's row out with one bulk store (rows
//   staged 16 bytes apart to spread the banks; two buffers, the older store's
//   read awaited before its buffer is written again).
template <int HT, int S, bool kResiduals>
__device__ __forceinline__ void fp32_stack(const float* __restrict__ proto,
                                           const float* __restrict__ z,
                                           const float* __restrict__ wf, float* out,
                                           float* scratch, float* res, int B, int L, int Z,
                                           int layers) {
  constexpr int H = 16 * HT, G = 4 * H, KQ = H / 4, KX = H / 2, HS = H + 4, SQ = S / 4;
  constexpr int R = kGxStages, RX = kXStages;
  constexpr int kRole = 4 * H;  // threads of either role
  constexpr uint32_t kXBytes = S * 2 * H * 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float4* gx = reinterpret_cast<float4*>(smem_raw);               // [R][S][H]
  float* xs = reinterpret_cast<float*>(gx + R * S * H);           // [RX][S][2H]
  float* hs = xs + RX * S * 2 * H;                                // [2][S][HS]
  constexpr int SROW = fp32_stage_row<HT>();
  float* stage = hs + 2 * S * HS;                                 // [2][S][SROW]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stage + (kResiduals ? 2 * S * SROW : 0));  // [R]
  uint64_t* empty = full + R;                                     // [R]
  uint64_t* xfull = empty + R;                                    // [RX]
  uint64_t* xempty = xfull + RX;                                  // [RX]

  const int tid = threadIdx.x;
  const bool producer = tid >= kRole;
  const int rt = producer ? tid - kRole : tid;
  const int unit = rt >> 2, kq = rt & 3;
  const int dir = blockIdx.x & 1;
  const int tile = blockIdx.x >> 1;
  const int b0 = tile * S;
  const int s0 = (S / 2) * (kq & 1) + SQ * (kq >> 1);  // the thread's first sample
  const size_t tile_rows = (size_t)L * S * 2 * H;
  const size_t buffer = (size_t)(gridDim.x >> 1) * tile_rows;
  const bool copier = kResiduals && tid < S && tid < B - b0;  // one lane a sample

  if (tid == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(full + i, kRole);
      mbar_init(empty + i, kRole);
    }
    for (int i = 0; i < RX; ++i) {
      mbar_init(xfull + i, 1);
      mbar_init(xempty + i, kRole);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Hands the thread's gate sums of one position to the chain.
  auto publish = [&](int it, const float (&v)[4][SQ]) {
    const int slot = it % R;
    mbar_wait(empty + slot, ((it / R) & 1) ^ 1);
#pragma unroll
    for (int j = 0; j < SQ; ++j)
      gx[((size_t)slot * S + s0 + j) * H + unit] = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    mbar_arrive(full + slot);
  };

  for (int layer = 0; layer < layers; ++layer) {
    const CellOffsets off = cell_offsets(layer, dir, H, Z);
    const int it0 = layer * L;
    // Layer k under the top writes buffer k & 1 and reads buffer (k - 1) & 1.
    float* dst = scratch + (size_t)(layer & 1) * buffer + tile * tile_rows;
    const float* src = scratch + (size_t)((layer + 1) & 1) * buffer + tile * tile_rows;
    if (producer) {
      // ---- the input projection of this layer, in the chain's order ----
      float bias[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        bias[g] = __ldg(wf + off.b_ih + g * H + unit) + __ldg(wf + off.b_hh + g * H + unit);
      if (layer == 0) {
        // z . W_z + b once, then two multiply-adds per position.
        float base[4][SQ], wp[2][4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          wp[0][g] = __ldg(wf + off.w_ih + g * H + unit);
          wp[1][g] = __ldg(wf + off.w_ih + G + g * H + unit);
#pragma unroll
          for (int j = 0; j < SQ; ++j) base[g][j] = bias[g];
        }
        for (int k = 0; k < Z; ++k) {
          float zv[SQ];
#pragma unroll
          for (int j = 0; j < SQ; ++j)
            zv[j] = b0 + s0 + j < B ? __ldg(z + (size_t)(b0 + s0 + j) * Z + k) : 0.0f;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float wv = __ldg(wf + off.w_ih + (size_t)(2 + k) * G + g * H + unit);
#pragma unroll
            for (int j = 0; j < SQ; ++j) base[g][j] = fmaf(wv, zv[j], base[g][j]);
          }
        }
        for (int t = 0; t < L; ++t) {
          const int pos = dir ? L - 1 - t : t;
          float v[4][SQ];
#pragma unroll
          for (int j = 0; j < SQ; ++j) {
            float2 p = make_float2(0.0f, 0.0f);
            if (b0 + s0 + j < B)
              p = __ldg(reinterpret_cast<const float2*>(proto + ((size_t)(b0 + s0 + j) * L + pos) * 2));
#pragma unroll
            for (int g = 0; g < 4; ++g)
              v[g][j] = fmaf(wp[1][g], p.y, fmaf(wp[0][g], p.x, base[g][j]));
          }
          publish(it0 + t, v);
        }
      } else {
        float w[4][KX];
        load_quarter<KX>(w, wf + off.w_ih, H, unit, kq);
        // One thread keeps the x ring full: one bulk copy per position of the
        // tile's S rows of the layer below (contiguous in the scratch).
        const bool fetcher = rt == 0;
        const int itx0 = (layer - 1) * L;
        auto fetch = [&](int t) {
          x_ring_fetch(xs, S * 2 * H, src + (size_t)(dir ? L - 1 - t : t) * S * 2 * H, kXBytes,
                       xfull, xempty, itx0 + t);
        };
        if (fetcher) {
          fence_async_all();  // the layer below's rows were written with plain stores
          for (int t = 0; t < RX - 1 && t < L; ++t) fetch(t);
        }
        for (int t = 0; t < L; ++t) {
          if (fetcher && t + RX - 1 < L) fetch(t + RX - 1);
          const int it = itx0 + t;
          const int slot = it % RX;
          mbar_wait(xfull + slot, (it / RX) & 1);
          float acc[4][S];
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int s = 0; s < S; ++s) acc[g][s] = 0.0f;
          quarter_product<KX, S>(acc, w, xs + (size_t)slot * S * 2 * H + kq * KX, 2 * H);
          mbar_arrive(xempty + slot);
          float v[4][SQ];
          reduce_quarters<S>(acc, kq, v);
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int j = 0; j < SQ; ++j) v[g][j] += bias[g];
          publish(it0 + t, v);
        }
      }
    } else {
      // ---- the recurrence ----
      const bool top = layer == layers - 1;
      float w[4][KQ];
      load_quarter<KQ>(w, wf + off.w_hh, H, unit, kq);
      float c[SQ];
#pragma unroll
      for (int j = 0; j < SQ; ++j) c[j] = 0.0f;
      for (int i = rt; i < S * HS; i += kRole) hs[i] = 0.0f;
      named_barrier(1, kRole);
      for (int t = 0; t < L; ++t) {
        const int pos = dir ? L - 1 - t : t;
        float acc[4][S];
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int s = 0; s < S; ++s) acc[g][s] = 0.0f;
        quarter_product<KQ, S>(acc, w, hs + (t & 1) * S * HS + kq * KQ, HS);
        float v[4][SQ];
        reduce_quarters<S>(acc, kq, v);
        const int it = it0 + t;
        const int slot = it % R;
        mbar_wait(full + slot, (it / R) & 1);
#pragma unroll
        for (int j = 0; j < SQ; ++j) {
          const float4 x = gx[((size_t)slot * S + s0 + j) * H + unit];
          v[0][j] += x.x;
          v[1][j] += x.y;
          v[2][j] += x.z;
          v[3][j] += x.w;
        }
        mbar_arrive(empty + slot);
        float* hn = hs + ((t + 1) & 1) * S * HS;
#pragma unroll
        for (int j = 0; j < SQ; ++j) {
          const float ig = sigmoid_f(v[0][j]);
          const float fg = sigmoid_f(v[1][j]);
          const float gg = tanhf(v[2][j]);
          const float og = sigmoid_f(v[3][j]);
          c[j] = fg * c[j] + ig * gg;
          const float h = og * tanhf(c[j]);
          const int s = s0 + j;
          hn[s * HS + unit] = h;
          if (!top)
            dst[((size_t)pos * S + s) * 2 * H + dir * H + unit] = h;
          else if (b0 + s < B)
            out[((size_t)(b0 + s) * L + pos) * 2 * H + dir * H + unit] = h;
          if (kResiduals) {
            float* row = stage + ((t & 1) * S + s) * SROW + unit;
            row[0] = h;
            row[H] = c[j];
            row[2 * H] = ig;
            row[3 * H] = fg;
            row[4 * H] = gg;
            row[5 * H] = og;
          }
        }
        if (kResiduals) {
          fence_async_shared();
          if (copier) bulk_wait_read();  // the rows staged two steps ago have left
        }
        named_barrier(1, kRole);
        if (copier) {
          // Sample tid's row; the tile's rows at one position are consecutive in res.
          bulk_store(res + res_row(layer, dir, pos, b0 + tid, L, B, H),
                     stage + ((t & 1) * S + tid) * SROW, 6 * H * 4);
          bulk_commit();
        }
      }
      if (copier) bulk_wait_all();  // this layer's residual rows are in global memory
    }
    // Both directions' rows are written before either CTA's next layer reads
    // them (with bulk copies: the async proxy).
    __threadfence();
    fence_async_all();
    cluster_sync();
  }
}

}  // namespace wgg
