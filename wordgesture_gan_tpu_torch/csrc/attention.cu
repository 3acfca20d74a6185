// The transformer generator's attention core for Hopper (sm_90a): from the
// packed projections qkv (B, L, 3, H, h) and an optional padding mask (B, L)
// to the heads' outputs (B, L, H * h), one launch forward and one launch
// backward (dq, dk and dv into one (B, L, 3, H, h) gradient).
//
// Replaces no TPU kernel: the JAX package writes the attention as einsums
// and a softmax (models/generators.py `_attention`) that XLA fuses. The
// plain version, and the definition of every operation here, is
// wordgesture_gan_tpu_torch/models/generators.py (`plain_attention`), which
// runs that chain op by op: one PyTorch kernel an op, each reading and
// writing a (B, H, L, L) float32 tensor.
//
// Arithmetic: the chain's, in JAX's precision; sums are taken in another
// order, so a result may differ from the chain's in its last bit.
//   * logits: q . k summed in float32 (bfloat16: tensor-core products of the
//     bf16 operands, exact in float32; float32: CUDA-core FMAs), times the
//     float32 reciprocal of sqrt(h), as PyTorch divides by a number on the
//     card (the same bits as a division at h = 16 and 64); a padding key
//     gets -1e30, not -inf, so a row of padding keys only is a uniform
//     softmax and stays finite;
//   * softmax in float32: max subtracted, expf (not __expf), the row's sum,
//     each weight times the sum's reciprocal (within a float32 rounding of
//     the chain's division); the weights rounded to the compute dtype;
//   * P . V summed in float32 and rounded once into the (B, L, H * h) layout;
//   * backward, as autograd of the chain: dV = P^T . dO and dP = dO . V^T
//     summed in float32 and rounded to the dtype; dS = P (dP - sum_j P dP),
//     0 on padding keys, times 1 / sqrt(h); dq = dS . k and dk = dS^T . q as
//     float32 products (bfloat16: dS split into three bf16 terms, so the
//     tensor cores take a float32 operand with its 24 bits) rounded once.
//     P is computed again from q and k with the forward's own arithmetic;
//     no (L, L) tensor is stored.
//
// What bounds it: bytes. At the critic loop's call, B = 1024, L = 128, four
// heads of h = 16 in bfloat16, a forward reads q, k, v (50 MB) and the mask
// and writes the output (17 MB): 0.020 ms at 3.35 TB/s; its products are
// 4.3 GFLOP, 0.004 ms on the tensor cores. The chain moved ~2.9 GB. Next to
// the bytes, the cost is the work of each of the B H L^2 weights (a scale,
// a select, an expf, a product; the backward computes P twice), which the
// design keeps to once an element a pass.
//
// Design: one CTA of four warps per (batch row, head). q, k and v of the head
// (and dO in the backward) are copied once into shared memory, padded to 128
// (or 256) rows and a multiple of 16 columns with zeros (18 KB at L = 128,
// h = 16 in bfloat16). bfloat16 runs `mma.sync.m16n8k16` with float32
// accumulators: a warp owns 16 query rows and holds their logits against
// every key in registers (64 a thread at L = 128), so each weight is computed
// once and P . V takes P straight from the accumulators. The backward's first
// phase gives each warp 16 query rows (P, sum_j P dP, dq; dP in chunks of 64
// keys); its second gives each warp 16 keys, which walk the queries in
// chunks of 64 and compute P and dS transposed from the rows' statistics
// (dk, dv). Each output element is written by one thread after a fixed
// sequence of sums: no atomics, so two launches give the same bits. float32
// runs on the CUDA cores, a thread a query row (a key in the backward's
// second phase), reading the other rows from global memory, which every
// lane of a warp reads at one address.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;            // keys (or queries) of a chunk
constexpr int kTiles = kChunk / 8;    // n8 tiles of a chunk
constexpr int kMaxLen = 256;
constexpr int kMaxHead = 64;
constexpr float kMasked = -1e30f;

enum KeyKind : uint8_t { kValid = 0, kPadding = 1, kAbsent = 2 };

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d += a (16 x 16, row) . b (16 x 8, col); float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
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

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// q . k times 1 / sqrt(h) (the float32 reciprocal, as PyTorch divides a
// tensor by a number on the card); a padding key gets -1e30 (the chain's), a
// key past the length -inf (it does not exist: its weight is exactly 0).
__device__ __forceinline__ float logit(float acc, uint8_t kind, float inv_scale) {
  return kind == kValid ? acc * inv_scale : (kind == kPadding ? kMasked : -INFINITY);
}

__device__ __forceinline__ void load_kinds(uint8_t* kind, const float* mask, int L, int rows) {
  for (int j = threadIdx.x; j < rows; j += blockDim.x)
    kind[j] = j >= L ? kAbsent : (mask != nullptr && !(mask[j] > 0.0f) ? kPadding : kValid);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

// The shared-memory tiles of one head: `rows` (64 NCH) rows of HD (h rounded
// up to 16) columns, HD + 8 apart, so that the 32-bit fragment loads and
// ldmatrix's rows of a warp fall in distinct banks.
template <int HD>
struct Tile {
  static constexpr int kStride = HD + 8;
  static constexpr __host__ __device__ size_t bytes(int rows) {
    return static_cast<size_t>(rows) * kStride * sizeof(bf16);
  }
};

// Rows [0, L) of `src` (row r at src + r * stride, h elements, 16-byte
// aligned) into `dst`; zeros elsewhere up to `rows` x HD.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, size_t stride,
                                          int L, int rows, int h) {
  constexpr int kPieces = HD / 8;   // 16-byte pieces a row
  for (int i = threadIdx.x; i < rows * kPieces; i += blockDim.x) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < L && c < h) v = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    *reinterpret_cast<uint4*>(dst + r * Tile<HD>::kStride + c) = v;
  }
}

// A fragments of rows [r0, r0 + 16) of a tile, every 16 columns.
template <int HD>
__device__ __forceinline__ void load_rows_a(uint32_t (&a)[HD / 16][4], const bf16* tile, int r0,
                                            int g, int t) {
  constexpr int S = Tile<HD>::kStride;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const bf16* p = tile + (r0 + g) * S + ks * 16 + 2 * t;
    a[ks][0] = word(p);
    a[ks][1] = word(p + 8 * S);
    a[ks][2] = word(p + 8);
    a[ks][3] = word(p + 8 * S + 8);
  }
}

// c[nt] = a . tile[j0 + 8 nt, + 8)^T for N n8 tiles: the products of 16 rows
// (a) with 8 N rows of a tile, summed over HD.
template <int HD, int N>
__device__ __forceinline__ void rows_times_rows(float (&c)[N][4], const uint32_t (&a)[HD / 16][4],
                                                const bf16* tile, int j0, int g, int t) {
  constexpr int S = Tile<HD>::kStride;
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.0f;
    const bf16* p = tile + (j0 + nt * 8 + g) * S + 2 * t;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      mma_bf16(c[nt], a[ks], word(p + ks * 16), word(p + ks * 16 + 8));
  }
}

// The four threads of a quad hold one row; the same sum lands in all four.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// P of the rows g and g + 8 of a 16-row block against every key, held in
// registers as C fragments (N = 8 NCH tiles of 8 keys), with each row's
// maximum and the reciprocal of its sum. The forward and the backward share
// it, so P is the same number in both.
template <int HD, int N>
__device__ __forceinline__ void row_probs(float (&p)[N][4], const uint32_t (&qa)[HD / 16][4],
                                          const bf16* sk, const uint8_t* kind, float inv_scale,
                                          int g, int t, float (&mx)[2], float (&rinv)[2]) {
  rows_times_rows<HD, N>(p, qa, sk, 0, g, t);
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    const int j = nt * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[nt][e] = logit(p[nt][e], kind[j + (e & 1)], inv_scale);
      mx[e >> 1] = fmaxf(mx[e >> 1], p[nt][e]);
    }
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]);
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[nt][e] = expf(p[nt][e] - mx[e >> 1]);
      sum[e >> 1] += p[nt][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) rinv[i] = 1.0f / quad_sum(sum[i]);
#pragma unroll
  for (int nt = 0; nt < N; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[nt][e] *= rinv[e >> 1];
}

// acc[n] += a . tile[j0, j0 + 8 N): a is 16 rows x 8 N columns as C
// fragments of N n8 tiles (the k index), rounded to bf16; the tile is
// row-major with its rows as the k index.
template <int HD, int N>
__device__ __forceinline__ void tiles_times_tile(float (&acc)[HD / 8][4], const float (&c)[N][4],
                                                 const bf16* tile, int j0, int lane) {
  constexpr int S = Tile<HD>::kStride;
  const int m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(c[2 * kk][0], c[2 * kk][1]),
                           pack_bf16(c[2 * kk][2], c[2 * kk][3]),
                           pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3])};
    const bf16* row = tile + (j0 + kk * 16 + (m & 1) * 8 + r) * S + (m >> 1) * 8;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + np * 16);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The bf16 pair nearest (x0, x1), and what it leaves of each.
__device__ __forceinline__ uint32_t split_pair(float& x0, float& x1) {
  const uint32_t w = pack_bf16(x0, x1);
  x0 -= __uint_as_float(w << 16);
  x1 -= __uint_as_float(w & 0xFFFF0000u);
  return w;
}

// The same product with float32 values in c: each split into three bf16
// terms (hi + mid + lo holds its 24 bits), each term a product.
template <int HD, int N>
__device__ __forceinline__ void tiles_times_tile_f32(float (&acc)[HD / 8][4],
                                                     const float (&c)[N][4], const bf16* tile,
                                                     int j0, int lane) {
  constexpr int S = Tile<HD>::kStride;
  const int m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    float x[8] = {c[2 * kk][0], c[2 * kk][1], c[2 * kk][2], c[2 * kk][3],
                  c[2 * kk + 1][0], c[2 * kk + 1][1], c[2 * kk + 1][2], c[2 * kk + 1][3]};
    uint32_t a[3][4];
#pragma unroll
    for (int term = 0; term < 3; ++term)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[term][i] = split_pair(x[2 * i], x[2 * i + 1]);
    const bf16* row = tile + (j0 + kk * 16 + (m & 1) * 8 + r) * S + (m >> 1) * 8;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + np * 16);
#pragma unroll
      for (int term = 0; term < 3; ++term) {
        mma_bf16(acc[2 * np], a[term], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a[term], b[2], b[3]);
      }
    }
  }
}

// Rows r0 + g and r0 + g + 8 (those below L) of acc, rounded to bf16, to
// dst + row * stride, columns below h.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, size_t stride,
                                           const float (&acc)[HD / 8][4], int r0, int L, int h,
                                           int g, int t) {
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (col >= h) break;
    if (r0 + g < L)
      *reinterpret_cast<uint32_t*>(dst + (r0 + g) * stride + col) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (r0 + g + 8 < L)
      *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8) * stride + col) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// Shared memory of a forward (q, k, v, the key kinds) and of a backward (also
// dO and three floats a query row) at NCH chunks of 64 keys.
template <int HD, int NCH>
constexpr size_t fwd_mma_smem() {
  return 3 * Tile<HD>::bytes(NCH * kChunk) + NCH * kChunk;
}

template <int HD, int NCH>
constexpr size_t bwd_mma_smem() {
  return 4 * Tile<HD>::bytes(NCH * kChunk) + 3 * NCH * kChunk * sizeof(float) + NCH * kChunk;
}

// CTAs an SM holds at the port's own shape (h = 16, L <= 128): their
// register caps (102 forward, 128 backward) spill a few words (ptxas: 24 and
// 32 bytes) and were 17% and 27% faster on an H100 than the 127 and 168
// registers ptxas takes uncapped. Wider heads and longer rows keep theirs.
template <int HD, int NCH>
constexpr int kFwdBlocks = HD == 16 && NCH == 2 ? 5 : 1;
template <int HD, int NCH>
constexpr int kBwdBlocks = HD == 16 && NCH == 2 ? 4 : 1;

// A CTA a (batch row, head); L <= 64 NCH, the rows padded to 64 NCH.
template <int HD, int NCH>
__global__ void __launch_bounds__(kThreads, (kFwdBlocks<HD, NCH>))
    attn_core_fwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                             bf16* __restrict__ out, int L, int H, int h, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = NCH * kChunk, S = Tile<HD>::kStride;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kRows * S;
  bf16* sv = sk + kRows * S;
  uint8_t* kind = reinterpret_cast<uint8_t*>(sv + kRows * S);
  const int b = blockIdx.x / H, head = blockIdx.x % H;
  const size_t stride = 3 * static_cast<size_t>(H) * h;
  const bf16* base = qkv + static_cast<size_t>(b) * L * stride + static_cast<size_t>(head) * h;
  load_tile<HD>(sq, base, stride, L, kRows, h);
  load_tile<HD>(sk, base + static_cast<size_t>(H) * h, stride, L, kRows, h);
  load_tile<HD>(sv, base + 2 * static_cast<size_t>(H) * h, stride, L, kRows, h);
  load_kinds(kind, mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L, L, kRows);
  __syncthreads();

  const float inv_scale = 1.0f / scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* dst = out + static_cast<size_t>(b) * L * H * h + static_cast<size_t>(head) * h;
  for (int r0 = warp * 16; r0 < L; r0 += kWarps * 16) {
    uint32_t qa[HD / 16][4];
    load_rows_a<HD>(qa, sq, r0, g, t);
    float p[NCH * kTiles][4], mx[2], rinv[2];
    row_probs<HD, NCH * kTiles>(p, qa, sk, kind, inv_scale, g, t, mx, rinv);
    float o[HD / 8][4] = {};
    tiles_times_tile<HD, NCH * kTiles>(o, p, sv, 0, lane);
    store_rows<HD>(dst, static_cast<size_t>(H) * h, o, r0, L, h, g, t);
  }
}

template <int HD, int NCH>
__global__ void __launch_bounds__(kThreads, (kBwdBlocks<HD, NCH>))
    attn_core_bwd_mma_kernel(const bf16* __restrict__ qkv, const float* __restrict__ mask,
                             const bf16* __restrict__ dout, bf16* __restrict__ dqkv, int L, int H,
                             int h, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = NCH * kChunk, S = Tile<HD>::kStride;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + kRows * S;
  bf16* sv = sk + kRows * S;
  bf16* so = sv + kRows * S;
  float* row_max = reinterpret_cast<float*>(so + kRows * S);
  float* row_rinv = row_max + kRows;
  float* row_dot = row_rinv + kRows;
  uint8_t* kind = reinterpret_cast<uint8_t*>(row_dot + kRows);
  const int b = blockIdx.x / H, head = blockIdx.x % H;
  const size_t stride = 3 * static_cast<size_t>(H) * h, ostride = static_cast<size_t>(H) * h;
  const size_t offset = static_cast<size_t>(b) * L * stride + static_cast<size_t>(head) * h;
  const bf16* base = qkv + offset;
  load_tile<HD>(sq, base, stride, L, kRows, h);
  load_tile<HD>(sk, base + ostride, stride, L, kRows, h);
  load_tile<HD>(sv, base + 2 * ostride, stride, L, kRows, h);
  load_tile<HD>(so, dout + static_cast<size_t>(b) * L * ostride + static_cast<size_t>(head) * h,
                ostride, L, kRows, h);
  load_kinds(kind, mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L, L, kRows);
  __syncthreads();

  const float inv_scale = 1.0f / scale;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* grad = dqkv + offset;

  // Phase 1: a warp a block of 16 query rows: P, sum_j P dP, dq.
  for (int r0 = warp * 16; r0 < L; r0 += kWarps * 16) {
    uint32_t qa[HD / 16][4], oa[HD / 16][4];
    load_rows_a<HD>(qa, sq, r0, g, t);
    load_rows_a<HD>(oa, so, r0, g, t);
    float p[NCH * kTiles][4], mx[2], rinv[2], dot[2] = {0.0f, 0.0f};
    row_probs<HD, NCH * kTiles>(p, qa, sk, kind, inv_scale, g, t, mx, rinv);
    float dp[kTiles][4];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      rows_times_rows<HD, kTiles>(dp, oa, sv, c * kChunk, g, t);
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[e >> 1] += p[c * kTiles + nt][e] * round_bf16(dp[nt][e]);
    }
    dot[0] = quad_sum(dot[0]);
    dot[1] = quad_sum(dot[1]);
    float dq[HD / 8][4] = {};
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      rows_times_rows<HD, kTiles>(dp, oa, sv, c * kChunk, g, t);
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const int j = c * kChunk + nt * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[nt][e] = kind[j + (e & 1)] != kValid ? 0.0f
                      : p[c * kTiles + nt][e] * (round_bf16(dp[nt][e]) - dot[e >> 1]) * inv_scale;
      }
      tiles_times_tile_f32<HD, kTiles>(dq, dp, sk, c * kChunk, lane);
    }
    store_rows<HD>(grad, stride, dq, r0, L, h, g, t);
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        row_max[r0 + g + 8 * i] = mx[i];
        row_rinv[r0 + g + 8 * i] = rinv[i];
        row_dot[r0 + g + 8 * i] = dot[i];
      }
    }
  }
  __syncthreads();

  // Phase 2: a warp a block of 16 keys, over the queries in chunks of 64:
  // P and dS again (transposed), dk and dv.
  const int chunks = (L + kChunk - 1) / kChunk;
  for (int k0 = warp * 16; k0 < L; k0 += kWarps * 16) {
    uint32_t ka[HD / 16][4], va[HD / 16][4];
    load_rows_a<HD>(ka, sk, k0, g, t);
    load_rows_a<HD>(va, sv, k0, g, t);
    const uint8_t kinds[2] = {kind[k0 + g], kind[k0 + g + 8]};
    float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
    float st[kTiles][4], dpt[kTiles][4];
    for (int c = 0; c < chunks; ++c) {
      const int i0 = c * kChunk;
      rows_times_rows<HD, kTiles>(st, ka, sq, i0, g, t);
      rows_times_rows<HD, kTiles>(dpt, va, so, i0, g, t);
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
        const int i = i0 + nt * 8 + 2 * t;
        const float2 m2 = *reinterpret_cast<const float2*>(row_max + i);
        const float2 r2 = *reinterpret_cast<const float2*>(row_rinv + i);
        const float2 d2 = *reinterpret_cast<const float2*>(row_dot + i);
        const float ms[2] = {m2.x, m2.y}, rs[2] = {r2.x, r2.y}, ds[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint8_t kd = kinds[e >> 1];
          const int q = e & 1;
          float p = 0.0f, dsv = 0.0f;
          if (i + q < L) {
            p = expf(logit(st[nt][e], kd, inv_scale) - ms[q]) * rs[q];
            if (kd == kValid) dsv = p * (round_bf16(dpt[nt][e]) - ds[q]) * inv_scale;
          }
          st[nt][e] = p;
          dpt[nt][e] = dsv;
        }
      }
      tiles_times_tile<HD, kTiles>(dv, st, so, i0, lane);
      tiles_times_tile_f32<HD, kTiles>(dk, dpt, sq, i0, lane);
    }
    store_rows<HD>(grad + ostride, stride, dk, k0, L, h, g, t);
    store_rows<HD>(grad + 2 * ostride, stride, dv, k0, L, h, g, t);
  }
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
__device__ __forceinline__ void load_row(float (&x)[HD], const float* __restrict__ src) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + d));
    x[d] = v.x;
    x[d + 1] = v.y;
    x[d + 2] = v.z;
    x[d + 3] = v.w;
  }
}

// x . y[0, HD), FMAs in the order of d; y is read by every lane at once.
template <int HD>
__device__ __forceinline__ float dot_row(const float (&x)[HD], const float* __restrict__ y) {
  float acc = 0.0f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(y + d));
    acc = fmaf(x[d], v.x, acc);
    acc = fmaf(x[d + 1], v.y, acc);
    acc = fmaf(x[d + 2], v.z, acc);
    acc = fmaf(x[d + 3], v.w, acc);
  }
  return acc;
}

template <int HD>
__device__ __forceinline__ void axpy_row(float (&acc)[HD], float a, const float* __restrict__ y) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(y + d));
    acc[d] = fmaf(a, v.x, acc[d]);
    acc[d + 1] = fmaf(a, v.y, acc[d + 1]);
    acc[d + 2] = fmaf(a, v.z, acc[d + 2]);
    acc[d + 3] = fmaf(a, v.w, acc[d + 3]);
  }
}

template <int HD>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; d += 4)
    *reinterpret_cast<float4*>(dst + d) = make_float4(x[d], x[d + 1], x[d + 2], x[d + 3]);
}

// Row maximum and the reciprocal of the row sum of query row q against
// every key (rows of `k`).
template <int HD>
__device__ __forceinline__ void row_stats_f32(const float (&q)[HD], const float* k, size_t stride,
                                              const uint8_t* kind, int L, float inv_scale,
                                              float& mx, float& rinv) {
  mx = -INFINITY;
  for (int j = 0; j < L; ++j)
    mx = fmaxf(mx, logit(dot_row<HD>(q, k + j * stride), kind[j], inv_scale));
  float sum = 0.0f;
  for (int j = 0; j < L; ++j)
    sum += expf(logit(dot_row<HD>(q, k + j * stride), kind[j], inv_scale) - mx);
  rinv = 1.0f / sum;
}

template <int HD>
__global__ void __launch_bounds__(kMaxLen)
    attn_core_fwd_fp32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                              float* __restrict__ out, int L, int H, float scale) {
  __shared__ uint8_t kind[kMaxLen];
  const int b = blockIdx.x / H, head = blockIdx.x % H, i = threadIdx.x;
  load_kinds(kind, mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L, L, L);
  __syncthreads();
  if (i >= L) return;
  const float inv_scale = 1.0f / scale;
  const size_t stride = 3 * static_cast<size_t>(H) * HD;
  const float* q = qkv + static_cast<size_t>(b) * L * stride + static_cast<size_t>(head) * HD;
  const float* k = q + static_cast<size_t>(H) * HD;
  const float* v = k + static_cast<size_t>(H) * HD;
  float qi[HD], o[HD] = {};
  load_row<HD>(qi, q + i * stride);
  float mx, rinv;
  row_stats_f32<HD>(qi, k, stride, kind, L, inv_scale, mx, rinv);
  for (int j = 0; j < L; ++j) {
    const float p = expf(logit(dot_row<HD>(qi, k + j * stride), kind[j], inv_scale) - mx) * rinv;
    axpy_row<HD>(o, p, v + j * stride);
  }
  store_row<HD>(out + (static_cast<size_t>(b) * L + i) * H * HD + static_cast<size_t>(head) * HD,
                o);
}

template <int HD>
__global__ void __launch_bounds__(kMaxLen)
    attn_core_bwd_fp32_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                              const float* __restrict__ dout, float* __restrict__ dqkv, int L,
                              int H, float scale) {
  __shared__ uint8_t kind[kMaxLen];
  __shared__ float row_max[kMaxLen], row_rinv[kMaxLen], row_dot[kMaxLen];
  const int b = blockIdx.x / H, head = blockIdx.x % H, x = threadIdx.x;
  load_kinds(kind, mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * L, L, L);
  __syncthreads();
  const float inv_scale = 1.0f / scale;
  const size_t stride = 3 * static_cast<size_t>(H) * HD, ostride = static_cast<size_t>(H) * HD;
  const size_t offset = static_cast<size_t>(b) * L * stride + static_cast<size_t>(head) * HD;
  const float* q = qkv + offset;
  const float* k = q + ostride;
  const float* v = k + ostride;
  const float* go = dout + static_cast<size_t>(b) * L * ostride + static_cast<size_t>(head) * HD;
  float* grad = dqkv + offset;

  // Phase 1: thread x is query row x: P's statistics, sum_j P dP, dq.
  if (x < L) {
    float qi[HD], gi[HD], dq[HD] = {};
    load_row<HD>(qi, q + x * stride);
    load_row<HD>(gi, go + x * ostride);
    float mx, rinv, dot = 0.0f;
    row_stats_f32<HD>(qi, k, stride, kind, L, inv_scale, mx, rinv);
    for (int j = 0; j < L; ++j) {
      const float p =
          expf(logit(dot_row<HD>(qi, k + j * stride), kind[j], inv_scale) - mx) * rinv;
      dot += p * dot_row<HD>(gi, v + j * stride);
    }
    for (int j = 0; j < L; ++j) {
      if (kind[j] != kValid) continue;
      const float p =
          expf(logit(dot_row<HD>(qi, k + j * stride), kind[j], inv_scale) - mx) * rinv;
      axpy_row<HD>(dq, p * (dot_row<HD>(gi, v + j * stride) - dot) * inv_scale, k + j * stride);
    }
    store_row<HD>(grad + x * stride, dq);
    row_max[x] = mx;
    row_rinv[x] = rinv;
    row_dot[x] = dot;
  }
  __syncthreads();

  // Phase 2: thread x is key x: dk and dv over every query row.
  if (x < L) {
    float kx[HD], vx[HD], dk[HD] = {}, dv[HD] = {};
    load_row<HD>(kx, k + x * stride);
    load_row<HD>(vx, v + x * stride);
    const uint8_t kd = kind[x];
    for (int i = 0; i < L; ++i) {
      const float p =
          expf(logit(dot_row<HD>(kx, q + i * stride), kd, inv_scale) - row_max[i]) * row_rinv[i];
      axpy_row<HD>(dv, p, go + i * ostride);
      if (kd == kValid)
        axpy_row<HD>(dk, p * (dot_row<HD>(vx, go + i * ostride) - row_dot[i]) * inv_scale,
                     q + i * stride);
    }
    store_row<HD>(grad + ostride + x * stride, dk);
    store_row<HD>(grad + 2 * ostride + x * stride, dv);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  return 0;
}

template <int HD, int NCH>
int launch_mma(int direction, const void* qkv, const float* mask, const void* dout, void* out,
               int B, int L, int H, int h, float scale, cudaStream_t stream) {
  const auto* x = static_cast<const bf16*>(qkv);
  if (direction == 0) {
    constexpr size_t smem = fwd_mma_smem<HD, NCH>();
    if (int err = prepare(attn_core_fwd_mma_kernel<HD, NCH>, smem)) return err;
    attn_core_fwd_mma_kernel<HD, NCH><<<B * H, kThreads, smem, stream>>>(
        x, mask, static_cast<bf16*>(out), L, H, h, scale);
  } else {
    constexpr size_t smem = bwd_mma_smem<HD, NCH>();
    if (int err = prepare(attn_core_bwd_mma_kernel<HD, NCH>, smem)) return err;
    attn_core_bwd_mma_kernel<HD, NCH><<<B * H, kThreads, smem, stream>>>(
        x, mask, static_cast<const bf16*>(dout), static_cast<bf16*>(out), L, H, h, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// The row held in registers: two chunks of 64 keys up to L = 128, four above.
template <int HD>
int launch_bf16(int direction, const void* qkv, const float* mask, const void* dout, void* out,
               int B, int L, int H, int h, float scale, cudaStream_t stream) {
  if (L <= 2 * kChunk)
    return launch_mma<HD, 2>(direction, qkv, mask, dout, out, B, L, H, h, scale, stream);
  return launch_mma<HD, 4>(direction, qkv, mask, dout, out, B, L, H, h, scale, stream);
}

template <int HD>
int launch_fp32(int direction, const void* qkv, const float* mask, const void* dout, void* out,
                int B, int L, int H, float scale, cudaStream_t stream) {
  const auto* x = static_cast<const float*>(qkv);
  const int threads = round_up(L, 32);
  if (direction == 0)
    attn_core_fwd_fp32_kernel<HD><<<B * H, threads, 0, stream>>>(
        x, mask, static_cast<float*>(out), L, H, scale);
  else
    attn_core_bwd_fp32_kernel<HD><<<B * H, threads, 0, stream>>>(
        x, mask, static_cast<const float*>(dout), static_cast<float*>(out), L, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace


extern "C" {

// direction 0: out (B, L, H * h) = attention of qkv (B, L, 3, H, h);
// direction 1: out (B, L, 3, H, h) = its gradient given dout (B, L, H * h).
// dtype 0 float32, 1 bfloat16; every array contiguous, 16-byte aligned, of
// that dtype; `mask` (B, L) float32, > 0 for a valid key, or null; `scale`
// is sqrt(h) in float32. h a multiple of 8 up to 64, 1 <= L <= 256, B * H
// >= 1. Runs on `stream` without synchronising; returns the cudaError_t of
// the launch (0 on success), cudaErrorInvalidValue for arguments it does
// not take, cudaErrorMisalignedAddress for an array off 16-byte alignment.
int wgg_attention(int direction, int dtype, const void* qkv, const float* mask, const void* dout,
                  void* out, int B, int L, int H, int h, float scale, cudaStream_t stream) {
  if (direction < 0 || direction > 1 || B < 1 || H < 1 || L < 1 || L > kMaxLen || h < 8 ||
      h > kMaxHead || h % 8 != 0 || (direction == 1 && dout == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(out)) & 15u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == 1) {
    switch (round_up(h, 16)) {
      case 16: return launch_bf16<16>(direction, qkv, mask, dout, out, B, L, H, h, scale, stream);
      case 32: return launch_bf16<32>(direction, qkv, mask, dout, out, B, L, H, h, scale, stream);
      case 48: return launch_bf16<48>(direction, qkv, mask, dout, out, B, L, H, h, scale, stream);
      case 64: return launch_bf16<64>(direction, qkv, mask, dout, out, B, L, H, h, scale, stream);
    }
  } else if (dtype == 0) {
    switch (h) {
      case 8: return launch_fp32<8>(direction, qkv, mask, dout, out, B, L, H, scale, stream);
      case 16: return launch_fp32<16>(direction, qkv, mask, dout, out, B, L, H, scale, stream);
      case 24: return launch_fp32<24>(direction, qkv, mask, dout, out, B, L, H, scale, stream);
      case 32: return launch_fp32<32>(direction, qkv, mask, dout, out, B, L, H, scale, stream);
      case 40: return launch_fp32<40>(direction, qkv, mask, dout, out, B, L, H, scale, stream);
      case 48: return launch_fp32<48>(direction, qkv, mask, dout, out, B, L, H, scale, stream);
      case 56: return launch_fp32<56>(direction, qkv, mask, dout, out, B, L, H, scale, stream);
      case 64: return launch_fp32<64>(direction, qkv, mask, dout, out, B, L, H, scale, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
