// Exact batched dynamic-time-warping distance for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dtw_kernel` of wordgesture_gan_tpu/ops/dtw_pallas.py
// (launched by `dtw_pairs_pallas`, dispatched by ops/dtw.py
// `dtw_distance_matrix`). For a pair of sequences x, y of L points with D in
// {2, 3} features it computes
//   c[i, j] = sqrt(sum_d (x[i, d] - y[j, d])^2)          (direct differences)
//   D[i, j] = c[i, j] + min(D[i-1, j], D[i-1, j-1], D[i, j-1])
// with the first row and column as prefix sums, and returns D[L-1, L-1].
// Forward only: DTW is a metric here.
//
// What bounds it on this card. The work is P * L^2 cells (6.6e10 at the
// evaluation's 2000 x 2000 pairs of 128 points), each about eight float32
// operations and one square root; the inputs are 4 MB and the output 16 MB,
// so bytes are nothing. The square roots run on the special-function units
// (16 lanes per clock per SM), which sets the floor at about twice the time
// of the float32 pipes. Under that floor sits a dependency chain: a cell
// needs its left neighbour, so one pair's row cannot be computed faster than
// two dependent instructions per cell.
//
// Design. The TPU kernel turns every row into two log-depth scans over the
// lane axis because its vector unit wants 128-wide rows; here a scan would
// cost a warp five shuffle rounds twice per row for 128 cells. Instead:
//   * one thread owns one pair and runs the classic recurrence along a row,
//     with the whole previous row D[i-1, 0..127] in registers (the column
//     loop is fully unrolled so every index is static); the chain of one
//     thread is hidden by the other warps of the SM and by the cost
//     computations of later cells, which do not depend on it;
//   * `dtw_matrix_kernel` (the evaluation's entry): a CTA owns a block of
//     32 reals x 4 fakes of the distance matrix. The lanes of a warp are the
//     32 reals, the warp is one fake, so the fake's point y[j] is one
//     broadcast shared-memory load per cell for the whole warp, and the
//     real's point x[i] is loaded once per row. Both tiles are staged in
//     shared memory once per CTA; the kernel reads `real` (n, L, D) and
//     `fake` (m, L, D) directly, so no pair is ever gathered in memory;
//   * `dtw_pairs_kernel` (aligned pairs, the entry the checks call): the
//     lanes of a warp are 32 different pairs, so y is staged per lane like x;
//   * the square root is `sqrt.approx.ftz.f32` (one special-function
//     instruction, relative error 2^-23, exact 0 at 0);
//   * 1e30 guards the cells outside the matrix, not infinity.
// Any P, n, m >= 1; D in {2, 3}; 1 <= L <= 128 (the row lives in 128
// registers; columns beyond L are computed and ignored, in chunks of 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 128;      // longest sequence: one register per column
constexpr int kChunk = 32;        // columns are skipped in chunks of this many
constexpr int kLanes = 32;
constexpr int kXStride = 33;      // per-lane planes padded against bank conflicts
constexpr int kMatrixWarps = 4;   // fakes per CTA of the matrix kernel
constexpr float kBig = 1e30f;

__device__ __forceinline__ float fast_sqrt(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int D>
struct PackedPoint;
template <>
struct PackedPoint<2> {
  using type = float2;
  static constexpr int kWidth = 2;
};
template <>
struct PackedPoint<3> {
  using type = float4;
  static constexpr int kWidth = 4;
};

// Point cost between this thread's x[i] (in registers) and y[j].
// BROADCAST: ys is the warp's one sequence, packed (j, kWidth), one vector
// load for all lanes. Otherwise ys is this lane's own planes (d, j) with
// stride kXStride between consecutive j.
template <int D, bool BROADCAST>
__device__ __forceinline__ float point_cost(const float (&x)[D], const float* ys, int j, int lp) {
  float y[D];
  if constexpr (BROADCAST) {
    using Vec = typename PackedPoint<D>::type;
    const Vec v = reinterpret_cast<const Vec*>(ys)[j];
    y[0] = v.x;
    y[1] = v.y;
    if constexpr (D == 3) y[2] = v.z;
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) y[d] = ys[(d * lp + j) * kXStride];
  }
  float sq = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float diff = x[d] - y[d];
    sq = fmaf(diff, diff, sq);
  }
  return fast_sqrt(sq);
}

// One pair's DTW distance. xs: this lane's x planes, x[i, d] at
// xs[(d * lp + i) * kXStride]; ys as `point_cost` reads it; lp is L rounded
// up to a multiple of kChunk.
template <int D, bool BROADCAST>
__device__ __forceinline__ float dtw_thread(const float* xs, const float* ys, int L, int lp) {
  float row[kMaxLen];   // D[i-1, :] on entry to row i, D[i, :] after it
#pragma unroll
  for (int j = 0; j < kMaxLen; ++j) row[j] = kBig;

#pragma unroll 1
  for (int i = 0; i < L; ++i) {
    float x[D];
#pragma unroll
    for (int d = 0; d < D; ++d) x[d] = xs[(d * lp + i) * kXStride];
    // Above row 0 everything is kBig except the corner the path starts from.
    float diag = i == 0 ? 0.f : kBig;
    float left = kBig;
#pragma unroll
    for (int c = 0; c < kMaxLen / kChunk; ++c) {
      if (c * kChunk < L) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int j = c * kChunk + jj;
          const float cost = point_cost<D, BROADCAST>(x, ys, j, lp);
          const float up = row[j];
          const float best = fminf(up, diag);
          diag = up;
          left = cost + fminf(best, left);
          row[j] = left;
        }
      }
    }
  }
  float out = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxLen; ++j)
    if (j == L - 1) out = row[j];
  return out;
}

// Stage `count` sequences starting at `first` of src (total, L, D) as per-lane
// planes: dst[(d * lp + i) * kXStride + lane]. Rows past `total` read as 0.
template <int D>
__device__ __forceinline__ void stage_planes(float* dst, const float* src, int64_t first,
                                             int64_t total, int L, int lp) {
  const int per_seq = L * D;
  for (int e = threadIdx.x; e < kLanes * per_seq; e += blockDim.x) {
    const int lane = e / per_seq;
    const int k = e - lane * per_seq;
    const int i = k / D;
    const int d = k - i * D;
    const int64_t s = first + lane;
    dst[(d * lp + i) * kXStride + lane] = s < total ? src[s * per_seq + k] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kMatrixWarps* kLanes, 3)
    dtw_matrix_kernel(const float* __restrict__ real, const float* __restrict__ fake,
                      float* __restrict__ out, int n, int m, int L, int fake_tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int W = PackedPoint<D>::kWidth;
  const int lp = (L + kChunk - 1) / kChunk * kChunk;
  float* ys = smem;                              // (kMatrixWarps, lp, W), 16-byte aligned
  float* xs = smem + kMatrixWarps * lp * W;      // (D, lp, kXStride)

  const int tile_r = blockIdx.x / fake_tiles;
  const int tile_f = blockIdx.x - tile_r * fake_tiles;
  const int64_t r0 = (int64_t)tile_r * kLanes;
  const int64_t f0 = (int64_t)tile_f * kMatrixWarps;

  stage_planes<D>(xs, real, r0, n, L, lp);
  for (int e = threadIdx.x; e < kMatrixWarps * lp * W; e += blockDim.x) {
    const int w = e / (lp * W);
    const int k = e - w * lp * W;
    const int j = k / W;
    const int d = k - j * W;
    const int64_t f = f0 + w;
    ys[e] = (f < m && j < L && d < D) ? fake[(f * L + j) * D + d] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int64_t f = f0 + warp;
  if (f >= m) return;
  const float v = dtw_thread<D, true>(xs + lane, ys + warp * lp * W, L, lp);
  const int64_t r = r0 + lane;
  if (r < n) out[r * m + f] = v;
}

template <int D>
__global__ void __launch_bounds__(kLanes)
    dtw_pairs_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     float* __restrict__ out, int64_t P, int L) {
  extern __shared__ __align__(16) float smem[];
  const int lp = (L + kChunk - 1) / kChunk * kChunk;
  float* xs = smem;                              // (D, lp, kXStride)
  float* ys = smem + D * lp * kXStride;          // (D, lp, kXStride)
  const int64_t p0 = (int64_t)blockIdx.x * kLanes;
  // Columns beyond L are computed and ignored: give them defined values.
  for (int e = threadIdx.x; e < D * lp * kXStride; e += blockDim.x) ys[e] = 0.f;
  __syncthreads();
  stage_planes<D>(xs, x, p0, P, L, lp);
  stage_planes<D>(ys, y, p0, P, L, lp);
  __syncthreads();
  const int lane = threadIdx.x;
  const float v = dtw_thread<D, false>(xs + lane, ys + lane, L, lp);
  if (p0 + lane < P) out[p0 + lane] = v;
}

template <typename Kernel>
int allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <int D>
int launch_matrix(const float* real, const float* fake, float* out, int n, int m, int L,
                  cudaStream_t stream) {
  const int lp = (L + kChunk - 1) / kChunk * kChunk;
  const size_t smem =
      sizeof(float) * ((size_t)kMatrixWarps * lp * PackedPoint<D>::kWidth + D * lp * kXStride);
  const int64_t real_tiles = ((int64_t)n + kLanes - 1) / kLanes;
  const int64_t fake_tiles = ((int64_t)m + kMatrixWarps - 1) / kMatrixWarps;
  if (real_tiles * fake_tiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_shared(dtw_matrix_kernel<D>, smem)) return err;
  dtw_matrix_kernel<D><<<(unsigned)(real_tiles * fake_tiles), kMatrixWarps * kLanes, smem, stream>>>(
      real, fake, out, n, m, L, (int)fake_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_pairs(const float* x, const float* y, float* out, int64_t P, int L,
                 cudaStream_t stream) {
  const int lp = (L + kChunk - 1) / kChunk * kChunk;
  const size_t smem = sizeof(float) * 2 * D * lp * kXStride;
  const int64_t blocks = (P + kLanes - 1) / kLanes;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  if (int err = allow_shared(dtw_pairs_kernel<D>, smem)) return err;
  dtw_pairs_kernel<D><<<(unsigned)blocks, kLanes, smem, stream>>>(x, y, out, P, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both entries take contiguous float32 arrays on the device, run on `stream`
// without synchronising, and return the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue for a shape they do not take (D outside
// {2, 3}, L outside 1..128, no rows).

// real (n, L, D), fake (m, L, D) -> out (n, m), out[r, f] = DTW(real[r], fake[f]).
int wgg_dtw_matrix(const float* real, const float* fake, float* out, int n, int m, int L, int D,
                   void* stream) {
  if (n < 1 || m < 1 || L < 1 || L > kMaxLen) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 2) return launch_matrix<2>(real, fake, out, n, m, L, s);
  if (D == 3) return launch_matrix<3>(real, fake, out, n, m, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x, y (P, L, D) -> out (P,), out[p] = DTW(x[p], y[p]).
int wgg_dtw_pairs(const float* x, const float* y, float* out, long long P, int L, int D,
                  void* stream) {
  if (P < 1 || L < 1 || L > kMaxLen) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 2) return launch_pairs<2>(x, y, out, P, L, s);
  if (D == 3) return launch_pairs<3>(x, y, out, P, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wgg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
