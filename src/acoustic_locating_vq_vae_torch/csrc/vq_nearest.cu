// Nearest-codebook assignment for Hopper (sm_90a), FP32 CUDA cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// acoustic_locating_vq_vae_tpu/ops/vq_pallas.py (driven by `_fwd_impl`).
// For each row x_n of x (N, D) it writes
//
//     idx[n] = argmin_k (e2[k] - 2 * x_n . e_k)        (int32)
//
// the same score as the Pallas kernel: ||x_n||^2 is row-constant and never
// computed, e2[k] = ||e_k||^2 comes in precomputed (as in `_fwd_impl`), the
// dot products are plain FP32 FMAs (no TF32, no bf16), and on ties the
// lowest k wins. Ragged N and K are masked here; nothing is padded. The row
// gather codebook[idx] stays outside the kernel (index_select).
//
// What bounds it. At B = 64 serving (N = 64 * 201 = 12,864, D = 64, K = 1024)
// the work is 2*N*K*D = 1.69 GFLOP of FP32 FMA: about 25 us at the H100 SXM's
// ~67 TFLOP/s of non-tensor FP32. The bytes that must move are about 3.6 MB
// (x, codebook, e2 in; idx out): about 1 us at 3.35 TB/s. So it is
// compute-bound, and the (N, K) score matrix is never written to memory.
//
// Design. Each block of 256 threads owns a tile of BM = 64 rows and walks the
// whole codebook in tiles of BN = 64 codes; for each code tile the feature
// axis is staged through shared memory in chunks of BK = 16, transposed so
// that the inner loop reads x and e as broadcasts / consecutive words. Each
// thread accumulates a 4 x 4 register tile (rows ty + 16 i, codes tx + 16 t),
// then folds its codes, in ascending order, into a running (min, argmin) per
// row with a strict `<`. A butterfly shuffle over the 16 threads that share a
// row merges the candidates, breaking equal scores toward the lower index, so
// the result is the first minimum exactly as torch.argmin / jnp.argmin give.
//
// What it leaves on the table: it runs on the FP32 pipes only (the tensor
// cores would need error-compensated 3xTF32 to keep the near-tie argmin
// exact), re-reads each x tile from L2 once per code tile, loads through
// registers instead of cp.async/TMA with no double buffering, and at B = 8
// (N = 1,608) launches only 26 blocks for 132 SMs.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 64;   // rows per block
constexpr int BN = 64;   // codes per codebook tile
constexpr int BK = 16;   // features staged in shared memory per step
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // codes per thread
constexpr int ROW_LANES = BM / TM;   // 16
constexpr int CODE_LANES = BN / TN;  // 16
constexpr int THREADS = ROW_LANES * CODE_LANES;  // 256
static_assert(BM == BN, "the staging loop fills the x and codebook tiles together");
static_assert(CODE_LANES == 16, "the row reduction shuffles within 16 lanes");

__global__ void __launch_bounds__(THREADS)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                  const float* __restrict__ e2, int32_t* __restrict__ idx,
                  int n, int k, int d) {
  // +1 padding keeps the transposed stores free of most bank conflicts
  __shared__ float xs[BK][BM + 1];
  __shared__ float es[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % CODE_LANES;
  const int ty = tid / CODE_LANES;
  const int row0 = blockIdx.x * BM;

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    bidx[i] = INT_MAX;
  }

  for (int c0 = 0; c0 < k; c0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[i][t] = 0.f;

    for (int d0 = 0; d0 < d; d0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK;
        const int j = e % BK;
        const int gj = d0 + j;
        const int gr = row0 + r;
        const int gc = c0 + r;
        xs[j][r] = (gr < n && gj < d) ? x[(size_t)gr * d + gj] : 0.f;
        es[j][r] = (gc < k && gj < d) ? cb[(size_t)gc * d + gj] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[j][ty + i * ROW_LANES];
#pragma unroll
        for (int t = 0; t < TN; ++t) b[t] = es[j][tx + t * CODE_LANES];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int t = 0; t < TN; ++t) acc[i][t] = fmaf(a[i], b[t], acc[i][t]);
      }
      __syncthreads();
    }

    // codes tx, tx + 16, ... ascend with t, so a strict < keeps the first
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const int c = c0 + tx + t * CODE_LANES;
      if (c < k) {
        const float ec = e2[c];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = fmaf(-2.f, acc[i][t], ec);
          if (s < best[i]) {
            best[i] = s;
            bidx[i] = c;
          }
        }
      }
    }
  }

  // the 16 threads of one row group are lanes [16h, 16h + 16) of a warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = best[i];
    int c = bidx[i];
#pragma unroll
    for (int off = CODE_LANES / 2; off > 0; off >>= 1) {
      const float so = __shfl_xor_sync(0xffffffffu, s, off);
      const int co = __shfl_xor_sync(0xffffffffu, c, off);
      if (so < s || (so == s && co < c)) {
        s = so;
        c = co;
      }
    }
    const int r = row0 + ty + i * ROW_LANES;
    // a row whose every score was +inf or NaN takes code 0, as argmin does
    if (tx == 0 && r < n) idx[r] = (c == INT_MAX) ? 0 : c;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int vq_nearest_launch(const float* x, const float* cb, const float* e2,
                                 int32_t* idx, int n, int k, int d, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + BM - 1) / BM));
  vq_nearest_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, cb, e2, idx, n, k, d);
  return (int)cudaGetLastError();
}
