// Per-code accumulation of rows for Hopper (sm_90a), FP32 CUDA cores.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// acoustic_locating_vq_vae_tpu/ops/vq_pallas.py in both of its uses:
//
//   * the codebook gradient (`_dcb_impl`, driven by `_vjp_bwd`):
//         out[k] = sum over n with idx[n] == k of g[n]          (K, D)
//   * the EMA statistics (`codebook_stats_pallas`, the same kernel run on
//     [x | 1]): the same sums, and with `counts` given also
//         counts[k] = #{n : idx[n] == k}                          (K,) float32
//
// It sums directly: no one-hot matrix, no GEMM, no padding and no ones
// column. Indices outside [0, K) add nothing (the Pallas padding rows carry
// -1 for that reason).
//
// Determinism. No float atomics: every output element is summed in one fixed
// order, so two launches on the same inputs give bitwise-equal results.
//
// What bounds it. At the speech shape (N = 16,000, D = 128, K = 1024) the
// bytes that must move are 4*N*D + 4*N + 4*K*D = 8.8 MB, about 2.6 us at
// 3.35 TB/s, against N*D = 2.0 M adds: it is bound by bytes, and at this size
// launch latency and the partial sums' round trip decide its time.
//
// Design. Pass 1: the rows are cut into R chunks of CHUNK rows. A block per
// (code tile of KB codes, feature tile of DT features, row chunk) walks its
// chunk in ascending row order, CHUNK_STEP rows at a time: each thread reads
// one index, the warps find the rows that fall in the block's code tile with
// __ballot_sync and write them, still in ascending order, to a list in shared
// memory. Then each thread, which owns one feature column, adds those rows'
// values into its column of the tile's accumulators in shared memory, in
// list order (loads issued UNROLL at a time, adds in order). Integer counts
// use shared-memory integer atomics, exact in any order. The block writes
// its partial (KB, DT) tile into scratch (R, K, D). Pass 2 sums the R
// partials of each element in chunk order. With R = 1 pass 1 writes the
// output directly and pass 2 is skipped. A skewed input (every row on one
// code) stays parallel over chunks and feature tiles.
//
// What it leaves on the table: the (R, K, D) partials round trip through
// device memory (8 MB at the speech shape), each code tile re-reads the
// chunk's indices (from L2), and at D < DT threads sit idle.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int KB = 32;          // codes per block
constexpr int DT = 128;         // features per block = threads per block
constexpr int THREADS = DT;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK_STEP = THREADS;  // rows staged per step, one index a thread
constexpr int CHUNK = 1024;     // rows per chunk (one partial per chunk)
constexpr int UNROLL = 8;       // independent row loads in flight per thread
static_assert(CHUNK % CHUNK_STEP == 0, "a chunk is whole staging steps");

__global__ void __launch_bounds__(THREADS)
accum_partial_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g,
                     float* __restrict__ part, float* __restrict__ part_counts,
                     int n, int k, int d) {
  __shared__ float acc[KB][DT];
  __shared__ int cnt[KB];
  __shared__ int list_row[CHUNK_STEP];
  __shared__ int list_code[CHUNK_STEP];
  __shared__ int warp_total[WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k0 = blockIdx.x * KB;
  const int d0 = blockIdx.y * DT;
  const int chunk = blockIdx.z;
  const int col = d0 + tid;
  const bool col_ok = col < d;
  // only the first feature tile counts, so each count is made once
  const bool counting = part_counts != nullptr && blockIdx.y == 0;

#pragma unroll
  for (int c = 0; c < KB; ++c) acc[c][tid] = 0.f;
  if (tid < KB) cnt[tid] = 0;

  const int r_begin = chunk * CHUNK;
  const int r_end = min(n, r_begin + CHUNK);
  for (int s = r_begin; s < r_end; s += CHUNK_STEP) {
    const int row = s + tid;
    int c = -1;
    if (row < r_end) {
      const int v = idx[row];
      if (v >= k0 && v < k0 + KB && v < k) c = v - k0;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, c >= 0);
    if (lane == 0) warp_total[warp] = __popc(hit);
    __syncthreads();
    int offset = 0;
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      offset += (w < warp) ? warp_total[w] : 0;
      total += warp_total[w];
    }
    if (c >= 0) {
      // rank among this warp's hits keeps the list in ascending row order
      const int pos = offset + __popc(hit & ((1u << lane) - 1u));
      list_row[pos] = row;
      list_code[pos] = c;
      if (counting) atomicAdd(&cnt[c], 1);
    }
    __syncthreads();
    if (col_ok) {
      for (int j0 = 0; j0 < total; j0 += UNROLL) {
        float v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          v[u] = (j0 + u < total) ? g[(size_t)list_row[j0 + u] * d + col] : 0.f;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (j0 + u < total) acc[list_code[j0 + u]][tid] += v[u];
      }
    }
    __syncthreads();  // the list is rewritten by the next step
  }

  float* out = part + (size_t)chunk * k * d;
  if (col_ok) {
    for (int c = 0; c < KB && k0 + c < k; ++c) out[(size_t)(k0 + c) * d + col] = acc[c][tid];
  }
  if (counting && tid < KB && k0 + tid < k)
    part_counts[(size_t)chunk * k + k0 + tid] = (float)cnt[tid];
}

__global__ void sum_partials_kernel(const float* __restrict__ part, const float* __restrict__ part_counts,
                                    float* __restrict__ out, float* __restrict__ counts,
                                    int chunks, int k, int d) {
  const size_t kd = (size_t)k * d;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < kd; e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < chunks; ++r) s += part[r * kd + e];
    out[e] = s;
    if (counts != nullptr && e < (size_t)k) {
      float c = 0.f;
      for (int r = 0; r < chunks; ++r) c += part_counts[(size_t)r * k + e];
      counts[e] = c;
    }
  }
}

int num_chunks(int n) { return (n + CHUNK - 1) / CHUNK; }

}  // namespace

// Floats of scratch the launch needs: the (R, K, D) partial sums and, with
// counts, the (R, K) partial counts; 0 when one chunk holds every row.
extern "C" long long vq_codebook_accum_scratch_floats(int n, int k, int d, int with_counts) {
  const long long r = num_chunks(n);
  if (r <= 1) return 0;
  return r * k * d + (with_counts ? r * k : 0);
}

// out (K, D) and, unless null, counts (K,); scratch as sized above (null when
// that is 0). Launches on `stream` and returns cudaGetLastError().
extern "C" int vq_codebook_accum_launch(const int32_t* idx, const float* g, float* out, float* counts,
                                        float* scratch, int n, int k, int d, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int r = num_chunks(n);
  if (r > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((k + KB - 1) / KB), (unsigned)((d + DT - 1) / DT), (unsigned)r);
  if (r == 1) {
    accum_partial_kernel<<<grid, THREADS, 0, st>>>(idx, g, out, counts, n, k, d);
    return (int)cudaGetLastError();
  }
  float* part = scratch;
  float* part_counts = counts != nullptr ? scratch + (size_t)r * k * d : nullptr;
  accum_partial_kernel<<<grid, THREADS, 0, st>>>(idx, g, part, part_counts, n, k, d);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t kd = (size_t)k * d;
  const unsigned blocks = (unsigned)((kd + 255) / 256 < 4096 ? (kd + 255) / 256 : 4096);
  sum_partials_kernel<<<blocks, 256, 0, st>>>(part, part_counts, out, counts, r, k, d);
  return (int)cudaGetLastError();
}
