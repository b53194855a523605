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
// Determinism. No float atomics: every output element is summed in an order
// that depends on the input alone, so two launches on the same inputs give
// bitwise-equal results.
//
// What bounds it. At the speech shape (N = 16,000, D = 128, K = 1024) the
// bytes that must move are 4*N*D + 4*N + 4*K*D = 8.8 MB against N*D = 2.0 M
// adds: it is bound by bytes, and at this size the latency of one launch and
// of a few dependent trips to memory is as long as the transfer itself.
//
// Design: one launch, no scratch, `g` read once.
//   * A cluster of CB = 8 blocks owns a tile of 8 codes and one slice of up
//     to DS = 128 features (grid.y walks wider D). The blocks of the cluster
//     cut the N rows into 8 contiguous shares, so the cluster reads every
//     index once, 16 bytes a thread, and a skewed input (every row on one
//     code) is still pulled in by 8 SMs.
//   * Compaction. A block scans its share in rounds of ROUND = 2048 rows. A
//     lane holds 16 indices of a round in registers; ballots and popcounts
//     rank the rows that fall in the tile, one prefix over the warps' totals
//     places them, and each lane writes its hits, so the list in shared
//     memory is in ascending row order with two barriers a round. A round's
//     list cannot outgrow the round, so nothing overflows at any N.
//   * The sum. Each warp takes a fixed, contiguous quarter of the list; a
//     lane owns 4 adjacent columns (one 16-byte load a row where D and the
//     pointer allow, masked scalar loads otherwise), keeps 4 row loads in
//     flight and adds in list order. Runs of one code are summed in
//     registers and flushed into the warp's own accumulators in shared
//     memory, the run lengths giving the counts without atomics. The warps'
//     partial sums are added in warp order.
//   * Each block writes its partial sums of code k0 + r into the shared
//     memory of the block of rank r (distributed shared memory); after one
//     cluster barrier rank r adds the 8 partials in rank order and writes the
//     row of code k0 + r (zeros for an unused code) and its count.
//
// Times on the card (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, calls
// captured in a CUDA graph; K = 1024): 0.0101 ms for either mode at N =
// 16,000, D = 128 (bound 0.0026; one index_add_ 0.0146), 0.0116 ms with a
// cold L2 (index_add_ 0.0186), 0.0145 ms with 32 codes in use, 0.0721 ms with
// one code in use (index_add_ 0.0788), and 0.0086 ms at N = 6,432, D = 64,
// where index_add_ takes 0.0053 ms. ptxas: 56 registers, 24,752 bytes of
// shared memory, no spills, so 8 blocks an SM and all 1024 in one wave.
//
// What it leaves. The kernel is a chain of latencies, not of bytes: the
// launch, the cluster barrier, the index scan, the rows' loads and the
// exchange each take a microsecond or two, against 0.0009 ms for an empty
// launch. A shape as small as the RIR stage's pays the same chain and loses
// to index_add_'s single pass of atomics there. The index traffic from L2 is
// (K / 8) * 4N bytes per feature slice, as much as g's own 4*N*D bytes when
// D = K / 8, and a single code's rows are pulled in by 8 SMs at most, with 16
// row loads in flight each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int CB = 8;            // codes per cluster = blocks per cluster
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int DS = 128;          // features per slice: 32 lanes x 4 columns
constexpr int SUBS = 4;          // int4 index loads a lane holds per round
constexpr int ROUND = WARPS * SUBS * 32 * 4;  // 2048 rows scanned per round
constexpr int UNROLL = 4;        // row loads in flight per lane
static_assert(THREADS == DS, "the combine steps give every thread one column");
static_assert(CB == 8 && ROUND * CB <= 65536, "a list entry packs row and code into 16 bits");

// The cluster's barrier in two halves, so that work can lie between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p, int valid, bool aligned) {
  if (aligned && valid >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) v.x = __ldg(p);
  if (valid > 1) v.y = __ldg(p + 1);
  if (valid > 2) v.z = __ldg(p + 2);
  if (valid > 3) v.w = __ldg(p + 3);
  return v;
}

__global__ void __launch_bounds__(THREADS)
accum_kernel(const int32_t* __restrict__ idx, const float* __restrict__ g, float* __restrict__ out,
             float* __restrict__ counts, int n, int k, int d, int aligned_idx, int aligned_g) {
  __shared__ uint16_t list[ROUND];               // (row in round) << 3 | code in tile
  __shared__ float4 wacc[WARPS][CB][32];         // each warp's sums, lane-major columns
  __shared__ int wcnt[WARPS][CB];
  __shared__ float gather[CB][DS];               // rank r's sums of this block's code, written by r
  __shared__ int gather_cnt[CB];
  __shared__ int warp_total[WARPS];

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rank = blockIdx.x % CB;              // the block's rank in its cluster
  const int k0 = (blockIdx.x / CB) * CB;
  const int d0 = blockIdx.y * DS;
  const int col = d0 + lane * 4;
  const int valid = min(4, d - col);             // columns this lane owns (<= 0: none)
  const unsigned lt = (1u << lane) - 1u;

  // every block of the cluster has started once this barrier completes; it is
  // waited for only before the first write into another block's shared memory
  cluster_arrive();

#pragma unroll
  for (int c = 0; c < CB; ++c) wacc[warp][c][lane] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < CB) wcnt[warp][lane] = 0;
  __syncwarp();

  // this block's contiguous share of the rows, a multiple of 4 rows long
  const int share = ((n + CB - 1) / CB + 3) & ~3;
  const int r_begin = min(n, rank * share);
  const int r_end = min(n, r_begin + share);

  for (int base = r_begin; base < r_end; base += ROUND) {
    // ---- scan: 16 indices a lane, ranked in ascending row order
    int v[SUBS][4];
#pragma unroll
    for (int s = 0; s < SUBS; ++s) {  // all loads first, so that they are in flight together
      const int row = base + ((warp * SUBS + s) * 32 + lane) * 4;
      if (aligned_idx && row + 3 < r_end) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(idx + row));
        v[s][0] = q.x, v[s][1] = q.y, v[s][2] = q.z, v[s][3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[s][e] = row + e < r_end ? __ldg(idx + row + e) : -1;
      }
    }
    int hits[SUBS][4];
    int excl[SUBS];
    int total = 0;
#pragma unroll
    for (int s = 0; s < SUBS; ++s) {
      int before = total;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = v[s][e] - k0;
        const bool hit = c >= 0 && c < CB && v[s][e] < k;
        hits[s][e] = hit ? c : -1;
        const unsigned b = __ballot_sync(0xffffffffu, hit);
        before += __popc(b & lt);
        total += __popc(b);
      }
      // hits of the warp's earlier sub-steps and of the lanes before this one:
      // a lane's four rows are adjacent, so all of them come first
      excl[s] = before;
    }
    if (lane == 0) warp_total[warp] = total;
    __syncthreads();  // also: the sums of the round before are done with the list
    int offset = 0, listed = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      offset += w < warp ? warp_total[w] : 0;
      listed += warp_total[w];
    }
#pragma unroll
    for (int s = 0; s < SUBS; ++s) {
      int pos = offset + excl[s];
      const int row_in_round = ((warp * SUBS + s) * 32 + lane) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (hits[s][e] >= 0) list[pos++] = (uint16_t)(((row_in_round + e) << 3) | hits[s][e]);
    }
    __syncthreads();

    // ---- sum: this warp's quarter of the list, in list order
    const int per_warp = (listed + WARPS - 1) / WARPS;
    const int lo = min(listed, warp * per_warp);
    const int hi = min(listed, lo + per_warp);
    int cur = -1, run = 0;
    float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = lo; j < hi; j += UNROLL) {
      int e[UNROLL];
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        e[u] = j + u < hi ? list[j + u] : -1;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e[u] >= 0 && valid > 0)
          v[u] = load4(g + (size_t)(base + (e[u] >> 3)) * d + col, valid, aligned_g);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e[u] < 0) continue;
        const int c = e[u] & (CB - 1);
        if (c != cur) {
          if (cur >= 0) {
            float4 a = wacc[warp][cur][lane];
            a.x += s4.x, a.y += s4.y, a.z += s4.z, a.w += s4.w;
            wacc[warp][cur][lane] = a;
            if (lane == 0) wcnt[warp][cur] += run;
          }
          cur = c;
          run = 0;
          s4 = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        s4.x += v[u].x, s4.y += v[u].y, s4.z += v[u].z, s4.w += v[u].w;
        ++run;
      }
    }
    if (cur >= 0) {
      float4 a = wacc[warp][cur][lane];
      a.x += s4.x, a.y += s4.y, a.z += s4.z, a.w += s4.w;
      wacc[warp][cur][lane] = a;
      if (lane == 0) wcnt[warp][cur] += run;
    }
  }
  __syncthreads();

  // ---- the block's partial tile, warps in order, one column a thread; the
  // sums of code k0 + c go into the shared memory of the block of rank c
  cluster_wait();
#pragma unroll
  for (int c = 0; c < CB; ++c) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += reinterpret_cast<const float*>(&wacc[w][c][0])[tid];
    cluster.map_shared_rank(&gather[0][0], c)[rank * DS + tid] = s;
  }
  if (tid < CB) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += wcnt[w][tid];
    cluster.map_shared_rank(gather_cnt, tid)[rank] = s;
  }
  cluster_arrive();
  cluster_wait();

  // ---- the cluster's tile: this block adds the 8 ranks' sums of its code in
  // rank order, from its own shared memory, and writes the code's row
  const int code = k0 + rank;
  if (code < k) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < CB; ++r) s += gather[r][tid];
    if (d0 + tid < d) out[(size_t)code * d + d0 + tid] = s;
    if (counts != nullptr && blockIdx.y == 0 && tid == 0) {
      int c = 0;
#pragma unroll
      for (int r = 0; r < CB; ++r) c += gather_cnt[r];
      counts[code] = (float)c;
    }
  }
}

}  // namespace

// out (K, D) and, unless null, counts (K,). One launch on `stream`; returns
// the CUDA error of the launch (0 on success).
extern "C" int vq_codebook_accum_launch(const int32_t* idx, const float* g, float* out, float* counts, int n,
                                        int k, int d, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const unsigned slices = (unsigned)((d + DS - 1) / DS);
  if (slices > 65535u) return (int)cudaErrorInvalidValue;
  const int aligned_idx = (uintptr_t)idx % 16 == 0;
  const int aligned_g = d % 4 == 0 && (uintptr_t)g % 16 == 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((k + CB - 1) / CB) * CB, slices);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = 0;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CB;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, accum_kernel, idx, g, out, counts, n, k, d, aligned_idx, aligned_g);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
