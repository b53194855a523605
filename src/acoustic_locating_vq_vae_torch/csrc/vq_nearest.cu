// Nearest-codebook assignment for Hopper (sm_90a), FP32 CUDA cores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// acoustic_locating_vq_vae_tpu/ops/vq_pallas.py (driven by `_fwd_impl`).
// For each row x_n of x (N, D) it writes
//
//     idx[n]   = argmin_k (e2[k] - 2 * x_n . e_k)      (int32)
//     score[n] = min_k    (e2[k] - 2 * x_n . e_k)      (float32)
//
// the same score as the Pallas kernel: ||x_n||^2 is row-constant and never
// computed, e2[k] = ||e_k||^2 comes in precomputed (as in `_fwd_impl`), the
// dot products are plain FP32 FMAs summed over the features in ascending
// order (no TF32, no bf16), and on ties the lowest k wins. A row whose every
// score is NaN or +inf takes code 0 with score +inf. Ragged N, K and D are
// masked here; nothing is padded. The row gather codebook[idx] stays outside
// the kernel.
//
// The winning score is written beside the id so that a codebook split by rows
// over several ranks (tensor sharding) can merge the shards' winners: the
// least score, the lowest global index on equal scores. A code's score is
// one FMA chain over its features in ascending order, whatever the cluster
// split or the tile the code falls in, so it depends only on x_n, e_k and
// e2[k]: the shards' scores are bitwise the unsplit kernel's, and the merge
// picks the unsplit kernel's code.
//
// What bounds it. The work is 2*N*K*D FP32 operations against 4*(N*D + K*D +
// K + N) bytes: at B = 64 serving (N = 12,864, D = 64, K = 1024) 1.69 GFLOP
// and 3.6 MB, so the FP32 pipes bound it, not memory, and the (N, K) score
// matrix is never written anywhere.
//
// Design.
//   * Tile. A block of 256 threads owns BM = 128 rows and walks its share of
//     the codebook in tiles of BN = 128 codes. A thread keeps 8 x 8
//     accumulators (rows ty + 16 i, codes tx + 16 t) and reads both operands
//     from shared memory as float4 along the feature axis: 16 LDS.128 feed
//     256 FMAs. Tiles are row-major with a row stride of 4 * odd floats, so
//     the 16 code rows a warp reads hit distinct bank groups and its 2 x rows
//     are broadcast.
//   * Staging. Codebook tiles stream through a ring of STAGES = 3 chunks of
//     BK = 16 features filled by 16-byte cp.async.cg, so the loads of chunk
//     j + 2 overlap the FMAs of chunk j, with one __syncthreads() a chunk.
//     The ring runs on across code tiles. cp.async's source size zero-fills
//     rows past N or K and features past D. Where a row is not a whole
//     number of 16-byte pieces or a pointer is not 16-byte aligned, plain
//     masked loads fill the same tiles.
//   * The x tile stays resident in shared memory for D <= 128 (67,584 bytes
//     at D = 128) and is staged once per block; for larger D both operands
//     go through the ring.
//   * Small N. The codebook is cut into S slices (1, 2, 4 or 8) and the S
//     blocks of one row tile form a thread-block cluster: each folds its own
//     codes and writes its best per row into the shared memory of rank 0,
//     which merges the S candidates in slice order with a strict `<` after
//     one cluster barrier. No scratch in device
//     memory, one launch, and the same result in any schedule. The launcher
//     picks S from N, K and the SM count.
//   * Ties. A thread folds its codes in ascending order with a strict `<`; a
//     butterfly over the 16 threads of a row breaks equal scores toward the
//     lower code; slices are merged in ascending order. Scores are compared
//     as floats, so -0.0 and +0.0 tie.
//
// Times on the card (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, calls
// captured in a CUDA graph; K = 1024): 0.0121 ms at N = 1,608, D = 64 (bound
// 0.0032, addmm + argmin 0.0175), 0.0593 ms at N = 12,864, D = 64 (bound
// 0.0252, library 0.0919), 0.0331 ms at N = 6,432, D = 64 (bound 0.0126,
// library 0.0470) and 0.1122 ms at N = 16,000, D = 128 (bound 0.0626, library
// 0.1563). ptxas: 222 registers (254 where x is streamed too), no spills.
//
// What it leaves. A busy SM runs at the equivalent of 37 TFLOP/s, where this
// inner loop alone reaches 47.8, the feature-major SGEMM loop 53 to 55 and a
// register-only FMA chain 65.3 (scripts/h100_fp32_probe.py, same card):
// staging, the barrier and the argmin epilogue take a fifth, the loop's
// shape (cp.async cannot transpose, so four FMAs chain on an accumulator) a
// quarter. Row tiles of 128 quantise the grid: 101 row tiles at N = 12,864
// leave 31 of 132 SMs idle, and at N = 1,608 a block's smallest share, one
// 128 x 128 tile, gives 104 blocks. It runs on the FP32 pipes only:
// error-compensated 3xTF32 on the tensor cores (mma.sync.m16n8k8) would round
// every score differently, and whether that stays inside the 1e-6 tie rule
// at D = 128 is unmeasured.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int LANES = 16;    // threads across the rows, and across the codes
constexpr int THREADS = LANES * LANES;  // 256
constexpr int TM = 8;        // rows per thread
constexpr int TN = 8;        // codes per thread
constexpr int BM = LANES * TM;  // 128 rows per block
constexpr int BN = LANES * TN;  // 128 codes per codebook tile
constexpr int BK = 16;       // features per ring stage
constexpr int STAGES = 3;    // ring depth
constexpr int ES = BK + 4;   // row stride of a ring tile: 4 * odd floats
constexpr int XRES_MAX_D = 128;  // widest x tile kept resident
constexpr int MAX_SLICES = 8;    // the portable cluster size
constexpr int MAX_DEVICES = 64;
static_assert((ES / 4) % 2 == 1 && ES % 4 == 0, "conflict-free float4 reads need a stride of 4 * odd");

// The cluster's barrier in two halves, so that work can lie between them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Stages 4 features f .. f + 3 of row gr of src (total rows, d features) at
// `to`: zero where the row is past `total` or the feature past d.
__device__ __forceinline__ void fill_piece(float* to, const float* __restrict__ src, int gr, int total, int d,
                                           int f, bool aligned) {
  if (aligned) {
    const bool ok = gr < total && f < d;  // d is a multiple of 4 here: a piece is whole or absent
    cp_async16(to, ok ? src + (size_t)gr * d + f : src, ok ? 16 : 0);
  } else {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < total) {
      const float* from = src + (size_t)gr * d + f;
      if (f + 0 < d) v.x = from[0];
      if (f + 1 < d) v.y = from[1];
      if (f + 2 < d) v.z = from[2];
      if (f + 3 < d) v.w = from[3];
    }
    *reinterpret_cast<float4*>(to) = v;
  }
}

// Fills dst[r][0 .. width) for r in [0, rows) from src rows g0 + r, features
// 0 .. width, zero where the row is past `total` or the feature past d.
// width is a multiple of 4 and dst rows are dst_stride floats apart.
__device__ __forceinline__ void fill_tile(float* dst, int dst_stride, const float* __restrict__ src, int g0,
                                          int total, int rows, int d, int width, bool aligned) {
  const int pieces_per_row = width >> 2;
  const int pieces = rows * pieces_per_row;
  for (int e = threadIdx.x; e < pieces; e += THREADS) {
    const int r = e / pieces_per_row;
    const int f = (e - r * pieces_per_row) << 2;
    fill_piece(dst + r * dst_stride + f, src, g0 + r, total, d, f, aligned);
  }
}

template <bool XRES>
__global__ void __launch_bounds__(THREADS)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cb, const float* __restrict__ e2,
                  int32_t* __restrict__ idx, float* __restrict__ score, int n, int k, int d, int slices,
                  int aligned) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  __shared__ float cand_score[MAX_SLICES][BM];  // rank 0's: each slice's best per row
  __shared__ int cand_code[MAX_SLICES][BM];

  const int tid = threadIdx.x;
  const int tx = tid % LANES;
  const int ty = tid / LANES;
  const int slice = blockIdx.x % slices;  // the block's rank in its cluster
  const int row0 = (blockIdx.x / slices) * BM;
  // every block of the cluster has started once this barrier completes; it is
  // waited for only before the candidates go into rank 0's shared memory
  if (slices > 1) cluster_arrive();

  const int chunks = (d + BK - 1) / BK;  // ring stages per code tile
  const int dp = chunks * BK;
  const int xs = XRES ? dp + 4 : ES;     // row stride of the x operand
  float* xres = smem;                    // XRES: (BM, dp + 4)
  float* ring = XRES ? smem + BM * (dp + 4) : smem;
  constexpr int STAGE_FLOATS = (XRES ? BN : BM + BN) * ES;

  const int tiles_total = (k + BN - 1) / BN;
  const int tiles_per_slice = (tiles_total + slices - 1) / slices;
  const int tile_begin = slice * tiles_per_slice;
  const int ntiles = max(0, min(tiles_total, tile_begin + tiles_per_slice) - tile_begin);
  const int total_chunks = ntiles * chunks;

  // the next chunk to stage, as (code tile of this slice, feature chunk)
  int fill_tile_i = 0, fill_chunk_i = 0;
  // a ring stage is BK / 4 = 4 pieces a row: thread tid stages pieces tid and tid + 256 of
  // each operand, the same row and piece of every chunk
  constexpr int PPR = BK / 4;
  constexpr int PER_THREAD = BN * PPR / THREADS;
  static_assert(BN * PPR % THREADS == 0 && BM == BN, "whole pieces a thread");
  const int fr = tid / PPR;              // row within the tile, + p * (THREADS / PPR)
  const int fo = (tid % PPR) * 4;        // feature offset within the chunk
  auto fill_next = [&](int stage) {
    float* s = ring + stage * STAGE_FLOATS + fr * ES + fo;
    const int f = fill_chunk_i * BK + fo;
    if (!XRES) {
#pragma unroll
      for (int p = 0; p < PER_THREAD; ++p) {
        const int gr = row0 + fr + p * (THREADS / PPR);
        fill_piece(s + p * (THREADS / PPR) * ES, x, gr, n, d, f, aligned);
      }
      s += BM * ES;
    }
    const int c0 = (tile_begin + fill_tile_i) * BN + fr;
#pragma unroll
    for (int p = 0; p < PER_THREAD; ++p) {
      const int gc = c0 + p * (THREADS / PPR);
      fill_piece(s + p * (THREADS / PPR) * ES, cb, gc, k, d, f, aligned);
    }
    if (++fill_chunk_i == chunks) {
      fill_chunk_i = 0;
      ++fill_tile_i;
    }
  };

  // prologue: the resident x tile and the first STAGES - 1 chunks
  if (XRES && ntiles > 0) fill_tile(xres, xs, x, row0, n, BM, d, dp, aligned);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total_chunks) fill_next(s);
    cp_async_commit();
  }

  float best[TM];
  int bidx[TM];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    bidx[i] = INT_MAX;
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[i][t] = 0.f;
  }

  int tile = 0, chunk = 0, stage = 0;
  for (int q = 0; q < total_chunks; ++q) {
    cp_async_wait<STAGES - 2>();  // chunk q has landed
    __syncthreads();              // ... for every thread, and chunk q - 1 is computed
    // refill the stage that chunk q - 1 used with chunk q + STAGES - 1
    if (q + STAGES - 1 < total_chunks) fill_next(stage == 0 ? STAGES - 1 : stage - 1);
    cp_async_commit();

    const float* stage_base = ring + stage * STAGE_FLOATS;
    const float* xa = (XRES ? xres + chunk * BK : stage_base) + ty * xs;
    const float* eb = (XRES ? stage_base : stage_base + BM * ES) + tx * ES;
#pragma unroll
    for (int j = 0; j < BK; j += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(xa + i * LANES * xs + j);
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const float4 b = *reinterpret_cast<const float4*>(eb + t * LANES * ES + j);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float v = acc[i][t];
          v = fmaf(a[i].x, b.x, v);
          v = fmaf(a[i].y, b.y, v);
          v = fmaf(a[i].z, b.z, v);
          v = fmaf(a[i].w, b.w, v);
          acc[i][t] = v;
        }
      }
    }

    if (++chunk == chunks) {
      // codes tx, tx + 16, ... ascend with t, so a strict < keeps the first
      const int c0 = (tile_begin + tile) * BN + tx;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        const int c = c0 + t * LANES;
        const float ec = c < k ? __ldg(e2 + c) : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = fmaf(-2.f, acc[i][t], ec);
          if (c < k && s < best[i]) {
            best[i] = s;
            bidx[i] = c;
          }
          acc[i][t] = 0.f;
        }
      }
      chunk = 0;
      ++tile;
    }
    stage = stage + 1 == STAGES ? 0 : stage + 1;
  }
  cp_async_wait<0>();

  // the 16 threads of one row group are lanes [16h, 16h + 16) of a warp; the
  // row's best of this slice goes into the shared memory of the block of rank 0
  cg::cluster_group cluster = cg::this_cluster();
  float* to_score = cand_score[slice];
  int* to_code = cand_code[slice];
  if (slices > 1) {
    cluster_wait();
    to_score = cluster.map_shared_rank(to_score, 0);
    to_code = cluster.map_shared_rank(to_code, 0);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = best[i];
    int c = bidx[i];
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
      const float so = __shfl_xor_sync(0xffffffffu, s, off);
      const int co = __shfl_xor_sync(0xffffffffu, c, off);
      if (so < s || (so == s && co < c)) {
        s = so;
        c = co;
      }
    }
    if (tx == 0) {
      to_score[ty + i * LANES] = s;
      to_code[ty + i * LANES] = c;
    }
  }
  if (slices > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // slices hold ascending code ranges: merged in slice order with a strict <
  if (slice == 0 && tid < BM) {
    float s = cand_score[0][tid];
    int c = cand_code[0][tid];
    for (int r = 1; r < slices; ++r) {
      const float so = cand_score[r][tid];
      if (so < s) {
        s = so;
        c = cand_code[r][tid];
      }
    }
    // a row whose every score was +inf or NaN takes code 0 (as argmin does), its score +inf
    if (row0 + tid < n) {
      idx[row0 + tid] = (c == INT_MAX) ? 0 : c;
      score[row0 + tid] = s;
    }
  }
}

size_t smem_bytes(bool xres, int d) {
  if (!xres) return (size_t)STAGES * (BM + BN) * ES * sizeof(float);
  const int dp = (d + BK - 1) / BK * BK;
  return ((size_t)BM * (dp + 4) + (size_t)STAGES * BN * ES) * sizeof(float);
}

int current_device() {
  int dev = 0;
  return (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < MAX_DEVICES) ? dev : 0;
}

int sm_count() {
  static int cached[MAX_DEVICES] = {};
  const int dev = current_device();
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    cached[dev] = 132;
  return cached[dev];
}

template <bool XRES>
int launch(const float* x, const float* cb, const float* e2, int32_t* idx, float* score, int n, int k, int d,
           int slices, int aligned, cudaStream_t stream) {
  auto kernel = vq_nearest_kernel<XRES>;
  static bool raised[MAX_DEVICES] = {};  // the shared-memory limit is raised once a device
  const int dev = current_device();
  if (!raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem_bytes(XRES, XRES_MAX_D));
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)((n + BM - 1) / BM) * (unsigned)slices);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem_bytes(XRES, d);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)slices;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, x, cb, e2, idx, score, n, k, d, slices, aligned);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

__global__ void noop_kernel() {}

}  // namespace

// Launches on `stream` and returns the CUDA error of the launch (0 on success).
extern "C" int vq_nearest_launch(const float* x, const float* cb, const float* e2, int32_t* idx, float* score,
                                 int n, int k, int d, void* stream) {
  if (n <= 0 || k <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int row_tiles = (n + BM - 1) / BM;
  const int code_tiles = (k + BN - 1) / BN;
  // slices: least (waves of blocks) x (code tiles a block walks, plus half a
  // tile for its prologue); equal costs go to fewer slices, which stage x
  // less often
  const int sms = sm_count();
  int slices = 1;
  double best_cost = 0.;
  for (int s = 1; s <= MAX_SLICES && s <= code_tiles; s *= 2) {
    const long long blocks = (long long)row_tiles * s;
    const double cost = (double)((blocks + sms - 1) / sms) * ((code_tiles + s - 1) / s + 0.5);
    if (s == 1 || cost < best_cost) {
      slices = s;
      best_cost = cost;
    }
  }
  const int aligned = d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)cb % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return d <= XRES_MAX_D ? launch<true>(x, cb, e2, idx, score, n, k, d, slices, aligned, st)
                         : launch<false>(x, cb, e2, idx, score, n, k, d, slices, aligned, st);
}

// One launch of a kernel that does nothing: the card's floor for one launch.
extern "C" int vq_noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
