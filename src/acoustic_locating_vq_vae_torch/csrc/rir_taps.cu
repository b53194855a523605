// Image-source room impulse responses for Hopper (sm_90a): the tap build,
// fused and deterministic, CUDA cores.
//
// Replaces no Pallas kernel. The JAX package lowers the tap build through
// XLA (dsp/rir.py: the (B, chunk, W) taps of a chunk of lattice images and
// their `one_hot(block)ᵀ @ taps` sum); the port's plain version
// (dsp/rir.py:_block_matmul) runs the same tensor program eagerly, which on
// the card moved hundreds of bytes of device memory for every tap it built.
// Here every tap is made in registers and added once.
//
// What it computes. For source b and output sample p in [0, nsample):
//
//     out[b, p] = sum over images i with |p - d_i| in the window of
//                 gain_i * 0.5 (1 + cos(2 pi t / tw)) * sinc(t),  t = p - d_i
//
// d_i the image's distance in samples, gain_i = prod beta^|.| / (4 pi d cTs),
// the taps of an image at p in [floor(d) - tw/2 + 1, floor(d) + tw/2], images
// with floor(d) >= nsample dropped, sinc(0) = 1, sin(pi t) / (pi t + 1e-30)
// elsewhere: the plain version's taps, in the sources' type T (float or
// double), with the same hoisting. The three transcendentals of a tap are
// taken once per image: with an even k0 <= the window's first tap and
// e = d - k0, t = n - e for n = p - k0 in [0, tw], so
//     sin(pi t)        = -(-1)^n sin(pi e) = -(-1)^n (-1)^floor(d) sin(pi frac(d))
//     cos(2 pi t / tw) = cos(2 pi n / tw) cos(2 pi e / tw) + sin(2 pi n / tw) sin(2 pi e / tw)
// and e lies in [tw/2 - 1, tw/2 + 1): the window-local range reduction that
// keeps the taps exact at distances of thousands of samples. sinpi and
// sincospi take those arguments without a rounded product by pi.
//
// Determinism. No atomics: a thread owns one output sample and adds the taps
// that land on it in the plan's order, in a float64 accumulator (more
// precision than the plain version's float32 sums, never less), so two
// launches on the same inputs give bitwise-equal results.
//
// The plan (dsp/rir.py:_tap_plan, made on the host once per geometry and
// kept on the card): the output cut into segments of SEG samples, and for
// each segment the lattice rows whose taps can land in it for any position
// inside the cull's intervals, in the lattice's order, heaviest segment
// first.
//
// Design. One block per (source, segment), SEG threads, one output sample
// each. The block walks its segment's rows in tiles of SEG: each thread
// computes one row's distance, gain and hoisted terms for this source into
// shared memory (structure of arrays), then every thread runs over the tile
// and adds each row whose tw-wide window covers its sample. A row's window
// covers consecutive samples, so a warp takes or skips most rows together.
// The block first fills shared memory with the taps' cos / sin table and
// each wall's beta^k (computed in double, rounded to T once). SEG = 128 at
// the cell's batch: 3,200 blocks, against 1,600 of SEG = 256, let the card
// balance the far segments' long lists (4.95 against 5.75 ms), and two
// samples a thread lost (6.66 ms; chip_smoke.py's timings, PERF.md).
//
// What bounds it. At the on-the-fly cell (B = 64, 6,400 taps, 179,443 lattice
// rows of the boxed cull, 476,896 (row, segment) pairs at SEG = 128) the work
// is about 1.5 G taps of a dozen operations each and 3.9 G window checks; the
// bytes are the output's 1.6 MB and the plan's 7.6 MB (read from L2), so it is
// bound by instructions, not by memory.
// The farthest segments hold the most rows (their images fill a shell that
// grows as d^2), which is why they are launched first.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNever = 0x40000000;  // a window start that no sample reaches
constexpr double kPi = 3.14159265358979323846;

__device__ __forceinline__ void sincos_pi(float x, float* s, float* c) { sincospif(x, s, c); }
__device__ __forceinline__ void sincos_pi(double x, double* s, double* c) { sincospi(x, s, c); }
__device__ __forceinline__ float sin_pi(float x) { return sinpif(x); }
__device__ __forceinline__ double sin_pi(double x) { return sinpi(x); }

template <typename T>
__device__ __forceinline__ T tap(int n, T t, T gain, T ce, T se, T spe, const T* cos_n, const T* sin_n, T pi) {
  const T window = (T)0.5 * ((T)1 + cos_n[n] * ce + sin_n[n] * se);
  const T sin_pt = (n & 1) ? spe : -spe;
  const T sinc = t == (T)0 ? (T)1 : sin_pt / (pi * t + (T)1e-30);
  return gain * window * sinc;
}

template <typename T>
__global__ void __launch_bounds__(256) rir_taps_kernel(
    const T* __restrict__ src, const T* __restrict__ recv, const T* __restrict__ beta, int beta_sb, int beta_sw,
    const int4* __restrict__ entries, const int* __restrict__ slot_ptr, const int* __restrict__ slot_seg,
    const T* __restrict__ table, T* __restrict__ out, int nsample, int tw, int max_pow, double lx_d, double ly_d,
    double lz_d, double cts_d) {
  const int seg = blockDim.x;
  const int b = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int npow = max_pow + 1;
  extern __shared__ double smem[];
  T* d_s = reinterpret_cast<T*>(smem);
  T* g_s = d_s + seg;
  T* ce_s = g_s + seg;
  T* se_s = ce_s + seg;
  T* spe_s = se_s + seg;
  T* cos_n = spe_s + seg;
  T* sin_n = cos_n + (tw + 1);
  T* pw = sin_n + (tw + 1);
  int* st_s = reinterpret_cast<int*>(pw + 6 * npow);
  for (int i = tid; i < tw + 1; i += seg) {
    cos_n[i] = table[i];
    sin_n[i] = table[tw + 1 + i];
  }
  for (int i = tid; i < 6 * npow; i += seg) {
    const int w = i / npow;
    const double bw = (double)beta[(size_t)b * beta_sb + (size_t)w * beta_sw];
    pw[i] = (T)pow(bw, (double)(i - w * npow));
  }
  const T cts = (T)cts_d;
  const T lx = (T)lx_d, ly = (T)ly_d, lz = (T)lz_d;
  const T sx = src[3 * b] / cts, sy = src[3 * b + 1] / cts, sz = src[3 * b + 2] / cts;
  const T rx = recv[0] / cts, ry = recv[1] / cts, rz = recv[2] / cts;
  const T four_pi = (T)(4.0 * kPi);
  const T pi = (T)kPi;
  const T two_over_tw = (T)(2.0 / tw);
  const int half = tw / 2;

  const int p = slot_seg[slot] * seg + tid;
  const int begin = slot_ptr[slot], end = slot_ptr[slot + 1];
  double acc = 0.0;
  __syncthreads();
  for (int base = begin; base < end; base += seg) {
    const int n_tile = min(seg, end - base);
    if (tid < n_tile) {
      const int4 e = entries[base + tid];
      const int qx = e.w & 1, qy = (e.w >> 1) & 1, qz = (e.w >> 2) & 1;
      const T px = (qx ? -sx : sx) - rx + (T)(2 * e.x) * lx;
      const T py = (qy ? -sy : sy) - ry + (T)(2 * e.y) * ly;
      const T pz = (qz ? -sz : sz) - rz + (T)(2 * e.z) * lz;
      const T dist = sqrt(px * px + py * py + pz * pz);
      const T refl = pw[abs(e.x - qx)] * pw[npow + abs(e.x)] * pw[2 * npow + abs(e.y - qy)] *
                     pw[3 * npow + abs(e.y)] * pw[4 * npow + abs(e.z - qz)] * pw[5 * npow + abs(e.z)];
      const T fd = floor(dist);
      int start = kNever;
      if (fd < (T)nsample) {
        const int ifd = (int)fd;
        start = ifd - half + 1;
        const int k0 = start & ~1;
        T se, ce;
        sincos_pi((dist - (T)k0) * two_over_tw, &se, &ce);
        const T spe = sin_pi(dist - fd);
        d_s[tid] = dist;
        g_s[tid] = refl / (four_pi * max(dist, (T)1e-8) * cts);
        ce_s[tid] = ce;
        se_s[tid] = se;
        spe_s[tid] = (ifd & 1) ? -spe : spe;
      }
      st_s[tid] = start;
    }
    __syncthreads();
    if (p < nsample) {
      for (int j = 0; j < n_tile; ++j) {
        const int st = st_s[j];
        if ((unsigned)(p - st) < (unsigned)tw) {
          const int n = p - (st & ~1);
          acc += (double)tap(n, (T)p - d_s[j], g_s[j], ce_s[j], se_s[j], spe_s[j], cos_n, sin_n, pi);
        }
      }
    }
    __syncthreads();
  }
  if (p < nsample) out[(size_t)b * nsample + p] = (T)acc;
}

template <typename T>
int launch(const void* src, const void* recv, const void* beta, int beta_sb, int beta_sw, const void* entries,
           const void* slot_ptr, const void* slot_seg, const void* table, void* out, int batch, int nsample, int tw,
           int seg, int n_slots, int max_pow, double lx, double ly, double lz, double cts, cudaStream_t stream) {
  const size_t smem = sizeof(T) * (5 * (size_t)seg + 2 * (size_t)(tw + 1) + 6 * (size_t)(max_pow + 1)) +
                      sizeof(int) * (size_t)seg;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(rir_taps_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rir_taps_kernel<T><<<dim3((unsigned)batch, (unsigned)n_slots), dim3((unsigned)seg), smem, stream>>>(
      (const T*)src, (const T*)recv, (const T*)beta, beta_sb, beta_sw, (const int4*)entries, (const int*)slot_ptr,
      (const int*)slot_seg, (const T*)table, (T*)out, nsample, tw, max_pow, lx, ly, lz, cts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rir_taps_launch(int is_double, const void* src, const void* recv, const void* beta, int beta_sb,
                               int beta_sw, const void* entries, const void* slot_ptr, const void* slot_seg,
                               const void* table, void* out, int batch, int nsample, int tw, int seg, int n_slots,
                               int max_pow, double lx, double ly, double lz, double cts, void* stream) {
  if (batch <= 0 || nsample <= 0 || tw < 2 || seg <= 0 || seg > 256 || seg % 32 || n_slots <= 0 ||
      n_slots > 65535 || max_pow < 1)
    return (int)cudaErrorInvalidValue;
  if (is_double)
    return launch<double>(src, recv, beta, beta_sb, beta_sw, entries, slot_ptr, slot_seg, table, out, batch, nsample,
                          tw, seg, n_slots, max_pow, lx, ly, lz, cts, (cudaStream_t)stream);
  return launch<float>(src, recv, beta, beta_sb, beta_sw, entries, slot_ptr, slot_seg, table, out, batch, nsample,
                       tw, seg, n_slots, max_pow, lx, ly, lz, cts, (cudaStream_t)stream);
}
