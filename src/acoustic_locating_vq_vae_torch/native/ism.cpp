// Image-source-method RIR synthesis: native C++ core, host side.
//
// The port's own copy of the JAX package's native/ism.cpp, the algorithm
// unchanged (only this header differs): the Habets image-source loop in
// float64 with the 100 Hz high-pass, OpenMP over sources, each source
// computed serially, so the output is bitwise independent of the thread
// count. The port's float64 oracle for dsp/rir.py, which is the batched
// torch op the card runs; this library stays on the host.
//
// Algorithm (matching dsp/rir.py and the Habets core):
//   images (mx,my,mz) in [-n_i, n_i], bits (q,j,k) in {0,1}^3
//   pos_d   = (1-2q_d) s_d - r_d + 2 m_d L_d          [sample units]
//   refl    = prod_d beta_{2d}^|m_d - q_d| * beta_{2d+1}^|m_d|
//   gain    = refl / (4 pi dist cTs); dropped if floor(dist) >= nsample
//   taps    = gain * 0.5(1+cos(2 pi t/Tw)) * sinc(t),  t = p - dist,
//             p in [floor(dist)-Tw/2+1, floor(dist)+Tw/2], Tw = 2*round(.004 fs)
//   + 2nd-order 100 Hz high-pass (y = x + B1 y1 + B2 y2; out = y + A1 y1 + R1 y2)
//
// Built by native/ism.py at first use with g++ -O3 -march=native -shared
// -fPIC -fopenmp (retried once without -march and OpenMP) into build/native/
// at the repository root, the file named by a hash of this source and the
// flags; bound via ctypes.

#include <cmath>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline double sinc(double x) { return x == 0.0 ? 1.0 : std::sin(x) / x; }

void generate_one(const double* src, const double* recv, const double* room,
                  const double* beta, double c, double fs, int nsample,
                  int order, double* out) {
  const double cTs = c / fs;
  const int tw = 2 * (int)std::lround(0.004 * fs);
  const int half = tw / 2;

  double s[3], r[3], L[3];
  for (int d = 0; d < 3; ++d) {
    s[d] = src[d] / cTs;
    r[d] = recv[d] / cTs;
    L[d] = room[d] / cTs;
  }
  int n[3];
  for (int d = 0; d < 3; ++d) n[d] = (int)std::ceil(nsample / (2.0 * L[d]));

  std::memset(out, 0, sizeof(double) * nsample);

  for (int mx = -n[0]; mx <= n[0]; ++mx)
    for (int my = -n[1]; my <= n[1]; ++my)
      for (int mz = -n[2]; mz <= n[2]; ++mz)
        for (int q = 0; q <= 1; ++q)
          for (int j = 0; j <= 1; ++j)
            for (int k = 0; k <= 1; ++k) {
              if (order >= 0 &&
                  std::abs(2 * mx - q) + std::abs(2 * my - j) +
                          std::abs(2 * mz - k) > order)
                continue;
              const double px = (1 - 2 * q) * s[0] - r[0] + 2.0 * mx * L[0];
              const double py = (1 - 2 * j) * s[1] - r[1] + 2.0 * my * L[1];
              const double pz = (1 - 2 * k) * s[2] - r[2] + 2.0 * mz * L[2];
              const double dist = std::sqrt(px * px + py * py + pz * pz);
              const int fdist = (int)std::floor(dist);
              if (fdist >= nsample) continue;
              const double refl =
                  std::pow(beta[0], std::abs(mx - q)) * std::pow(beta[1], std::abs(mx)) *
                  std::pow(beta[2], std::abs(my - j)) * std::pow(beta[3], std::abs(my)) *
                  std::pow(beta[4], std::abs(mz - k)) * std::pow(beta[5], std::abs(mz));
              const double gain = refl / (4.0 * M_PI * (dist > 1e-8 ? dist : 1e-8) * cTs);
              const int start = fdist - half + 1;
              for (int t = 0; t < tw; ++t) {
                const int p = start + t;
                if (p < 0 || p >= nsample) continue;
                const double u = (double)p - dist;
                const double w = 0.5 * (1.0 + std::cos(2.0 * M_PI * u / tw));
                out[p] += gain * w * sinc(M_PI * u);
              }
            }
}

void highpass(double* x, int nsample, double fs) {
  const double W = 2.0 * M_PI * 100.0 / fs;
  const double R1 = std::exp(-W);
  const double B1 = 2.0 * R1 * std::cos(W);
  const double B2 = -R1 * R1;
  const double A1 = -(1.0 + R1);
  double y0 = 0.0, y1 = 0.0, y2 = 0.0;
  for (int i = 0; i < nsample; ++i) {
    y2 = y1;
    y1 = y0;
    y0 = B1 * y1 + B2 * y2 + x[i];
    x[i] = y0 + A1 * y1 + R1 * y2;
  }
}

}  // namespace

extern "C" {

// out: (n_src, nsample) row-major. Returns 0 on success.
int ism_generate(const double* sources, int n_src, const double* receiver,
                 const double* room, const double* beta6, double c, double fs,
                 int nsample, int order, int hp, double* out) {
  if (n_src <= 0 || nsample <= 0) return 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < n_src; ++i) {
    generate_one(sources + 3 * i, receiver, room, beta6, c, fs, nsample,
                 order, out + (size_t)i * nsample);
    if (hp) highpass(out + (size_t)i * nsample, nsample, fs);
  }
  return 0;
}

int ism_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}
}
