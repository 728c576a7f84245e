// Host-side native oracle for the JAX engine.
//
// Two capabilities, mirroring the roles native code plays in the
// reference implementation (which is entirely C -- lib/stable.c,
// test/demo.c):
//
//   1. stb_fill_ref: long-double reference fill of the Stirling tables
//      (log S, V-ratio, S1) by the exact recurrences
//      (stable.c:347-348, 380-387, 475-482 semantics).  This is the
//      verification oracle the JAX fills are tested against at
//      precisions beyond f64.
//
//   2. stb_crp_generate: Chinese-restaurant-process data simulation
//      (demo.c:284-311 semantics) -- a sequential, branchy host loop
//      that belongs in native code, not Python or XLA.
//
// Exposed through a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: see build.py (g++ -O2 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Fill logS[n-1][m-1] = log S^n_{m,a} (row-major N x M), V[n-1][m-1] =
// S^n_m / S^n_{m-1} (0 where undefined, +inf sentinel at m=1), and
// S1[n-1] = log S^n_{1,a}.  Any output pointer may be null to skip it.
// Internal arithmetic in long double (80-bit on x86-64).
void stb_fill_ref(double a_in, int64_t N, int64_t M,
                  double* logS, double* V, double* S1) {
  const long double a = a_in;
  long double* s1 = new long double[N];
  s1[0] = 0.0L;  // log S^1_1 = 0
  for (int64_t n = 2; n <= N; ++n)
    s1[n - 1] = s1[n - 2] + logl((long double)(n - 1) - a);

  // v[m-1] holds V(n, m) for the current n; col 0 = +inf sentinel.
  long double* v = new long double[M];
  long double* vn = new long double[M];
  const long double inf = INFINITY;
  for (int64_t m = 0; m < M; ++m) v[m] = (m == 0) ? inf : 0.0L;

  auto emit = [&](int64_t n, long double* row) {
    if (V)
      for (int64_t m = 0; m < M; ++m)
        V[(n - 1) * M + m] = (double)((m == 0) ? inf : row[m]);
    if (logS) {
      long double acc = s1[n - 1];
      logS[(n - 1) * M + 0] = (double)acc;
      for (int64_t m = 1; m < M; ++m) {
        if (m + 1 > n || row[m] <= 0.0L) {
          logS[(n - 1) * M + m] = -INFINITY;
          acc = -INFINITY;
        } else {
          acc += logl(row[m]);
          logS[(n - 1) * M + m] = (double)acc;
        }
      }
    }
  };

  emit(1, v);
  for (int64_t n = 2; n <= N; ++n) {
    const long double nm1 = (long double)(n - 1);
    for (int64_t m = 0; m < M; ++m) {
      const long double mf = (long double)(m + 1);
      const long double prev_left = (m == 0) ? inf : v[m - 1];
      const long double recip = (m == 0) ? 0.0L
          : (prev_left == inf ? 0.0L
             : (prev_left == 0.0L ? inf : 1.0L / prev_left));
      const long double numer = 1.0L + (nm1 - mf * a) * v[m];
      const long double denom = recip + (nm1 - (mf - 1.0L) * a);
      vn[m] = (m == 0) ? inf : numer / denom;
      if (m + 1 > n) vn[m] = 0.0L;
    }
    long double* t = v; v = vn; vn = t;
    emit(n, v);
  }
  if (S1)
    for (int64_t n = 0; n < N; ++n) S1[n] = (double)s1[n];
  delete[] s1;
  delete[] v;
  delete[] vn;
}

// xorshift128+ -- small, seedable, good enough for data simulation.
static inline uint64_t xs128p(uint64_t* s) {
  uint64_t x = s[0];
  const uint64_t y = s[1];
  s[0] = y;
  x ^= x << 23;
  s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
  return s[1] + y;
}
static inline double u01(uint64_t* s) {
  return (double)(xs128p(s) >> 11) * (1.0 / 9007199254740992.0);
}

// CRP simulation (demo.c:284-311 semantics): J groups, `dim` categories
// with base weights H (may be null = uniform), n_per samples per group.
// Outputs: counts n[J][dim], table counts t[J][dim], totals T[J], and
// per-item streams cats/grps/firsts (each J*n_per long).
void stb_crp_generate(uint64_t seed, int64_t J, int64_t dim, int64_t n_per,
                      double a, double b, const double* H,
                      int32_t* n_out, int32_t* t_out, int32_t* T_out,
                      int32_t* cats, int32_t* grps, uint8_t* firsts) {
  uint64_t s[2] = {seed * 2862933555777941757ULL + 3037000493ULL,
                   seed ^ 0x9E3779B97F4A7C15ULL};
  if (!s[0]) s[0] = 1;
  if (!s[1]) s[1] = 2;
  for (int64_t j = 0; j < J; ++j) {
    int32_t* n = n_out + j * dim;
    int32_t* t = t_out + j * dim;
    std::memset(n, 0, sizeof(int32_t) * dim);
    std::memset(t, 0, sizeof(int32_t) * dim);
    int32_t T = 0;
    bool* seen = new bool[dim]();
    for (int64_t c = 0; c < n_per; ++c) {
      int64_t i = 0;
      double val = (c == 0) ? -1.0 : ((double)c + b) * u01(s) - (T * a + b);
      if (val <= 0.0) {
        // new table: draw category from H
        double u = u01(s), acc = 0.0;
        for (i = 0; i < dim; ++i) {
          acc += H ? H[i] : 1.0 / (double)dim;
          if (u < acc) break;
        }
        if (i >= dim) i = dim - 1;
        t[i] += 1;
        T += 1;
      } else {
        for (i = 0; i < dim; ++i) {
          val -= (double)n[i] - (double)t[i] * a;
          if (val < 0.0) break;
        }
        if (i >= dim) i = dim - 1;
      }
      n[i] += 1;
      int64_t pos = j * n_per + c;
      cats[pos] = (int32_t)i;
      grps[pos] = (int32_t)j;
      firsts[pos] = seen[i] ? 0 : 1;
      seen[i] = true;
    }
    T_out[j] = T;
    delete[] seen;
  }
}

}  // extern "C"
