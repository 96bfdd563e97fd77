// Column-pivoted Householder QR for rank detection (Businger–Golub).
//
// Native backend for conicip_tpu.preprocess.imcols — the framework's
// analogue of the reference's SuiteSparse/SPQR rank-revealing QR
// (preprocessor.jl:17-21). Runs on the host CPU (one-time preprocessing
// cost, outside the compiled solver loop).
//
// C ABI (ctypes-friendly):
//   cip_pivoted_qr(A, m, n, rdiag, piv)
//     A      in/out: row-major m x n; overwritten with the Householder
//            factorization (R in the upper triangle of the pivoted matrix)
//     rdiag  out: |R_kk| for k < min(m, n)
//     piv    out: column permutation (0-based), length n
//   returns 0 on success.
//
// Build: make -C native   (produces libconicip_native.so)

#include <cmath>
#include <cstdlib>
#include <vector>

extern "C" {

int cip_pivoted_qr(double* A, long m, long n, double* rdiag, long* piv) {
  if (m < 0 || n < 0) return 1;
  const long kmax = m < n ? m : n;

  // column squared norms for pivot selection
  std::vector<double> colnorm(static_cast<size_t>(n), 0.0);
  for (long j = 0; j < n; ++j) {
    double s = 0.0;
    for (long i = 0; i < m; ++i) {
      const double v = A[i * n + j];
      s += v * v;
    }
    colnorm[static_cast<size_t>(j)] = s;
    piv[j] = j;
  }

  std::vector<double> v(static_cast<size_t>(m), 0.0);

  for (long k = 0; k < kmax; ++k) {
    // pivot: column with the largest remaining norm
    long p = k;
    double best = colnorm[static_cast<size_t>(k)];
    for (long j = k + 1; j < n; ++j) {
      if (colnorm[static_cast<size_t>(j)] > best) {
        best = colnorm[static_cast<size_t>(j)];
        p = j;
      }
    }
    if (p != k) {
      for (long i = 0; i < m; ++i) {
        const double t = A[i * n + k];
        A[i * n + k] = A[i * n + p];
        A[i * n + p] = t;
      }
      const double tn = colnorm[static_cast<size_t>(k)];
      colnorm[static_cast<size_t>(k)] = colnorm[static_cast<size_t>(p)];
      colnorm[static_cast<size_t>(p)] = tn;
      const long tp = piv[k];
      piv[k] = piv[p];
      piv[p] = tp;
    }

    // Householder vector for column k (rows k..m-1)
    double alpha = 0.0;
    for (long i = k; i < m; ++i) {
      const double x = A[i * n + k];
      alpha += x * x;
    }
    alpha = std::sqrt(alpha);
    const double akk = A[k * n + k];
    if (akk > 0) alpha = -alpha;
    rdiag[k] = std::fabs(alpha);

    if (alpha == 0.0) {
      // zero column; nothing to eliminate
      colnorm[static_cast<size_t>(k)] = 0.0;
      continue;
    }

    // v = x - alpha e1, normalized so v[k] = 1
    const double vk = akk - alpha;
    v[static_cast<size_t>(k)] = 1.0;
    for (long i = k + 1; i < m; ++i)
      v[static_cast<size_t>(i)] = A[i * n + k] / vk;
    const double beta = -vk / alpha;  // 2 / (vᵀv) for this scaling

    // apply H = I - beta v vᵀ to columns k..n-1
    for (long j = k; j < n; ++j) {
      double s = A[k * n + j];
      for (long i = k + 1; i < m; ++i)
        s += v[static_cast<size_t>(i)] * A[i * n + j];
      s *= beta;
      A[k * n + j] -= s;
      for (long i = k + 1; i < m; ++i)
        A[i * n + j] -= s * v[static_cast<size_t>(i)];
    }
    A[k * n + k] = alpha;

    // downdate remaining column norms
    for (long j = k + 1; j < n; ++j) {
      const double r = A[k * n + j];
      colnorm[static_cast<size_t>(j)] -= r * r;
      if (colnorm[static_cast<size_t>(j)] < 0) colnorm[static_cast<size_t>(j)] = 0;
    }
  }
  return 0;
}

// Least-squares via the precomputed factorization is not exposed; imcols
// only needs |R_kk| + the permutation for rank detection, and solves the
// reduced system with LAPACK through numpy.

}  // extern "C"
