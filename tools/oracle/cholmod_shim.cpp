/* Dense-Cholesky implementation of the CHOLMOD API subset used by the
 * reference LinearSFM (see shim/suitesparse/cholmod.h). Correct for the
 * symmetric positive-definite reduced camera systems the reference feeds it;
 * ignores orderings (they affect speed, not values).
 */
#include "suitesparse/cholmod.h"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>

/* Debug aid: CHOLMOD_SHIM_DUMP=<prefix> dumps each solve's dense system to
 * <prefix>_<k>_{A,b,x}.txt so the oracle's exact linear systems can be
 * compared against the JAX implementation's. */
static int g_solve_count = 0;

/* The reference's flag parser allocates strlen bytes for each argument and
 * strcpy's into it WITHOUT room for the NUL terminator
 * (lmj_parseArgs, LinearSFMImp.cpp:8018-8045) — an off-by-one heap overflow
 * whose crashiness depends on the path length and heap layout (ASan-confirmed).
 * Pad every allocation by a few bytes so the oracle is usable with arbitrary
 * paths; glibc free() still accepts the same pointer. */
extern "C" void *__libc_malloc(size_t);
extern "C" void *malloc(size_t n) { return __libc_malloc(n + 8); }

extern "C" {

int cholmod_start(cholmod_common *c) {
  std::memset(c, 0, sizeof(*c));
  return 1;
}
int cholmod_finish(cholmod_common *) { return 1; }

cholmod_sparse *cholmod_allocate_sparse(size_t nrow, size_t ncol, size_t nzmax,
                                        int sorted, int packed, int stype,
                                        int xtype, cholmod_common *) {
  cholmod_sparse *A = (cholmod_sparse *)std::calloc(1, sizeof(cholmod_sparse));
  A->nrow = nrow;
  A->ncol = ncol;
  A->nzmax = nzmax;
  A->p = std::calloc(ncol + 1, sizeof(int));
  A->i = std::calloc(nzmax ? nzmax : 1, sizeof(int));
  A->x = std::calloc(nzmax ? nzmax : 1, sizeof(double));
  A->stype = stype;
  A->sorted = sorted;
  A->packed = packed;
  A->xtype = xtype;
  return A;
}

cholmod_dense *cholmod_zeros(size_t nrow, size_t ncol, int xtype,
                             cholmod_common *) {
  cholmod_dense *X = (cholmod_dense *)std::calloc(1, sizeof(cholmod_dense));
  X->nrow = nrow;
  X->ncol = ncol;
  X->d = nrow;
  X->x = std::calloc(nrow * ncol ? nrow * ncol : 1, sizeof(double));
  X->xtype = xtype;
  return X;
}

int cholmod_amd(cholmod_sparse *A, int *, size_t, int *perm, cholmod_common *) {
  for (size_t k = 0; k < A->ncol; ++k) perm[k] = (int)k;
  return 1;
}

cholmod_factor *cholmod_analyze(cholmod_sparse *A, cholmod_common *) {
  cholmod_factor *F = (cholmod_factor *)std::calloc(1, sizeof(cholmod_factor));
  F->n = A->ncol;
  return F;
}

cholmod_factor *cholmod_analyze_p(cholmod_sparse *A, int *, int *, size_t,
                                  cholmod_common *c) {
  return cholmod_analyze(A, c);
}

/* Skyline (profile) Cholesky: row i stores columns first[i]..i, where
 * first[i] is the leftmost structural nonzero of row i in the symmetric
 * profile closure. Fill-in stays within the profile, so factorization cost is
 * sum(bandwidth^2) — near-linear for the mostly-banded reduced camera systems
 * LinearSFM produces, comparable to supernodal CHOLMOD on these patterns. */
int cholmod_factorize(cholmod_sparse *A, cholmod_factor *F, cholmod_common *) {
  const long n = (long)A->ncol;
  const int *Ap = (const int *)A->p;
  const int *Ai = (const int *)A->i;
  const double *Ax = (const double *)A->x;

  std::free(F->val); std::free(F->first); std::free(F->rp);
  long *first = (long *)std::malloc(n * sizeof(long));
  for (long i = 0; i < n; ++i) first[i] = i;
  /* upper storage by columns: entry (row, col) with row <= col ->
     affects profile of row `col`: first[col] = min(first[col], row) */
  for (long col = 0; col < n; ++col)
    for (int k = Ap[col]; k < Ap[col + 1]; ++k) {
      long row = Ai[k];
      if (row < first[col]) first[col] = row;
    }
  long *rp = (long *)std::malloc((n + 1) * sizeof(long));
  rp[0] = 0;
  for (long i = 0; i < n; ++i) rp[i + 1] = rp[i] + (i - first[i] + 1);
  double *val = (double *)std::calloc(rp[n] ? rp[n] : 1, sizeof(double));

  /* scatter A (upper columns) into skyline rows */
  for (long col = 0; col < n; ++col)
    for (int k = Ap[col]; k < Ap[col + 1]; ++k) {
      long row = Ai[k]; /* row <= col; skyline row = col, offset col-.. */
      val[rp[col] + (row - first[col])] = Ax[k];
    }

  /* in-place skyline Cholesky (row-oriented) */
  for (long i = 0; i < n; ++i) {
    double *ri = val + rp[i];
    long fi = first[i];
    for (long j = fi; j < i; ++j) {
      double *rj = val + rp[j];
      long fj = first[j];
      long lo = fi > fj ? fi : fj;
      double s2 = 0.0;
      for (long k = lo; k < j; ++k)
        s2 += ri[k - fi] * rj[k - fj];
      ri[j - fi] = (ri[j - fi] - s2) / rj[j - fj];
    }
    double diag = ri[i - fi];
    for (long k = fi; k < i; ++k) diag -= ri[k - fi] * ri[k - fi];
    if (diag <= 0.0) diag = 1e-300;
    ri[i - fi] = std::sqrt(diag);
  }
  F->val = val; F->first = first; F->rp = rp;

  const char *dump = std::getenv("CHOLMOD_SHIM_DUMP");
  if (dump) {
    char name[512];
    std::snprintf(name, sizeof name, "%s_%d_A.txt", dump, g_solve_count);
    FILE *fh = std::fopen(name, "w");
    /* reconstruct dense A for dumping */
    double *M = (double *)std::calloc(n * n, sizeof(double));
    for (long col = 0; col < n; ++col)
      for (int k = Ap[col]; k < Ap[col + 1]; ++k) {
        long row = Ai[k];
        M[row * n + col] = Ax[k];
        M[col * n + row] = Ax[k];
      }
    for (long r = 0; r < n; ++r) {
      for (long c2 = 0; c2 < n; ++c2) std::fprintf(fh, "%.17g ", M[r * n + c2]);
      std::fprintf(fh, "\n");
    }
    std::free(M);
    std::fclose(fh);
  }
  return 1;
}

cholmod_dense *cholmod_solve(int, cholmod_factor *F, cholmod_dense *B,
                             cholmod_common *c) {
  const long n = (long)F->n;
  cholmod_dense *X = cholmod_zeros(n, 1, CHOLMOD_REAL, c);
  double *x = (double *)X->x;
  const double *b = (const double *)B->x;
  const double *val = F->val;
  const long *first = F->first, *rp = F->rp;
  /* L y = b (skyline rows) */
  for (long i = 0; i < n; ++i) {
    const double *ri = val + rp[i];
    long fi = first[i];
    double s2 = b[i];
    for (long k = fi; k < i; ++k) s2 -= ri[k - fi] * x[k];
    x[i] = s2 / ri[i - fi];
  }
  /* L^T x = y: column-oriented backward sweep */
  for (long i = n - 1; i >= 0; --i) {
    const double *ri = val + rp[i];
    long fi = first[i];
    x[i] /= ri[i - fi];
    for (long k = fi; k < i; ++k) x[k] -= ri[k - fi] * x[i];
  }
  const char *dump = std::getenv("CHOLMOD_SHIM_DUMP");
  if (dump) {
    char name[512];
    std::snprintf(name, sizeof name, "%s_%d_b.txt", dump, g_solve_count);
    FILE *fh = std::fopen(name, "w");
    for (long k = 0; k < n; ++k) std::fprintf(fh, "%.17g\n", b[k]);
    std::fclose(fh);
    std::snprintf(name, sizeof name, "%s_%d_x.txt", dump, g_solve_count);
    fh = std::fopen(name, "w");
    for (long k = 0; k < n; ++k) std::fprintf(fh, "%.17g\n", x[k]);
    std::fclose(fh);
    ++g_solve_count;
  }
  return X;
}

int cholmod_free_factor(cholmod_factor **L, cholmod_common *) {
  if (L && *L) {
    std::free((*L)->val);
    std::free((*L)->first);
    std::free((*L)->rp);
    std::free(*L);
    *L = nullptr;
  }
  return 1;
}
int cholmod_free_sparse(cholmod_sparse **A, cholmod_common *) {
  if (A && *A) {
    std::free((*A)->p);
    std::free((*A)->i);
    std::free((*A)->x);
    std::free(*A);
    *A = nullptr;
  }
  return 1;
}
int cholmod_free_dense(cholmod_dense **X, cholmod_common *) {
  if (X && *X) {
    std::free((*X)->x);
    std::free(*X);
    *X = nullptr;
  }
  return 1;
}

}  /* extern "C" */
