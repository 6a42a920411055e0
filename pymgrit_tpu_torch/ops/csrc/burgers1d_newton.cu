// K16 burgers1d_newton: backward-Euler steps of the periodic 1D viscous
// Burgers equation  u_t + u u_x = nu u_xx, each solved by Newton's method
// with an LU solve per iteration, one lane per block, J lanes of L chained
// steps per launch:
//   out[j, k] = [g[j, k] +] Phi_{dt[k, j]}(out[j, k-1]),  out[j, -1] = seed[j].
// Phi(u0) is the Newton limit of
//   g(u) = (u - u0) + dt (u (D1 u) - nu (D2 u)),
//   J(u) = I + dt (diag(D1 u) + u D1 - nu D2),  u <- u - J(u)^-1 g(u),
// from u = u0, while max|g(u)| >= tol and fewer than maxiter iterations
// (a NaN in g stops the lane: the max keeps NaN, and NaN >= tol is false,
// as jnp.linalg.norm(g, inf) >= tol).  D1, D2 are the periodic central
// first and second differences (c1 = 1/(2 dx), c2 = 1/dx^2, d2 = -2/dx^2).
// The iterations of every lane and step go to iters[k, j].
//
// Replaces: pymgrit_tpu/models/burgers.py Burgers1D.step (a vmap-ed
// lax.while_loop whose body assembles the dense Jacobian and calls
// jnp.linalg.solve, LAPACK's LU with partial pivoting).
//
// The LU.  J is periodic tridiagonal.  LAPACK's elimination on a structural
// zero is exact (x - l * 0 and x - 0 * y change nothing), so an LU that
// visits only the entries that can be nonzero picks LAPACK's pivots (the
// first entry of largest magnitude in the column) and rounds as the dense
// LU does.  With partial pivoting the entries that can be nonzero stay few:
// at stage k the active rows are the original rows k+2..n-2 (untouched),
// the row at position k, the row at position k+1 (original until stage k)
// and the row at position n-1, and the two modified rows hold columns
// {k, k+1} and {n-2, n-1} only; so every row of U holds columns
// {k, k+1, k+2} and {n-2, n-1}.  A row is five slots: three band slots for
// columns k..k+2 below n-2 and two tail slots for columns n-2 and n-1.  The
// multipliers are scaled by the pivot's reciprocal as dgetf2 does, the
// right-hand side is eliminated with the rows, and the back substitution
// subtracts each row's terms in the order of the dense LU's column sweep
// (columns n-1, n-2, k+2, k+1).
//
// Bound: bytes (the function needs O(n) operations a Newton iteration).
// Design: the whole Newton loop of a step stays in the block, so the
// per-lane stop test needs no host read and a chain of steps is one launch;
// one warp per lane forms the residual and the update in parallel, and its
// first thread runs the elimination, O(n) dependent stages.  The iterate,
// the step's start, the residual and U live in a per-lane workspace of 8 n
// values in device memory (L1/L2-resident at the sizes the models use), so
// any n runs.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

template <typename T>
__device__ __forceinline__ T sfmin();
template <>
__device__ __forceinline__ double sfmin<double>() { return DBL_MIN; }
template <>
__device__ __forceinline__ float sfmin<float>() { return FLT_MIN; }

template <typename T>
struct Lane {
  T* u;       // current iterate
  T* u0;      // the step's start
  T* r;       // residual, then the solution of J x = r
  T* U;       // U rows: five slots each, slot-major (U[s * n + k])
};

// Slot of column c in a row at stage k: columns k..k+2 below n-2 in the
// band slots 0..2, columns n-2 and n-1 in the tail slots 3 and 4.
__device__ __forceinline__ int slot(int c, int k, int n) {
  return c >= n - 2 ? 3 + (c - (n - 2)) : c - k;
}

// r = g(u) and the lane's max |g| (NaN if any entry is NaN).
template <typename T>
__device__ T residual(const Lane<T>& s, int n, T dt, T nu, T c1, T c2, T d2) {
  T m = T(0);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int im = i == 0 ? n - 1 : i - 1;
    const int ip = i == n - 1 ? 0 : i + 1;
    const T ui = s.u[i];
    const T d1u = c1 * s.u[ip] - c1 * s.u[im];
    const T d2u = (c2 * s.u[im] + d2 * ui) + c2 * s.u[ip];
    const T gi = (ui - s.u0[i]) + dt * (ui * d1u - nu * d2u);
    s.r[i] = gi;
    m = nan_max(m, fabs(gi));
  }
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __syncwarp();
  return m;
}

// Row i of J(u) = I + dt (diag(D1 u) + u D1 - nu D2) in the slot form of
// stage k, entry by entry as the JAX package sums it.
template <typename T>
__device__ __forceinline__ void jacobian_row(const T* u, int i, int k, int n, T dt, T nu, T c1,
                                             T c2, T d2, T (&v)[5]) {
  const int im = i == 0 ? n - 1 : i - 1;
  const int ip = i == n - 1 ? 0 : i + 1;
#pragma unroll
  for (int q = 0; q < 5; ++q) v[q] = T(0);
  const T d1u = c1 * u[ip] - c1 * u[im];
  v[slot(i, k, n)] = T(1) + dt * (d1u - nu * d2);
  v[slot(ip, k, n)] = dt * (u[i] * c1 - nu * c2);
  v[slot(im, k, n)] = dt * (u[i] * -c1 - nu * c2);
}

// R <- R - l P on the columns right of the pivot column (slot sk), and the
// right-hand side alike, with l = R[sk] / pivot as dgetf2 forms it.
template <typename T>
__device__ __forceinline__ void eliminate(T (&R)[5], T& rR, const T (&P)[5], T rP, int sk,
                                          T pivot, T rp, bool recip) {
  const T a = R[sk];
  const T l = recip ? a * rp : a / pivot;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    if (q != sk) R[q] -= l * P[q];
  }
  rR -= l * rP;
}

// From the slot form of stage k to that of stage k+1: the band moves one
// column right (column k drops out, column k+3 enters empty).
template <typename T>
__device__ __forceinline__ void shift(T (&v)[5]) {
  v[0] = v[1];
  v[1] = v[2];
  v[2] = T(0);
}

template <typename T>
__device__ __forceinline__ void copy5(T (&d)[5], const T (&s)[5]) {
#pragma unroll
  for (int q = 0; q < 5; ++q) d[q] = s[q];
}

// Solve J(u) x = r in place (x in r) by LU with partial pivoting; one thread.
template <typename T>
__device__ void lu_solve(const Lane<T>& s, int n, T dt, T nu, T c1, T c2, T d2) {
  T X[5], Y[5], O[5], P[5];
  T rX, rY, rO = T(0), rP;
  jacobian_row(s.u, 0, 0, n, dt, nu, c1, c2, d2, X);
  jacobian_row(s.u, n - 1, 0, n, dt, nu, c1, c2, d2, Y);
  rX = s.r[0];
  rY = s.r[n - 1];
  for (int k = 0; k < n - 1; ++k) {
    // rows at positions k (X), k+1 (O, original; Y itself when k+1 = n-1)
    // and n-1 (Y); the pivot is the first of largest magnitude in column k
    const bool three = k + 1 < n - 1;
    if (three) {
      jacobian_row(s.u, k + 1, k, n, dt, nu, c1, c2, d2, O);
      rO = s.r[k + 1];
    }
    const int sk = slot(k, k, n);
    int piv = 0;
    T best = fabs(X[sk]);
    if (three && fabs(O[sk]) > best) {
      piv = 1;
      best = fabs(O[sk]);
    }
    if (fabs(Y[sk]) > best) piv = 2;
    if (piv == 0) {
      copy5(P, X);
      rP = rX;
    } else if (piv == 1) {
      copy5(P, O);
      rP = rO;
      copy5(O, X);        // the row at position k moves to k+1
      rO = rX;
    } else {
      copy5(P, Y);
      rP = rY;
      copy5(Y, X);        // the row at position k moves to n-1
      rY = rX;
    }
    const T pivot = P[sk];
    const bool recip = fabs(pivot) >= sfmin<T>();
    const T rp = T(1) / pivot;
    if (three) eliminate(O, rO, P, rP, sk, pivot, rp, recip);
    eliminate(Y, rY, P, rP, sk, pivot, rp, recip);
#pragma unroll
    for (int q = 0; q < 5; ++q) s.U[q * n + k] = P[q];
    s.r[k] = rP;
    if (three) {
      copy5(X, O);
      rX = rO;
    } else {
      copy5(X, Y);
      rX = rY;
    }
    shift(X);
    shift(Y);
  }
#pragma unroll
  for (int q = 0; q < 5; ++q) s.U[q * n + n - 1] = X[q];
  s.r[n - 1] = rX;
  // back substitution, row i's terms in the dense column sweep's order
  for (int i = n - 1; i >= 0; --i) {
    T acc = s.r[i];
    if (n - 1 > i) acc -= s.r[n - 1] * s.U[4 * n + i];
    if (n - 2 > i) acc -= s.r[n - 2] * s.U[3 * n + i];
    if (i + 2 < n - 2) acc -= s.r[i + 2] * s.U[2 * n + i];
    if (i + 1 < n - 2) acc -= s.r[i + 1] * s.U[1 * n + i];
    s.r[i] = acc / s.U[slot(i, i, n) * n + i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    burgers1d_newton_kernel(const T* __restrict__ seed, int64_t s_sj, const T* __restrict__ dt,
                            T* __restrict__ out, int64_t o_sj, int64_t o_sk,
                            const T* __restrict__ g, int64_t g_sj, int64_t g_sk,
                            int* __restrict__ iters, T* __restrict__ ws, T nu, T c1, T c2, T d2,
                            T tol, int maxiter, int64_t J, int64_t L, int n) {
  const int64_t j = blockIdx.x;
  Lane<T> s;
  s.u = ws + j * 8 * (int64_t)n;
  s.u0 = s.u + n;
  s.r = s.u0 + n;
  s.U = s.r + n;
  for (int i = threadIdx.x; i < n; i += kThreads) s.u[i] = seed[j * s_sj + i];
  __syncwarp();
  for (int64_t k = 0; k < L; ++k) {
    const T h = dt[k * J + j];
    for (int i = threadIdx.x; i < n; i += kThreads) s.u0[i] = s.u[i];
    __syncwarp();
    int it = 0;
    T gmax = residual(s, n, h, nu, c1, c2, d2);
    while (gmax >= tol && it < maxiter) {
      if (threadIdx.x == 0) lu_solve(s, n, h, nu, c1, c2, d2);
      __syncwarp();
      for (int i = threadIdx.x; i < n; i += kThreads) s.u[i] = s.u[i] - s.r[i];
      __syncwarp();
      ++it;
      gmax = residual(s, n, h, nu, c1, c2, d2);
    }
    if (iters != nullptr && threadIdx.x == 0) iters[k * J + j] = it;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      T v = s.u[i];
      if (g != nullptr) v = g[j * g_sj + k * g_sk + i] + v;
      s.u[i] = v;
      out[j * o_sj + k * o_sk + i] = v;
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const T* seed, int64_t s_sj, const T* dt, T* out, int64_t o_sj, int64_t o_sk,
           const T* g, int64_t g_sj, int64_t g_sk, int* iters, T* ws, double nu, double c1,
           double c2, double d2, double tol, int64_t maxiter, int64_t J, int64_t L, int64_t n,
           void* stream) {
  if (J == 0 || L == 0) return 0;
  if (J < 0 || J > 0x7fffffff || L < 0 || n < 3 || n > 0x7fffffff || maxiter < 0 ||
      maxiter > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  burgers1d_newton_kernel<T><<<(unsigned)J, kThreads, 0, (cudaStream_t)stream>>>(
      seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, iters, ws, (T)nu, (T)c1, (T)c2, (T)d2,
      (T)tol, (int)maxiter, J, L, (int)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_burgers1d_newton_f64(const double* seed, int64_t s_sj, const double* dt, double* out,
                            int64_t o_sj, int64_t o_sk, const double* g, int64_t g_sj,
                            int64_t g_sk, int* iters, double* ws, double nu, double c1, double c2,
                            double d2, double tol, int64_t maxiter, int64_t J, int64_t L,
                            int64_t n, void* stream) {
  return launch<double>(seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, iters, ws, nu, c1, c2, d2,
                        tol, maxiter, J, L, n, stream);
}

int pm_burgers1d_newton_f32(const float* seed, int64_t s_sj, const float* dt, float* out,
                            int64_t o_sj, int64_t o_sk, const float* g, int64_t g_sj,
                            int64_t g_sk, int* iters, float* ws, double nu, double c1, double c2,
                            double d2, double tol, int64_t maxiter, int64_t J, int64_t L,
                            int64_t n, void* stream) {
  return launch<float>(seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, iters, ws, nu, c1, c2, d2,
                       tol, maxiter, J, L, n, stream);
}

}  // extern "C"
