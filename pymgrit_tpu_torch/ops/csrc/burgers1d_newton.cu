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
// Bound: bytes (the function needs O(n) operations a Newton iteration);
// what holds it is latency: each LU solve is a chain of 2 n - 1 dependent
// stages (n - 1 eliminations, n back-substitution rows) on one thread.
// Design:
// * the whole Newton loop of a step stays in the block, so the per-lane
//   stop test needs no host read and a chain of steps is one launch; one
//   warp a lane forms the residual and the update in parallel;
// * the lane lives on chip: its iterate, the step's start, the residual
//   and U's five slots (8 n values) in dynamic shared memory where they fit
//   the card's opt-in (n up to 3632 in float64); past that the same code
//   runs on a per-lane workspace in device memory, which the wrapper
//   allocates (ops/dense_newton.py plan);
// * before each elimination the warp forms rows 1..n-2 of the Jacobian in
//   parallel (three entries a row, jacobian_row's expressions) into U's
//   band slots, which stage k overwrites only after row k has been read;
//   rows 0 and n-1 are formed by the eliminating thread, as before;
// * the eliminating thread reads row k+2 and r[k+2] into registers during
//   stage k, and the back substitution its row i-1's slots during row i,
//   so a stage's dependent path is the pivot's reciprocal and the row
//   updates (an elimination) or one FMA and the division (a row of the
//   back substitution), with no memory access on it;
// * one thread issues every instruction of the chain in order, so a stage
//   also pays for its branches and register moves: without a row exchange
//   (every stage at the models' steps) the row at position k is the pivot
//   row as it is, the multipliers take the reciprocal with one branch for
//   dgetf2's sfmin rule, the loops run without per-stage conditions (the
//   read-ahead stops one stage early; back-substitution rows n-5..1 have
//   all four terms), and the elimination loop is unrolled by two.  The
//   arithmetic is that of the earlier design (one thread's chain in a
//   device-memory workspace), operation for operation: the outputs were
//   held bit for bit against its build.

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
// stage k, entry by entry as the JAX package sums it (the three columns
// take distinct slots; each slot is picked by a compare, so the row stays
// in registers).
template <typename T>
__device__ __forceinline__ void jacobian_row(const T* u, int i, int k, int n, T dt, T nu, T c1,
                                             T c2, T d2, T (&v)[5]) {
  const int im = i == 0 ? n - 1 : i - 1;
  const int ip = i == n - 1 ? 0 : i + 1;
  const T d1u = c1 * u[ip] - c1 * u[im];
  const T diag = T(1) + dt * (d1u - nu * d2);
  const T sup = dt * (u[i] * c1 - nu * c2);
  const T sub = dt * (u[i] * -c1 - nu * c2);
  const int si = slot(i, k, n), sp = slot(ip, k, n), sm = slot(im, k, n);
#pragma unroll
  for (int q = 0; q < 5; ++q) v[q] = si == q ? diag : sp == q ? sup : sm == q ? sub : T(0);
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

// Row i (1 <= i <= n-2) of J(u) into U's band slots (U[i] column i-1,
// U[n + i] column i, U[2 n + i] column i+1), by jacobian_row's expressions;
// the warp forms rows 1..n-2 in parallel.
template <typename T>
__device__ __forceinline__ void form_rows(const Lane<T>& s, int n, T dt, T nu, T c1, T c2,
                                          T d2) {
  for (int i = 1 + threadIdx.x; i < n - 1; i += kThreads) {
    const T d1u = c1 * s.u[i + 1] - c1 * s.u[i - 1];
    s.U[n + i] = T(1) + dt * (d1u - nu * d2);
    s.U[2 * n + i] = dt * (s.u[i] * c1 - nu * c2);
    s.U[i] = dt * (s.u[i] * -c1 - nu * c2);
  }
}

// Row i (1 <= i <= n-2) of J in the slot form of stage i-1, from the
// formed rows (columns i-1, i, i+1 in slots 0, 1, 2; column n-2 and n-1 in
// the tail slots 3 and 4), and its right-hand side entry.
template <typename T>
__device__ __forceinline__ void band_row(const Lane<T>& s, int i, int n, T (&v)[5], T& rv) {
  const T sub = s.U[i], diag = s.U[n + i], sup = s.U[2 * n + i];
  const bool last = i == n - 2, before = i == n - 3;
  v[0] = sub;
  v[1] = last ? T(0) : diag;
  v[2] = last || before ? T(0) : sup;
  v[3] = last ? diag : before ? sup : T(0);
  v[4] = last ? sup : T(0);
  rv = s.r[i];
}

// R <- R - l P on the columns right of the pivot column, and the
// right-hand side alike, for a given multiplier l
template <int SK, typename T>
__device__ __forceinline__ void update(T (&R)[5], T& rR, const T (&P)[5], T rP, T l) {
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    if (q != SK) R[q] -= l * P[q];
  }
  rR -= l * rP;
}

// The elimination of stage k with the pivot row P (rP; rp = 1 / P[SK]):
// the rows O (THREE) and Y lose column k with the multipliers l = R[SK] rp,
// or R[SK] / pivot below sfmin (dgetf2's rule; a branch taken only then),
// U's row k and r[k] are stored, and X, Y take the slot form of stage k+1.
// P may be X itself.
template <int SK, bool THREE, typename T>
__device__ __forceinline__ void pivot_step(const Lane<T>& s, int k, int n, const T (&P)[5],
                                           T rP, T rp, T (&X)[5], T& rX, T (&O)[5], T& rO,
                                           T (&Y)[5], T& rY) {
  const T pivot = P[SK];
  T lO = THREE ? O[SK] * rp : T(0), lY = Y[SK] * rp;
  if (!(fabs(pivot) >= sfmin<T>())) {
    if (THREE) lO = O[SK] / pivot;
    lY = Y[SK] / pivot;
  }
  if (THREE) update<SK>(O, rO, P, rP, lO);
  update<SK>(Y, rY, P, rP, lY);
#pragma unroll
  for (int q = 0; q < 5; ++q) s.U[q * n + k] = P[q];
  s.r[k] = rP;
  if (THREE) {
    copy5(X, O);
    rX = rO;
  } else {
    copy5(X, Y);
    rX = rY;
  }
  shift(X);
  shift(Y);
}

// Stage k of the elimination: rows at positions k (X), k+1 (O, original;
// Y itself when THREE is false, k+1 = n-1) and n-1 (Y); the pivot is the
// first of largest magnitude in column k (slot SK: 0 below n-2, 3 at the
// last stage).  Without a row exchange (the common case) X is the pivot
// row as it is; an exchange selects the rows.
template <int SK, bool THREE, typename T>
__device__ __forceinline__ void stage(const Lane<T>& s, int k, int n, T (&X)[5], T& rX,
                                      T (&O)[5], T& rO, T (&Y)[5], T& rY) {
  int piv = 0;
  T best = fabs(X[SK]);
  if (THREE && fabs(O[SK]) > best) {
    piv = 1;
    best = fabs(O[SK]);
  }
  if (fabs(Y[SK]) > best) piv = 2;
  if (piv == 0) {
    pivot_step<SK, THREE>(s, k, n, X, rX, T(1) / X[SK], X, rX, O, rO, Y, rY);
    return;
  }
  T P[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    P[q] = piv == 1 ? O[q] : Y[q];
    O[q] = piv == 1 ? X[q] : O[q];      // the row at position k moves to k+1
    Y[q] = piv == 2 ? X[q] : Y[q];      // or to n-1
  }
  const T rP = piv == 1 ? rO : rY;
  rO = piv == 1 ? rX : rO;
  rY = piv == 2 ? rX : rY;
  pivot_step<SK, THREE>(s, k, n, P, rP, T(1) / P[SK], X, rX, O, rO, Y, rY);
}

// One row of the back substitution, its terms in the dense column sweep's
// order (ALL: every term exists, i <= n-5); x[n-1], x[n-2], x[i+2] and
// x[i+1] in registers, row i-1's slots read during row i.
template <bool ALL, typename T>
__device__ __forceinline__ void back_row(const Lane<T>& s, int i, int n, T& xn1, T& xn2, T& x1,
                                         T& x2, T& b, T& u4, T& u3, T& u2, T& u1, T& ud) {
  T nb = T(0), n4 = T(0), n3 = T(0), n2 = T(0), n1 = T(0), nd = T(1);
  if (ALL || i > 0) {
    nb = s.r[i - 1];
    n4 = s.U[4 * n + i - 1];
    n3 = s.U[3 * n + i - 1];
    n2 = s.U[2 * n + i - 1];
    n1 = s.U[1 * n + i - 1];
    nd = s.U[slot(i - 1, i - 1, n) * n + i - 1];
  }
  T acc = b;
  if (ALL || n - 1 > i) acc -= xn1 * u4;
  if (ALL || n - 2 > i) acc -= xn2 * u3;
  if (ALL || i + 2 < n - 2) acc -= x2 * u2;
  if (ALL || i + 1 < n - 2) acc -= x1 * u1;
  const T x = acc / ud;
  s.r[i] = x;
  if (!ALL && i == n - 1) xn1 = x;
  if (!ALL && i == n - 2) xn2 = x;
  x2 = x1;
  x1 = x;
  b = nb;
  u4 = n4;
  u3 = n3;
  u2 = n2;
  u1 = n1;
  ud = nd;
}

// Solve J(u) x = r in place (x in r) by LU with partial pivoting; one
// thread, after the warp has formed rows 1..n-2 (form_rows).
template <typename T>
__device__ void lu_solve(const Lane<T>& s, int n, T dt, T nu, T c1, T c2, T d2) {
  T X[5], Y[5], O[5], N[5];
  T rX, rY, rO = T(0), rN;
  jacobian_row(s.u, 0, 0, n, dt, nu, c1, c2, d2, X);
  jacobian_row(s.u, n - 1, 0, n, dt, nu, c1, c2, d2, Y);
  rX = s.r[0];
  rY = s.r[n - 1];
  band_row(s, 1, n, N, rN);            // n >= 3: rows 1..n-2 exist
  // stages 0..n-4 read the next stage's row ahead (row k+2 <= n-2 exists);
  // unrolled by two, which spares the rows' register moves of every other
  // stage
#pragma unroll 2
  for (int k = 0; k < n - 3; ++k) {
    copy5(O, N);                       // the original row k+1
    rO = rN;
    band_row(s, k + 2, n, N, rN);
    stage<0, true>(s, k, n, X, rX, O, rO, Y, rY);
  }
  copy5(O, N);
  rO = rN;
  stage<0, true>(s, n - 3, n, X, rX, O, rO, Y, rY);
  stage<3, false>(s, n - 2, n, X, rX, O, rO, Y, rY);
#pragma unroll
  for (int q = 0; q < 5; ++q) s.U[q * n + n - 1] = X[q];
  s.r[n - 1] = rX;
  T xn1 = T(0), xn2 = T(0), x1 = T(0), x2 = T(0);
  T b = s.r[n - 1], u4 = s.U[4 * n + n - 1], u3 = s.U[3 * n + n - 1];
  T u2 = s.U[2 * n + n - 1], u1 = s.U[1 * n + n - 1], ud = s.U[slot(n - 1, n - 1, n) * n + n - 1];
  // rows n-1..n-4 test which terms exist, rows n-5..1 have all four, row 0
  // reads no row ahead
  int i = n - 1;
  for (; i >= 0 && i > n - 5; --i)
    back_row<false>(s, i, n, xn1, xn2, x1, x2, b, u4, u3, u2, u1, ud);
  for (; i >= 1; --i) back_row<true>(s, i, n, xn1, xn2, x1, x2, b, u4, u3, u2, u1, ud);
  if (i == 0) back_row<false>(s, 0, n, xn1, xn2, x1, x2, b, u4, u3, u2, u1, ud);
}

template <typename T, bool SHARED>
__global__ void __launch_bounds__(kThreads)
    burgers1d_newton_kernel(const T* __restrict__ seed, int64_t s_sj, const T* __restrict__ dt,
                            T* __restrict__ out, int64_t o_sj, int64_t o_sk,
                            const T* __restrict__ g, int64_t g_sj, int64_t g_sk,
                            int* __restrict__ iters, T* __restrict__ ws, T nu, T c1, T c2, T d2,
                            T tol, int maxiter, int64_t J, int64_t L, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t j = blockIdx.x;
  Lane<T> s;
  s.u = SHARED ? reinterpret_cast<T*>(smem) : ws + j * 8 * (int64_t)n;
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
      form_rows(s, n, h, nu, c1, c2, d2);
      __syncwarp();
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

// ws null: the shared-memory route (8 n values a lane in dynamic shared
// memory, which must fit the opt-in); else ws holds 8 n values a lane
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
  cudaStream_t st = (cudaStream_t)stream;
  if (ws != nullptr) {
    burgers1d_newton_kernel<T, false><<<(unsigned)J, kThreads, 0, st>>>(
        seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, iters, ws, (T)nu, (T)c1, (T)c2, (T)d2,
        (T)tol, (int)maxiter, J, L, (int)n);
    return (int)cudaGetLastError();
  }
  const int64_t bytes = 8 * n * (int64_t)sizeof(T);
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (bytes > optin) return (int)cudaErrorInvalidValue;
  static int64_t opted = 48 * 1024;   // the dynamic shared memory allowed so far
  if (bytes > opted) {
    cudaError_t e = cudaFuncSetAttribute(burgers1d_newton_kernel<T, true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    opted = optin;
  }
  burgers1d_newton_kernel<T, true><<<(unsigned)J, kThreads, (size_t)bytes, st>>>(
      seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, iters, nullptr, (T)nu, (T)c1, (T)c2, (T)d2,
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
