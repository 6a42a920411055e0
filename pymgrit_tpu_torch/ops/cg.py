"""Newton's method with preconditioned conjugate gradients, on batches of
lanes (plain PyTorch control flow around the kernels).

Counterpart of the ``jax.lax.while_loop`` Newton iteration of
pymgrit_tpu/models/allen_cahn.py ``AllenCahn._newton_solve`` and of
``jax.scipy.sparse.linalg.cg`` inside it (``_cg_solve`` of JAX's
``_src/scipy/sparse/linalg.py``): x0 = 0, r0 = b - A(x0), z = M(r),
gamma = <r, z>, the stop test <r, r> > atol2 & k < maxiter with
atol2 = max(tol^2 <b, b>, atol^2).  The JAX package runs both loops under
``vmap``: every lane runs every iteration and a lane whose test has failed
keeps its state.  So do these functions, with per-lane masks; each lane's
result is that of its own loop, and the loop ends when no lane is active
(one host read per iteration).  The operators are the caller's: on the
card the matvec and residual are K11 and the preconditioner K10.
"""

from __future__ import annotations

import torch


def _dot(a, b):
    """Per-lane inner product of (B, ...) batches: (B,)."""
    return (a * b).flatten(1).sum(dim=1)


def _lanes(s, like):
    return s.view((-1,) + (1,) * (like.dim() - 1))


def pcg(A, b, M, tol, maxiter):
    """Solve A x = b per lane (JAX's default atol = 0, so the threshold is
    tol^2 <b, b>); returns (x, iterations (B,) int64)."""
    atol2 = tol ** 2 * _dot(b, b)
    x = torch.zeros_like(b)
    r = b - A(x)
    p = z = M(r)
    gamma = _dot(r, z)
    k = torch.zeros(b.shape[:1], dtype=torch.int64, device=b.device)
    active = (_dot(r, r) > atol2) & (k < maxiter)
    while bool(active.any()):
        Ap = A(p)
        alpha = _lanes(gamma / _dot(p, Ap), b)
        m = _lanes(active, b)
        x = torch.where(m, x + alpha * p, x)
        r_ = r - alpha * Ap
        r = torch.where(m, r_, r)
        z = M(r)
        gamma_ = _dot(r, z)
        p = torch.where(m, z + _lanes(gamma_ / gamma, b) * p, p)
        gamma = torch.where(active, gamma_, gamma)
        k = k + active
        active = (_dot(r, r) > atol2) & (k < maxiter)
    return x, k


def newton(residual, linear_solve, u0, tol, maxiter):
    """Newton's method per lane: u <- u - J(u)^-1 g(u) while
    max|g(u)| >= tol and fewer than maxiter iterations (a NaN in g stops a
    lane, as in JAX).

    residual(u) -> (g, max|g| per lane); linear_solve(u, g) -> (du, linear
    iterations per lane).  Returns (u, Newton iterations, linear iterations
    summed over the lane's Newton iterations), the counts (B,) int64.
    """
    u = u0.clone()
    n = torch.zeros(u.shape[:1], dtype=torch.int64, device=u.device)
    lin = torch.zeros_like(n)
    g, gmax = residual(u)
    active = (gmax >= tol) & (n < maxiter)
    while bool(active.any()):
        du, k = linear_solve(u, g)
        u = torch.where(_lanes(active, u), u - du, u)
        lin = lin + torch.where(active, k, 0)
        n = n + active
        g, gmax = residual(u)
        active = (gmax >= tol) & (n < maxiter)
    return u, n, lin
