"""Newton's method with preconditioned conjugate gradients or BiCGStab, on
batches of lanes (plain PyTorch control flow around the kernels).

Counterpart of the ``jax.lax.while_loop`` Newton iterations of
pymgrit_tpu/models/allen_cahn.py ``AllenCahn._newton_solve``,
gray_scott_2d.py ``GrayScott2D._newton`` and burgers.py ``Burgers2D.step``,
and of the Krylov solvers inside them (``_cg_solve`` and
``_bicgstab_solve`` of JAX's ``_src/scipy/sparse/linalg.py``), each with
x0 = 0 and atol2 = max(tol^2 <b, b>, atol^2), atol = 0.  The JAX package
runs these loops under ``vmap``: every lane runs every iteration and a lane
whose test has failed keeps its state.  So do these functions, with
per-lane masks (``torch.where``, so that the divisions of a finished lane,
0/0 included, never reach its values); each lane's result is that of its
own loop, and the loop ends when no lane is active (one host read per
iteration).  Inner products sum over the whole state of a lane (both
species of a two-species state).  The operators are the caller's: on the
card the matvecs and residuals are K11, K14 or K15 and the preconditioner
K10.
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


def bicgstab(A, b, M, tol, maxiter):
    """Solve A x = b per lane by right-preconditioned BiCGStab, as JAX's
    ``_bicgstab_solve``: the stop test <r, r> > atol2 & k < maxiter & k >= 0;
    a lane whose <s, s> falls below atol2 takes x + alpha M(p) and r = s
    (the early exit); omega = 0 or alpha = 0 sets k = -11 and rho = 0 sets
    k = -10, each after that iteration's update, which ends the lane.
    Returns (x, iterations per lane (B,) int64): the iterations each lane
    ran, breakdowns included."""
    atol2 = torch.clamp_min(tol ** 2 * _dot(b, b), 0.0)
    x = torch.zeros_like(b)
    r = b - A(x)
    rhat, p, q = r, r, r
    one = torch.ones(b.shape[:1], dtype=b.dtype, device=b.device)
    alpha, omega, rho = one, one, one
    k = torch.zeros(b.shape[:1], dtype=torch.int64, device=b.device)
    its = torch.zeros_like(k)
    active = (_dot(r, r) > atol2) & (k < maxiter) & (k >= 0)
    while bool(active.any()):
        rho_ = _dot(rhat, r)
        beta = _lanes(rho_ / rho * alpha / omega, b)
        p_ = r + beta * (p - _lanes(omega, b) * q)
        phat = M(p_)
        q_ = A(phat)
        alpha_ = rho_ / _dot(rhat, q_)
        s = r - _lanes(alpha_, b) * q_
        exit_early = _lanes(_dot(s, s) < atol2, b)
        shat = M(s)
        t = A(shat)
        omega_ = _dot(t, s) / _dot(t, t)
        a_, o_ = _lanes(alpha_, b), _lanes(omega_, b)
        x_ = torch.where(exit_early, x + a_ * phat, x + (a_ * phat + o_ * shat))
        r_ = torch.where(exit_early, s, s - o_ * t)
        k_ = torch.where((omega_ == 0) | (alpha_ == 0), -11, k + 1)
        k_ = torch.where(rho_ == 0, -10, k_)
        m = _lanes(active, b)
        x, r = torch.where(m, x_, x), torch.where(m, r_, r)
        p, q = torch.where(m, p_, p), torch.where(m, q_, q)
        alpha = torch.where(active, alpha_, alpha)
        omega = torch.where(active, omega_, omega)
        rho = torch.where(active, rho_, rho)
        k = torch.where(active, k_, k)
        its = its + active
        active = (_dot(r, r) > atol2) & (k < maxiter) & (k >= 0)
    return x, its


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


def newton_stats(krylov: str) -> dict:
    """A model's zeroed Newton-Krylov counters: steps, the Newton and
    ``krylov`` iterations summed over steps, and their maxima per step."""
    return {"steps": 0, "newton": 0, krylov: 0, "newton_max": 0, krylov + "_max": 0}


def tally(stats: dict, n, lin, krylov: str) -> None:
    """Add the (B,) Newton counts n and Krylov counts lin of one batch of
    steps (``newton``'s counts) to ``stats`` with one host read."""
    n_sum, n_max, lin_sum, lin_max = torch.stack([n.sum(), n.max(), lin.sum(),
                                                  lin.max()]).tolist()
    stats["steps"] += n.shape[0]
    stats["newton"] += n_sum
    stats[krylov] += lin_sum
    stats["newton_max"] = max(stats["newton_max"], n_max)
    stats[krylov + "_max"] = max(stats[krylov + "_max"], lin_max)
