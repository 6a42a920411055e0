"""Kernel K16 ``burgers1d_newton`` (CUDA C++, ``csrc/burgers1d_newton.cu``)
beside its plain PyTorch version.

Counterpart of pymgrit_tpu/models/burgers.py ``Burgers1D.step``: a
backward-Euler step of the periodic 1D viscous Burgers equation solved by
Newton's method, each iteration a dense solve with the Jacobian
J(u) = I + dt (diag(D1 u) + u D1 - nu D2), while max|g(u)| >= tol and fewer
than maxiter iterations.  The JAX package runs that loop under ``vmap``;
the plain version masks lanes as ``ops/cg.py`` does (one host read per
iteration) and solves with ``torch.linalg.solve``.  K16 runs the whole loop
of a lane in one block (an LU with partial pivoting that visits only the
entries of the periodic tridiagonal J that can be nonzero, O(n) a Newton
iteration), for J lanes of L chained steps in one launch.  A lane's 8 n
values (iterate, the step's start, residual, U's five slots) live in
shared memory where they fit the card's opt-in, else in a workspace in
device memory that the wrapper allocates (``plan``).

Dispatch as in ``heat_kernels``: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _launcher, _require

WORKSPACE = 8            # a lane's values (shared memory or workspace), per grid point


def workspace(J: int, n: int, like: torch.Tensor) -> torch.Tensor:
    """K16's per-lane workspace in device memory: the iterate, the step's
    start, the residual and the five slots of U's rows, 8 n values a lane
    (the device route of ``plan``)."""
    return torch.empty((J, WORKSPACE * n), dtype=like.dtype, device=like.device)


def plan(n: int, itemsize: int, optin: int):
    """K16's route for states of n points of ``itemsize`` bytes on a card
    whose blocks may opt in to ``optin`` bytes of shared memory: ("shared",
    the 8 n values' bytes a block) where they fit, else ("device", 0), a
    workspace in device memory (``workspace``) and no shared memory."""
    nbytes = WORKSPACE * n * itemsize
    return ("shared", nbytes) if nbytes <= optin else ("device", 0)


def periodic_differences(n: int, dx: float):
    """The dense periodic central first and second differences (D1, D2) of
    pymgrit_tpu/models/burgers.py ``Burgers1D``, float64 numpy."""
    idx = np.arange(n)
    D1 = np.zeros((n, n))
    D1[idx, (idx + 1) % n] = 1.0 / (2 * dx)
    D1[idx, (idx - 1) % n] = -1.0 / (2 * dx)
    D2 = np.zeros((n, n))
    D2[idx, idx] = -2.0 / dx ** 2
    D2[idx, (idx + 1) % n] = 1.0 / dx ** 2
    D2[idx, (idx - 1) % n] = 1.0 / dx ** 2
    return D1, D2


def newton_dense(u0, dt, D1, D2, nu, tol, maxiter):
    """One Newton solve per lane: u0 (B, n) states, dt (B,) steps, D1/D2
    (n, n) tensors.  Returns (u, iterations (B,) int64)."""
    d = dt[:, None]
    eye = torch.eye(u0.shape[1], dtype=u0.dtype, device=u0.device)

    def g_of(u):
        return u - u0 + d * (u * (u @ D1.T) - nu * (u @ D2.T))

    u = u0.clone()
    n = torch.zeros(u0.shape[:1], dtype=torch.int64, device=u0.device)
    g = g_of(u)
    active = (g.abs().amax(dim=1) >= tol) & (n < maxiter)
    while bool(active.any()):
        J = eye + d[:, :, None] * (torch.diag_embed(u @ D1.T) + u[:, :, None] * D1 - nu * D2)
        du = torch.linalg.solve(J, g)
        u = torch.where(active[:, None], u - du, u)
        n = n + active
        g = g_of(u)
        active = (g.abs().amax(dim=1) >= tol) & (n < maxiter)
    return u, n


def burgers1d_newton_plain(seed, dt, out, g=None, nu=0.01, dx=1.0 / 128, tol=1e-12, maxiter=30,
                           iters=None):
    """J chains of L Newton steps (``newton_dense``); iters (L, J) int32
    receives each step's iteration count."""
    D1, D2 = (torch.as_tensor(a, dtype=seed.dtype, device=seed.device)
              for a in periodic_differences(seed.shape[1], dx))
    x = seed
    for k in range(out.shape[1]):
        x, n = newton_dense(x, dt[k], D1, D2, nu, tol, maxiter)
        if iters is not None:
            iters[k] = n
        if g is not None:
            x = g[:, k] + x
        out[:, k] = x
    return out


def burgers1d_newton(seed, dt, out, g=None, nu=0.01, dx=1.0 / 128, tol=1e-12, maxiter=30,
                     iters=None):
    """Chained backward-Euler Newton steps of periodic 1D Burgers, every
    step written: out[:, k] = [g[:, k] +] Phi_{dt[k]}(out[:, k-1]).

    seed: (J, n) states with contiguous rows; dt: contiguous (L, J) step
    sizes; out, g: (J, L, n) views with contiguous rows (g optional); iters:
    optional contiguous (L, J) int32 tensor that receives every lane's and
    step's Newton iterations.  out must not overlap seed or g.  Returns out.
    """
    name = "burgers1d_newton"
    ops = dict(seed=seed, dt=dt, out=out)
    if g is not None:
        ops["g"] = g
    _check_operands(name, ops)
    _require(seed.dim() == 2 and seed.shape[1] >= 3, name,
             f"seed has shape {tuple(seed.shape)}, expected (J, n) with n >= 3")
    J, n = seed.shape
    _require(out.dim() == 3 and out.shape[0] == J and out.shape[2] == n, name,
             f"out has shape {tuple(out.shape)}, expected ({J}, L, {n})")
    L = out.shape[1]
    _require(g is None or g.shape == out.shape, name, "g must have the shape of out")
    _require(tuple(dt.shape) == (L, J) and dt.is_contiguous(), name,
             f"dt must be a contiguous ({L}, {J}) tensor")
    _require(iters is None or (tuple(iters.shape) == (L, J) and iters.is_contiguous()
                               and iters.dtype == torch.int32 and iters.device == seed.device),
             name, f"iters must be a contiguous ({L}, {J}) int32 tensor on {seed.device}")
    if seed.device.type == "cpu":
        return burgers1d_newton_plain(seed, dt, out, g, nu, dx, tol, maxiter, iters)
    if J == 0 or L == 0:
        return out
    route, _ = plan(n, seed.element_size(), _build.smem_optin(seed.device.index))
    ws = workspace(J, n, seed) if route == "device" else None
    fn = _launcher("pm_burgers1d_newton", seed.dtype)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    status = fn(seed.data_ptr(), seed.stride(0), dt.data_ptr(), out.data_ptr(), out.stride(0),
                out.stride(1), g.data_ptr() if g is not None else None,
                g.stride(0) if g is not None else 0, g.stride(1) if g is not None else 0,
                iters.data_ptr() if iters is not None else None,
                ws.data_ptr() if ws is not None else None, float(nu),
                1.0 / (2 * dx), 1.0 / dx ** 2, -2.0 / dx ** 2, float(tol), int(maxiter), J, L, n,
                stream)
    _build.check(status, name)
    burgers1d_newton.launches += 1
    return out


burgers1d_newton.launches = 0
