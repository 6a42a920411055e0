"""Kernels K10 ``periodic_solve2d`` and K17 ``circulant_solve1d`` (CUDA C++,
``csrc/periodic_solve2d.cu``, ``csrc/circulant_solve1d.cu``) beside their
plain PyTorch versions, and the Hartley basis K10 uses.

The periodic 5-point Laplacian L on an n x n grid has the eigenvalues
lam_k + lam_l with lam_k = (2 cos(2 pi k / n) - 2) / dx^2, even in k
(lam_k = lam_{n-k}).  So the cosine and the sine of one frequency share an
eigenvalue, and the normalised Hartley matrix
H[j, k] = (cos + sin)(2 pi j k / n) / sqrt(n) -- real, symmetric and
orthogonal -- diagonalises L:  (I - s L)^-1 b = H ((H b H) / (1 + s Lam)) H
with Lam = -(lam_k + lam_l) >= 0.  That is the two-sided product of K5's
core with H for both bases, and replaces the complex dense DFT products of
pymgrit_tpu/models/allen_cahn.py ``AllenCahn._fft_solve`` and the FFT
solves of pymgrit_tpu/models/gray_scott_2d.py ``_fft_solve_diffusion`` and
burgers.py ``Burgers2D._fft_visc_solve`` (one coefficient per species:
(du, dv) and (nu, nu)).  The two routes agree to rounding (a few ulp per
length-n product), not bitwise.

K17 replaces the Fourier solve of pymgrit_tpu/models/advection_1d.py
``Advection1D.step``: the upwind backward-Euler matrix is cyclic
bidiagonal, and a recurrence with a closed-form cyclic closure solves it in
O(n) (see the kernel's source); the plain version keeps the Fourier route.

Dispatch as in ``heat_kernels``: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import (_check_operands, _launcher, _require,
                                                 tiled_workspace)


def hartley_basis(n: int) -> np.ndarray:
    """The normalised (n, n) Hartley matrix in float64 (angles reduced
    modulo 2 pi exactly through j k mod n)."""
    jk = np.outer(np.arange(n), np.arange(n)) % n
    ang = 2.0 * np.pi * jk / n
    return (np.cos(ang) + np.sin(ang)) / np.sqrt(n)


def periodic_lap_eigs(n: int, dx: float) -> np.ndarray:
    """The (n, n) eigenvalue sums lam_k + lam_l of the periodic 5-point
    Laplacian, lam_k = (2 cos(2 pi k / n) - 2) / dx^2, in float64."""
    lam1d = (2.0 * np.cos(2.0 * np.pi * np.arange(n) / n) - 2.0) / dx ** 2
    return lam1d[:, None] + lam1d[None, :]


def ipow(u, nu: int):
    """u**nu for an integer nu >= 1 as repeated products (u*u for nu = 2, as
    XLA's integer power; the kernels multiply in the same order)."""
    p = u
    for _ in range(nu - 1):
        p = p * u
    return p


def _species(t):
    """A (B, n, n) batch as (B, 1, n, n); a (B, S, n, n) batch as it is."""
    return t if t is None or t.dim() == 4 else t[:, None]


def periodic_solve2d_plain(b, out, H, lam, shift, nu=0, inv_eps2=0.0, g=None, coef=None,
                           gray_scott=None):
    """out = [g +] H ((H r H) / (1 + shift coef_s lam)) H per lane and
    species, with r = b, or the IMEX right-hand side r = b + shift R(b) of
    Allen-Cahn (nu > 0: R(u) = (inv_eps2 u)(1 - u^nu)) or of Gray-Scott
    (gray_scott = (a, b): R(u, v) = (-u v^2 + a (1 - u), u v^2 - b v))."""
    b4, out4, g4 = _species(b), _species(out), _species(g)
    dt = shift.view(-1, 1, 1, 1)
    s = dt if coef is None else dt * coef.view(1, -1, 1, 1)
    if nu:
        b4 = b4 + dt * ((inv_eps2 * b4) * (1.0 - ipow(b4, nu)))
    elif gray_scott is not None:
        a, bb = gray_scott
        u, v = b4[:, 0], b4[:, 1]
        uv2 = u * (v * v)
        b4 = b4 + dt * torch.stack([-uv2 + a * (1 - u), uv2 - bb * v], 1)
    x = torch.matmul(torch.matmul(H, b4), H)
    x = torch.matmul(torch.matmul(H, x / (1.0 + s * lam)), H)
    out4.copy_(x if g4 is None else g4 + x)
    return out


def periodic_solve2d(b, out, H, lam, shift, nu=0, inv_eps2=0.0, g=None, coef=None,
                     gray_scott=None):
    """Batched solve (I - shift_b coef_s L) x_bs = r_bs of B periodic lanes
    of S species of (n, n) states.

    b: (B, n, n) (one species) or (B, S, n, n) view, rows contiguous; out, g:
    views of b's shape, g optional (out = g + x); H: the contiguous (n, n)
    Hartley basis; lam: the contiguous (n, n) negated eigenvalue sums;
    shift: contiguous (B,) tensor (the step of each lane); coef: contiguous
    (S,) tensor of per-species coefficients (None: 1); a prologue turns b
    into an IMEX right-hand side: nu > 0 the Allen-Cahn one
    r = b + shift ((inv_eps2 b)(1 - b^nu)), gray_scott = (a, b) the
    Gray-Scott one over the pair (u, v) (S = 2); else r = b.  out must not
    overlap b or g other than as the same view (and not even so with the
    Gray-Scott prologue).  Returns out.
    """
    name = "periodic_solve2d"
    ops = dict(b=b, out=out, H=H, lam=lam, shift=shift)
    if g is not None:
        ops["g"] = g
    if coef is not None:
        ops["coef"] = coef
    _check_operands(name, ops)
    _require(b.dim() in (3, 4) and b.shape[-1] == b.shape[-2], name,
             f"b has shape {tuple(b.shape)}, expected (B, n, n) or (B, S, n, n)")
    B, n = b.shape[0], b.shape[-1]
    S = b.shape[1] if b.dim() == 4 else 1
    for key, t in (("out", out), ("g", g)):
        _require(t is None or t.shape == b.shape, name,
                 f"{key} has shape {tuple(t.shape) if t is not None else None}, "
                 f"expected {tuple(b.shape)}")
    _require(tuple(H.shape) == (n, n) and tuple(lam.shape) == (n, n)
             and H.is_contiguous() and lam.is_contiguous(), name,
             f"H and lam must be contiguous ({n}, {n}) tables")
    _require(tuple(shift.shape) == (B,) and shift.is_contiguous(), name,
             f"shift must be a contiguous ({B},) tensor")
    _require(coef is None or (tuple(coef.shape) == (S,) and coef.is_contiguous()), name,
             f"coef must be a contiguous ({S},) tensor")
    _require(int(nu) >= 0, name, "nu must be >= 0")
    _require(gray_scott is None or (S == 2 and not nu), name,
             "the Gray-Scott prologue takes (B, 2, n, n) pairs and no nu")
    _require(gray_scott is None or out.data_ptr() != b.data_ptr(), name,
             "the Gray-Scott prologue reads both species: out must not be b")
    if b.device.type == "cpu":
        return periodic_solve2d_plain(b, out, H, lam, shift, nu, inv_eps2, g, coef, gray_scott)
    if B == 0:
        return out
    b4, out4, g4 = _species(b), _species(out), _species(g)
    mode, p0, p1 = (1, inv_eps2, 0.0) if nu else (2, *gray_scott) if gray_scott else (0, 0.0, 0.0)
    ws, chunk = tiled_workspace(B * S, n, n, b)
    fn = _launcher("pm_periodic_solve2d", b.dtype)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    status = fn(b4.data_ptr(), *b4.stride()[:3], out4.data_ptr(), *out4.stride()[:3],
                H.data_ptr(), lam.data_ptr(), shift.data_ptr(),
                coef.data_ptr() if coef is not None else None, S, mode, int(nu), float(p0),
                float(p1), g4.data_ptr() if g4 is not None else None,
                *(g4.stride()[:3] if g4 is not None else (0, 0, 0)),
                ws.data_ptr() if ws is not None else None, chunk, B, n, stream)
    _build.check(status, name)
    periodic_solve2d.launches += 1
    return out


periodic_solve2d.launches = 0


def circulant_solve1d_plain(seed, dt, out, g=None, fac=1.0):
    """J chains of L upwind backward-Euler steps by the Fourier route of
    pymgrit_tpu/models/advection_1d.py ``Advection1D.step``: divide the DFT
    by 1 + c (1 - e^(-2 pi i k/n)), c = dt fac, and keep the real part of
    the inverse."""
    n = seed.shape[1]
    eigs = torch.as_tensor(np.exp(-2j * np.pi * np.arange(n) / n), device=seed.device)
    x = seed
    for k in range(out.shape[1]):
        denom = 1.0 + (dt[k] * fac)[:, None] * (1.0 - eigs)
        x = torch.fft.ifft(torch.fft.fft(x) / denom).real.to(seed.dtype)
        if g is not None:
            x = g[:, k] + x
        out[:, k] = x
    return out


def circulant_solve1d(seed, dt, out, g=None, fac=1.0):
    """Chained solves (1 + c) u_i - c u_{i-1} = b_i (periodic), c = dt fac,
    every step written: out[:, k] = [g[:, k] +] Phi_{dt[k]}(out[:, k-1]).

    seed: (J, n) states with contiguous rows; dt: contiguous (L, J) step
    sizes; out, g: (J, L, n) views with contiguous rows (g optional); fac:
    the advection speed over dx.  out must not overlap seed or g.  Returns
    out.
    """
    name = "circulant_solve1d"
    ops = dict(seed=seed, dt=dt, out=out)
    if g is not None:
        ops["g"] = g
    _check_operands(name, ops)
    _require(seed.dim() == 2, name, f"seed has shape {tuple(seed.shape)}, expected (J, n)")
    J, n = seed.shape
    _require(out.dim() == 3 and out.shape[0] == J and out.shape[2] == n, name,
             f"out has shape {tuple(out.shape)}, expected ({J}, L, {n})")
    L = out.shape[1]
    _require(g is None or g.shape == out.shape, name, "g must have the shape of out")
    _require(tuple(dt.shape) == (L, J) and dt.is_contiguous(), name,
             f"dt must be a contiguous ({L}, {J}) tensor")
    if seed.device.type == "cpu":
        return circulant_solve1d_plain(seed, dt, out, g, fac)
    if J == 0 or L == 0 or n == 0:
        return out
    fn = _launcher("pm_circulant_solve1d", seed.dtype)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    status = fn(seed.data_ptr(), seed.stride(0), dt.data_ptr(), out.data_ptr(), out.stride(0),
                out.stride(1), g.data_ptr() if g is not None else None,
                g.stride(0) if g is not None else 0, g.stride(1) if g is not None else 0,
                float(fac), J, L, n, stream)
    _build.check(status, name)
    circulant_solve1d.launches += 1
    return out


circulant_solve1d.launches = 0
