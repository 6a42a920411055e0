"""Kernel K10 ``periodic_solve2d`` (CUDA C++, ``csrc/periodic_solve2d.cu``)
beside its plain PyTorch version, and the Hartley basis it uses.

The periodic 5-point Laplacian L on an n x n grid has the eigenvalues
lam_k + lam_l with lam_k = (2 cos(2 pi k / n) - 2) / dx^2, even in k
(lam_k = lam_{n-k}).  So the cosine and the sine of one frequency share an
eigenvalue, and the normalised Hartley matrix
H[j, k] = (cos + sin)(2 pi j k / n) / sqrt(n) -- real, symmetric and
orthogonal -- diagonalises L:  (I - s L)^-1 b = H ((H b H) / (1 + s Lam)) H
with Lam = -(lam_k + lam_l) >= 0.  That is the two-sided product of K5's
core with H for both bases, and replaces the complex dense DFT products of
pymgrit_tpu/models/allen_cahn.py ``AllenCahn._fft_solve``.  The two routes
agree to rounding (a few ulp per length-n product), not bitwise.

Dispatch as in ``heat_kernels``: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import MAX_SIDE, _check_operands, _launcher, _require


def hartley_basis(n: int) -> np.ndarray:
    """The normalised (n, n) Hartley matrix in float64 (angles reduced
    modulo 2 pi exactly through j k mod n)."""
    jk = np.outer(np.arange(n), np.arange(n)) % n
    ang = 2.0 * np.pi * jk / n
    return (np.cos(ang) + np.sin(ang)) / np.sqrt(n)


def ipow(u, nu: int):
    """u**nu for an integer nu >= 1 as repeated products (u*u for nu = 2, as
    XLA's integer power; the kernels multiply in the same order)."""
    p = u
    for _ in range(nu - 1):
        p = p * u
    return p


def periodic_solve2d_plain(b, out, H, lam, shift, nu=0, inv_eps2=0.0, g=None):
    """out = [g +] H ((H r H) / (1 + shift * lam)) H with r = b, or with
    nu > 0 the IMEX right-hand side r = b + shift ((inv_eps2 b) (1 - b^nu))."""
    s = shift.view(-1, 1, 1)
    if nu:
        b = b + s * ((inv_eps2 * b) * (1.0 - ipow(b, nu)))
    x = torch.matmul(torch.matmul(H, b), H)
    x = torch.matmul(torch.matmul(H, x / (1.0 + s * lam)), H)
    out.copy_(x if g is None else g + x)
    return out


def periodic_solve2d(b, out, H, lam, shift, nu=0, inv_eps2=0.0, g=None):
    """Batched solve (I - shift_b L) x_b = r_b of B periodic (n, n) states.

    b: (B, n, n) view (rows contiguous); out, g: (B, n, n) views, g optional
    (out = g + x); H: the contiguous (n, n) Hartley basis; lam: the
    contiguous (n, n) negated eigenvalue sums; shift: contiguous (B,) tensor;
    nu > 0 turns on the IMEX prologue r = b + shift ((inv_eps2 b)(1 - b^nu)),
    else r = b.  n <= 128 on the card.  out must not overlap b or g other
    than as the same view.  Returns out.
    """
    name = "periodic_solve2d"
    ops = dict(b=b, out=out, H=H, lam=lam, shift=shift)
    if g is not None:
        ops["g"] = g
    _check_operands(name, ops)
    _require(b.dim() == 3 and b.shape[1] == b.shape[2], name,
             f"b has shape {tuple(b.shape)}, expected (B, n, n)")
    B, n = b.shape[0], b.shape[1]
    for key, t in (("out", out), ("g", g)):
        _require(t is None or tuple(t.shape) == (B, n, n), name,
                 f"{key} has shape {tuple(t.shape) if t is not None else None}, "
                 f"expected ({B}, {n}, {n})")
    _require(tuple(H.shape) == (n, n) and tuple(lam.shape) == (n, n)
             and H.is_contiguous() and lam.is_contiguous(), name,
             f"H and lam must be contiguous ({n}, {n}) tables")
    _require(tuple(shift.shape) == (B,) and shift.is_contiguous(), name,
             f"shift must be a contiguous ({B},) tensor")
    _require(int(nu) >= 0, name, "nu must be >= 0")
    if b.device.type == "cpu":
        return periodic_solve2d_plain(b, out, H, lam, shift, nu, inv_eps2, g)
    _require(n <= MAX_SIDE, name, f"side {n} exceeds {MAX_SIDE} (the kernel's shared tile)")
    if B == 0:
        return out
    fn = _launcher("pm_periodic_solve2d", b.dtype)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    status = fn(b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(), out.stride(0),
                out.stride(1), H.data_ptr(), lam.data_ptr(), shift.data_ptr(), int(nu),
                float(inv_eps2), g.data_ptr() if g is not None else None,
                g.stride(0) if g is not None else 0, g.stride(1) if g is not None else 0,
                B, n, stream)
    _build.check(status, name)
    periodic_solve2d.launches += 1
    return out


periodic_solve2d.launches = 0
