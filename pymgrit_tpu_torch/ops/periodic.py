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
length-n product), not bitwise.  K10's float64 path runs K5's DMMA core
(the one-tile kernel up to a side of 128, the band products past it); it
is the Newton-Krylov models' preconditioner, once per Krylov iteration on
8-16 states, so its wrapper keeps host time down as K5's does: the
checks, the workspace's plan (``periodic_plan``) and the argument array
(``periodic_pack``) are cached by the operands' facts (``_checked``), and a
launch is one ctypes call with the array, the prologue's two scalars and
the stream.

K17 replaces the Fourier solve of pymgrit_tpu/models/advection_1d.py
``Advection1D.step``: the upwind backward-Euler matrix is cyclic
bidiagonal, and a recurrence with a closed-form cyclic closure solves it in
O(n), as one affine scan over threads' chunks (a warp a lane with the state
in registers across a chain's steps up to n = 512, a block a lane past it;
see the kernel's source); the plain version keeps the Fourier route.  Its
wrapper takes the one-call path too: the checks and the argument array
(``circulant_pack``, with ``circulant_plan``'s route) are cached by the
operands' facts (``_circulant_checked``), a launch is one ctypes call with
the array, fac and the stream.

Dispatch as in ``heat_kernels``: a CPU tensor goes to the plain version, a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import array
import functools

import numpy as np
import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import (ONE_TILE, TILED_CHUNK, _check_facts,
                                                 _check_operands, _contiguous, _launcher,
                                                 _require, fact)


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


# periodic_solve2d's operands in the order of its argument array's pointer
# slots 1-7 (csrc/periodic_solve2d.cu ``launch``; slot 8 the workspace)
_KEYS = ("b", "out", "H", "lam", "shift", "coef", "g")


def periodic_plan(B, S, n):
    """The states a workspace pass of a K10 call on B lanes of S species
    of side n holds: 0 up to a side of ONE_TILE, where the one-tile kernel
    (float64 DMMA, float32 FFMA) needs no workspace; past it the launcher
    runs the right-hand side pass and four band products (float64) or
    tiled2d (float32) on chunks of this many states.  (The band products
    split a state over blocks; at the preconditioner's small batches,
    B S = 1-64 of 128^2, one block a state was the faster on an H100 at
    every batch, so they serve wider states only: PERF.md.)"""
    return min(B * S, TILED_CHUNK) if n > ONE_TILE else 0


def periodic_workspace(dtype, n, chunk):
    """Elements of K10's workspace: float64 (the band route), a copy of H
    with rows of even length ld = n + n % 2, the two buffers of a chunk of
    (n x ld) states and the chunk's shifts; float32 (past ONE_TILE), the
    tiled path's two buffers of a chunk of (n x n) states."""
    if not chunk:
        return 0
    if dtype == torch.float64:
        ld = n + n % 2
        return n * ld * (1 + 2 * chunk) + chunk
    return 2 * chunk * n * n


def periodic_pack(index, bs, os, gs, B, S, n, mode, nu, chunk):
    """The launcher's int64 argument array (csrc/periodic_solve2d.cu
    ``launch``): device, seven operand pointers and the workspace's (filled
    in by each call), b's, out's and g's lane, species and row strides, the
    lanes B, S, n, the prologue mode (0 none, 1 Allen-Cahn, 2 Gray-Scott),
    nu, the workspace's chunk of states."""
    return array.array("q", (index, *(0,) * 8, *bs, *os, *gs, B, S, n, mode, nu, chunk))


def _species_strides(shape, stride):
    """(lane, species, row) strides of a (B, n, n) or (B, S, n, n) view."""
    return (stride[0], 0, stride[1]) if len(shape) == 3 else tuple(stride[:3])


@functools.lru_cache(maxsize=1024)
def _checked(facts, present, nu, gray_scott):
    """Every check of a K10 call, on the ``fact``s of the operands given
    (``present``: which of ``_KEYS``), nu and whether the Gray-Scott
    prologue is asked for, cached by them (K10 is the preconditioner of
    every Krylov iteration of the Newton-Krylov models); returns (on the
    CPU, the launch: the argument array without pointers, the launcher, the
    device index and the workspace's size in elements; None on the CPU or
    with no states)."""
    name = "periodic_solve2d"
    keys = [k for k, p in zip(_KEYS, present) if p]
    _check_facts(name, facts, keys.__getitem__)
    f = dict(zip(keys, facts))
    dtype, device, bshape, bstride = f["b"]
    if not (len(bshape) in (3, 4) and bshape[-1] == bshape[-2]):
        _require(False, name, f"b has shape {tuple(bshape)}, expected (B, n, n) or (B, S, n, n)")
    B, n = bshape[0], bshape[-1]
    S = bshape[1] if len(bshape) == 4 else 1
    for key in ("out", "g"):
        if key in f and f[key][2] != bshape:
            _require(False, name, f"{key} has shape {tuple(f[key][2])}, expected {tuple(bshape)}")
    if not (tuple(f["H"][2]) == (n, n) and tuple(f["lam"][2]) == (n, n)
            and _contiguous(*f["H"][2:]) and _contiguous(*f["lam"][2:])):
        _require(False, name, f"H and lam must be contiguous ({n}, {n}) tables")
    if not (tuple(f["shift"][2]) == (B,) and _contiguous(*f["shift"][2:])):
        _require(False, name, f"shift must be a contiguous ({B},) tensor")
    if "coef" in f and not (tuple(f["coef"][2]) == (S,) and _contiguous(*f["coef"][2:])):
        _require(False, name, f"coef must be a contiguous ({S},) tensor")
    if nu < 0:
        _require(False, name, "nu must be >= 0")
    if gray_scott and not (S == 2 and not nu):
        _require(False, name, "the Gray-Scott prologue takes (B, 2, n, n) pairs and no nu")
    if device.type == "cpu" or B == 0:
        return device.type == "cpu", None
    chunk = periodic_plan(B, S, n)
    mode = 1 if nu else 2 if gray_scott else 0
    gs = _species_strides(*f["g"][2:]) if "g" in f else (0, 0, 0)
    args = periodic_pack(device.index, _species_strides(bshape, bstride),
                         _species_strides(*f["out"][2:]), gs, B, S, n, mode, nu, chunk)
    return False, (args, _launcher("pm_periodic_solve2d", dtype), device.index,
                   periodic_workspace(dtype, n, chunk))


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
    overlap b or g other than as the same view (and not even so
    with the Gray-Scott prologue).  Returns out.
    """
    ops = (b, out, H, lam, shift, coef, g)
    on_cpu, launch = _checked(tuple([fact(t) for t in ops if t is not None]),
                              tuple(t is not None for t in ops), int(nu), gray_scott is not None)
    if gray_scott is not None and b.numel() and out.data_ptr() == b.data_ptr():
        _require(False, "periodic_solve2d",
                 "the Gray-Scott prologue reads both species: out must not be b")
    if on_cpu:
        return periodic_solve2d_plain(b, out, H, lam, shift, nu, inv_eps2, g, coef, gray_scott)
    if launch is None:
        return out
    tmpl, fn, index, ws_size = launch
    args = tmpl[:]
    for k, t in enumerate(ops):
        if t is not None:
            args[1 + k] = t.data_ptr()
    ws = None
    if ws_size:
        ws = torch.empty(ws_size, dtype=b.dtype, device=b.device)
        args[8] = ws.data_ptr()
    p0, p1 = (inv_eps2, 0.0) if nu else gray_scott if gray_scott is not None else (0.0, 0.0)
    _build.check(fn(args.buffer_info()[0], float(p0), float(p1), _build.stream(index)),
                 "periodic_solve2d")
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


# K17's routes (csrc/circulant_solve1d.cu): a warp a lane, four lanes a
# block, the state in registers up to K17_WARP_CHUNK values a thread; past
# that one block of K17_BLOCK threads a lane
K17_WARP_CHUNK = 16
K17_WARP_LANES = 4
K17_BLOCK = 256


def circulant_plan(J, n):
    """(chunk, len, grid) of one K17 launch: on the warp route (n up to 32
    K17_WARP_CHUNK) a thread's chunk is len = ceil(n / 32) values held in a
    register array of ``chunk`` slots (a power of two); on the block route
    (chunk 0) len = ceil(n / K17_BLOCK), read from the rows."""
    per = -(-n // 32)
    if per <= K17_WARP_CHUNK:
        return 1 << (per - 1).bit_length(), per, -(-J // K17_WARP_LANES)
    return 0, -(-n // K17_BLOCK), J


def circulant_pack(index, strides, J, L, n, plan):
    """The launcher's int64 argument array (csrc/circulant_solve1d.cu
    ``launch``): device, four pointers (filled in by each call: seed, dt,
    out, g), the strides (seed's lane stride, out's lane and step strides,
    g's lane and step strides), J, L, n, a thread's chunk, the register
    chunk (0: the block route), the grid."""
    chunk, per, grid = plan
    return array.array("q", (index, 0, 0, 0, 0, *strides, J, L, n, per, chunk, grid))


@functools.lru_cache(maxsize=1024)
def _circulant_checked(facts):
    """Every check of a K17 call, on the ``fact``s of seed, dt, out (and
    g), cached by them; returns (on the CPU, the launch: the argument array
    without pointers, the launcher and the device index; None on the CPU
    or with nothing to do)."""
    name = "circulant_solve1d"
    keys = ("seed", "dt", "out", "g")
    _check_facts(name, facts, keys.__getitem__)
    f = dict(zip(keys, facts))
    dtype, device, sshape, sstride = f["seed"]
    if len(sshape) != 2:
        _require(False, name, f"seed has shape {tuple(sshape)}, expected (J, n)")
    J, n = sshape
    oshape, ostride = f["out"][2:]
    if not (len(oshape) == 3 and oshape[0] == J and oshape[2] == n):
        _require(False, name, f"out has shape {tuple(oshape)}, expected ({J}, L, {n})")
    L = oshape[1]
    if "g" in f and f["g"][2] != oshape:
        _require(False, name, "g must have the shape of out")
    if not (tuple(f["dt"][2]) == (L, J) and _contiguous(*f["dt"][2:])):
        _require(False, name, f"dt must be a contiguous ({L}, {J}) tensor")
    if device.type == "cpu" or J * L * n == 0:
        return device.type == "cpu", None
    strides = (sstride[0], *ostride[:2], *(f["g"][3][:2] if "g" in f else (0, 0)))
    args = circulant_pack(device.index, strides, J, L, n, circulant_plan(J, n))
    return False, (args, _launcher("pm_circulant_solve1d", dtype), device.index)


def circulant_solve1d(seed, dt, out, g=None, fac=1.0):
    """Chained solves (1 + c) u_i - c u_{i-1} = b_i (periodic), c = dt fac,
    every step written: out[:, k] = [g[:, k] +] Phi_{dt[k]}(out[:, k-1]).

    seed: (J, n) states with contiguous rows; dt: contiguous (L, J) step
    sizes; out, g: (J, L, n) views with contiguous rows (g optional); fac:
    the advection speed over dx.  out must not overlap seed or g.  Returns
    out.
    """
    ops = (seed, dt, out) if g is None else (seed, dt, out, g)
    on_cpu, launch = _circulant_checked(tuple(map(fact, ops)))
    if on_cpu:
        return circulant_solve1d_plain(seed, dt, out, g, fac)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1], args[2], args[3] = seed.data_ptr(), dt.data_ptr(), out.data_ptr()
    if g is not None:
        args[4] = g.data_ptr()
    _build.check(fn(args.buffer_info()[0], float(fac), _build.stream(index)),
                 "circulant_solve1d")
    circulant_solve1d.launches += 1
    return out


circulant_solve1d.launches = 0
