"""Kernel K11 ``allen_cahn_pointwise`` (CUDA C++,
``csrc/allen_cahn_pointwise.cu``) beside its plain PyTorch version, and the
periodic 5-point Laplacian both compute.

K11 is the stencil and reaction pass of pymgrit_tpu/models/allen_cahn.py
(``AllenCahn._lap``, ``_nonlin``, the residual and Jacobian of
``_newton_solve`` and CN's right-hand side): the Newton residual with its
per-lane max, the Jacobian matvec and the CN right-hand side, on B periodic
(n, n) states.  In the Newton-Krylov loops it runs once per Krylov
iteration on 8-16 lanes, where a launch costs host time more than device
time, so the wrapper keeps host time down as K7's does (``theta_rhs``):
its checks, the launch plan (``plan``: vector width, block shape, bands,
grid) and the argument array (``pack``) are cached by the operands' dtype,
device, shapes and strides (``_checked``), and a launch is one ctypes call
with the array's address (its pointer slots filled in), 1/eps^2 and dx^2
by value, and the stream.  The residual's per-lane max comes from the same
launch, through a workspace of two 64-bit words a lane that the wrapper
keeps per device and stream (``_workspace``; the kernel leaves it zeroed,
and a failed launch's workspace is dropped).  The kernel
rounds each operation of the plain version once, in its order, so the two
agree bit for bit.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import array
import functools

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import (_check_facts, _contiguous, _launcher, _require,
                                                 fact)
from pymgrit_tpu_torch.ops.periodic import ipow

AC_MODES = ("rhs", "residual", "jacobian")
# the kernel's block (csrc/allen_cahn_pointwise.cu kThreads) and the
# blocks an SM its grid is sized for
THREADS, BLOCKS_PER_SM = 256, 8


def periodic_lap_plain(x, dx2):
    """The periodic 5-point Laplacian of (B, n, n) states, summed in the
    order of pymgrit_tpu/models/allen_cahn.py ``AllenCahn._lap``, divided
    by dx^2 (a tensor on x's device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal instead)."""
    d = torch.full((), dx2, dtype=x.dtype, device=x.device)
    return ((((torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) + torch.roll(x, 1, 2))
             + torch.roll(x, -1, 2)) - 4.0 * x) / d


def allen_cahn_pointwise_plain(mode, u, out, fac, inv_eps2, dx2, nu, x=None, rhs=None):
    """rhs: out = u + fac (L u + f(u)); residual: out = u - fac (L u + f(u))
    - rhs, returns (out, max |out| per state, NaN-propagating as jnp.max);
    jacobian: out = x - fac (L x + (inv_eps2 (1 - (nu+1) u^nu)) x)."""
    f_ = fac.view(-1, 1, 1)
    p = ipow(u, nu)
    if mode == "jacobian":
        out.copy_(x - f_ * (periodic_lap_plain(x, dx2) + (inv_eps2 * (1.0 - (nu + 1) * p)) * x))
        return out
    lap_f = periodic_lap_plain(u, dx2) + (inv_eps2 * u) * (1.0 - p)
    if mode == "rhs":
        out.copy_(u + f_ * lap_f)
        return out
    out.copy_((u - f_ * lap_f) - rhs)
    return out, out.abs().amax(dim=(1, 2))


def plan(B, n, itemsize, strides, sm):
    """The launch shape of a K11 call on B states of side n: (vector width
    in elements, TX, TY, bands, grid).  16-byte vectors where n and every
    batch and row stride are multiples of them (the kernel falls back to
    one element a thread where a pointer is not 16-byte aligned); TX
    threads across a row's vectors (32-THREADS, a power of two: it divides
    THREADS), TY = THREADS / TX rows a block, bands = the blocks a state, the grid
    BLOCKS_PER_SM blocks on each of the ``sm`` SMs, at most one an item
    (state, band)."""
    vec = 16 // itemsize
    if n % vec or any(s % vec for s in strides):
        vec = 1
    cols, tx = -(-n // vec), 32
    while tx < cols and tx < THREADS:
        tx *= 2
    ty = THREADS // tx
    bands = -(-n // ty)
    return vec, tx, ty, bands, max(1, min(B * bands, BLOCKS_PER_SM * sm))


def pack(index, strides, B, n, nu, mode, p):
    """The launcher's int64 argument array (csrc/allen_cahn_pointwise.cu
    ``launch``): device, the pointers u, x, rhs, fac, out, gmax and the
    workspace (filled in by each call), the batch
    and row strides of u, x, rhs and out, B, n, nu, the mode (0 rhs, 1
    residual, 2 jacobian) and the plan (vector width, TX, TY, bands,
    grid)."""
    return array.array("q", (index, *(0,) * 7, *strides, B, n, nu, mode, *p))


@functools.lru_cache(maxsize=1024)
def _checked(mode, facts, nu):
    """Every check of a K11 call, on the mode, the ``fact``s of u, out, fac
    and x (jacobian) or rhs (residual), and nu, cached by them; returns (on
    the CPU, the launch: the argument array without pointers, the launcher,
    the device index and the residual max's (length, dtype, device); None
    on the CPU or with no states)."""
    name = "allen_cahn_pointwise"
    if mode not in AC_MODES:
        _require(False, name, f"mode must be one of {AC_MODES}")
    keys = ("u", "out", "fac") + {"jacobian": ("x",), "residual": ("rhs",)}.get(mode, ())
    if len(facts) < len(keys):
        _require(False, name, f"the {mode} mode needs {keys[3]}")
    _check_facts(name, facts, keys.__getitem__)
    f = dict(zip(keys, facts))
    dtype, device, ushape, ustride = f["u"]
    if not (len(ushape) == 3 and ushape[1] == ushape[2]):
        _require(False, name, f"u has shape {tuple(ushape)}, expected (B, n, n)")
    B, n = ushape[0], ushape[1]
    for key in keys:
        if key != "fac" and tuple(f[key][2]) != (B, n, n):
            _require(False, name, f"{key} has shape {tuple(f[key][2])}, expected ({B}, {n}, {n})")
    if not (tuple(f["fac"][2]) == (B,) and _contiguous(*f["fac"][2:])):
        _require(False, name, f"fac must be a contiguous ({B},) tensor")
    if nu < 1:
        _require(False, name, "nu must be >= 1")
    if mode == "residual" and n == 0 and B:
        _require(False, name, "the residual's max needs states of side n >= 1")
    if device.type == "cpu" or B == 0 or n == 0:
        return device.type == "cpu", None
    strides = [s for key in ("u", "x", "rhs", "out")
               for s in (f[key][3][:2] if key in f else (0, 0))]
    p = plan(B, n, dtype.itemsize, strides, _build.sm_count(device.index))
    args = pack(device.index, strides, B, n, nu, AC_MODES.index(mode), p)
    return False, (args, _launcher("pm_allen_cahn_pointwise", dtype), device.index,
                   (B, dtype, device))


_WORKSPACE = {}   # (CUDA device index, stream) -> int64 tensor: max slots, then counters


def _workspace(index, stream, B):
    """The residual's per-lane max slots and block counters for launches
    on ``stream`` of CUDA device ``index`` (two int64 words a lane, zeroed
    when made; every launch that completes leaves them zeroed), grown to at
    least B lanes."""
    ws = _WORKSPACE.get((index, stream))
    if ws is None or ws.numel() < 2 * B:
        size = max(2 * B, 2 * 1024, 0 if ws is None else 2 * ws.numel())
        ws = _WORKSPACE[index, stream] = torch.zeros(size, dtype=torch.int64,
                                                     device=torch.device("cuda", index))
    return ws


def allen_cahn_pointwise(mode, u, out, fac, inv_eps2, dx2, nu, x=None, rhs=None):
    """One fused stencil + reaction pass over B periodic (n, n) states.

    mode "rhs" (CN's right-hand side), "residual" (the Newton residual
    g = u - fac (L u + f(u)) - rhs; returns (out, (B,) max |g| with NaN
    where g holds a NaN)) or "jacobian" (the Jacobian at u applied to x).
    u, x, rhs, out: (B, n, n) views with contiguous rows; fac: contiguous
    (B,) tensor; inv_eps2 = 1/eps^2 and dx2 = dx^2 are floats; nu >= 1 an
    integer.  out must not overlap the inputs.  Returns out (or the pair).
    """
    other = x if mode == "jacobian" else rhs if mode == "residual" else None
    ops = (u, out, fac) if other is None else (u, out, fac, other)
    on_cpu, launch = _checked(mode, tuple(map(fact, ops)), int(nu))
    if on_cpu:
        return allen_cahn_pointwise_plain(mode, u, out, fac, inv_eps2, dx2, nu, x, rhs)
    if launch is None:
        return (out, torch.empty(u.shape[:1], dtype=u.dtype, device=u.device)
                if mode == "residual" else out)
    tmpl, fn, index, (B, dtype, device) = launch
    stream = _build.stream(index)
    args = tmpl[:]
    args[1] = u.data_ptr()
    args[4] = fac.data_ptr()
    args[5] = out.data_ptr()
    if mode == "jacobian":
        args[2] = x.data_ptr()
    elif mode == "residual":
        gmax = torch.empty(B, dtype=dtype, device=device)
        args[3] = rhs.data_ptr()
        args[6] = gmax.data_ptr()
        args[7] = _workspace(index, stream, B).data_ptr()
    status = fn(args.buffer_info()[0], float(inv_eps2), float(dx2), stream)
    if status and mode == "residual":
        _WORKSPACE.pop((index, stream), None)   # the failed launch may have left slots set
    _build.check(status, "allen_cahn_pointwise")
    allen_cahn_pointwise.launches += 1
    return (out, gmax) if mode == "residual" else out


allen_cahn_pointwise.launches = 0
