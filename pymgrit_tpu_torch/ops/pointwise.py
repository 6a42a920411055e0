"""Kernels K11 ``allen_cahn_pointwise``, K14 ``gray_scott_pointwise`` and
K15 ``burgers2d_pointwise`` (CUDA C++, ``csrc/allen_cahn_pointwise.cu``,
``csrc/gray_scott_pointwise.cu``, ``csrc/burgers2d_pointwise.cu`` on
``csrc/periodic_pointwise.cuh``) beside their plain PyTorch versions, and
the periodic 5-point Laplacian they compute.

The three are the stencil and reaction passes of the periodic nonlinear
models: K11 of pymgrit_tpu/models/allen_cahn.py (``AllenCahn._lap``,
``_nonlin``, the residual and Jacobian of ``_newton_solve`` and CN's
right-hand side), K14 of gray_scott_2d.py (the EXPL step and the residual
and Jacobian matvec of ``_newton``), K15 of burgers.py (``Burgers2D``'s
residual and Jacobian matvec), on B periodic (n, n) states (K11) or
(2, n, n) pairs (K14, K15: both species of a lane in one thread).  In the
Newton-Krylov loops they run once per Krylov iteration on 4-16 lanes,
where a launch costs host time more than device time, so each wrapper
keeps host time down as K7's does (``theta_rhs``): its checks, the launch
plan (``plan``: vector width, block shape, units a block, grid) and the
argument array (``pack``, ``pair_pack``) are cached by the operands'
dtype, device, shapes and strides (``_checked``, ``_pair_checked``), and a
launch is one ctypes call with the array's address (its pointer slots
filled in), the scalars by value and the stream.  The residual's per-lane max comes from
the same launch, through a workspace of two 64-bit words a lane that the
wrappers keep per device and stream (``_workspace``; the kernels leave it
zeroed, and a failed launch's workspace is dropped).  The kernels round
each operation of the plain versions once, in their order, so the two
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
GS_MODES = ("expl", "residual", "jacobian")
BURGERS_MODES = ("residual", "jacobian")
# the kernels' block (csrc/periodic_pointwise.cuh kThreads) and the
# blocks an SM their grid is sized for
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
    """The launch shape of a K11, K14 or K15 call on B lanes of side n:
    (vector width in elements, TX, TY, units a block, grid).  16-byte
    vectors where n and every stride the call reads or writes are
    multiples of them (the kernel falls back to one element a thread where
    a pointer is not 16-byte aligned); TX threads across a row's vectors
    (32-THREADS, a power of two: it divides THREADS), TY = THREADS / TX
    rows a unit, each lane cut into ceil(n / TY) units; a block walks
    consecutive units, one while the B lanes' units fit BLOCKS_PER_SM
    blocks on each of the ``sm`` SMs, as many past it as keep the grid
    within them (a lane of few units is then one block's, which folds its
    residual max once)."""
    vec = 16 // itemsize
    if n % vec or any(s % vec for s in strides):
        vec = 1
    cols, tx = -(-n // vec), 32
    while tx < cols and tx < THREADS:
        tx *= 2
    ty = THREADS // tx
    units = B * -(-n // ty)
    per = max(1, -(-units // (BLOCKS_PER_SM * sm)))
    return vec, tx, ty, per, max(1, -(-units // per))


def pack(index, strides, B, n, nu, mode, p):
    """The launcher's int64 argument array (csrc/allen_cahn_pointwise.cu
    ``launch``): device, the pointers u, x, rhs, fac, out, gmax and the
    workspace (filled in by each call), the batch
    and row strides of u, x, rhs and out, B, n, nu, the mode (0 rhs, 1
    residual, 2 jacobian) and the plan (vector width, TX, TY, units a
    block, grid)."""
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


# ---------------------------------------------------------------------------
# K14 gray_scott_pointwise, K15 burgers2d_pointwise
# ---------------------------------------------------------------------------

# the operands of a pair call, in the order of ``_pair_checked``'s facts
# and of the launcher's pointer and stride slots (``pair_pack``)
PAIR_KEYS = ("s", "w", "r", "g", "out")


def _pair_lap(x, dx2):
    """The periodic 5-point Laplacian of both species of (B, 2, n, n)."""
    return torch.stack([periodic_lap_plain(x[:, 0], dx2), periodic_lap_plain(x[:, 1], dx2)], 1)


def gray_scott_pointwise_plain(mode, s, out, dt, du, dv, a, b, dx2, r=None, w=None, g=None):
    """expl: out = s + dt (D L s + R(s)) [+ g]; residual: out = (s - dt (D L s
    + R(s))) - r, returns (out, max |out| per lane, NaN-propagating as
    jnp.max); jacobian: out = w - dt (D L w + R'(s) w) (expression order of
    pymgrit_tpu/models/gray_scott_2d.py ``step`` and ``_newton``)."""
    d = dt.view(-1, 1, 1)
    u, v = s[:, 0], s[:, 1]
    if mode == "jacobian":
        wu, wv = w[:, 0], w[:, 1]
        lap = _pair_lap(w, dx2)
        ru = (-(v * v) - a) * wu + ((-2.0 * u) * v) * wv
        rv = (v * v) * wu + ((2.0 * u) * v - b) * wv
        out.copy_(torch.stack([wu - d * (du * lap[:, 0] + ru), wv - d * (dv * lap[:, 1] + rv)], 1))
        return out
    lap = _pair_lap(s, dx2)
    uv2 = u * (v * v)
    f = torch.stack([du * lap[:, 0] + (-uv2 + a * (1.0 - u)), dv * lap[:, 1] + (uv2 - b * v)], 1)
    d = d[:, None]
    if mode == "expl":
        x = s + d * f
        out.copy_(x if g is None else g + x)
        return out
    out.copy_((s - d * f) - r)
    return out, out.abs().amax(dim=(1, 2, 3))


def _ddx(w, two_dx):
    """(w_i+1,j - w_i-1,j) / (2 dx), with two_dx a tensor on w's device:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, where JAX (and the kernel) divides."""
    return (torch.roll(w, -1, -2) - torch.roll(w, 1, -2)) / two_dx


def _ddy(w, two_dx):
    """(w_i,j+1 - w_i,j-1) / (2 dx), as ``_ddx``."""
    return (torch.roll(w, -1, -1) - torch.roll(w, 1, -1)) / two_dx


def burgers2d_pointwise_plain(mode, s, out, dt, nu, dx, r=None, w=None):
    """residual: out = (s - r) + dt (C(s) - nu L s), returns (out, max |out|
    per lane, NaN-propagating); jacobian: out = w + dt (C'(s) w - nu L w)
    (expression order of pymgrit_tpu/models/burgers.py ``Burgers2D.step``)."""
    d = dt.view(-1, 1, 1, 1)
    two_dx, dx2 = torch.full((), 2 * dx, dtype=s.dtype, device=s.device), dx ** 2
    u, v = s[:, 0], s[:, 1]
    if mode == "jacobian":
        wu, wv = w[:, 0], w[:, 1]
        cu = u * _ddx(wu, two_dx) + wu * _ddx(u, two_dx) + v * _ddy(wu, two_dx) \
            + wv * _ddy(u, two_dx)
        cv = u * _ddx(wv, two_dx) + wu * _ddx(v, two_dx) + v * _ddy(wv, two_dx) \
            + wv * _ddy(v, two_dx)
        out.copy_(w + d * (torch.stack([cu, cv], 1) - nu * _pair_lap(w, dx2)))
        return out
    conv = torch.stack([u * _ddx(u, two_dx) + v * _ddy(u, two_dx),
                        u * _ddx(v, two_dx) + v * _ddy(v, two_dx)], 1)
    out.copy_((s - r) + d * (conv - nu * _pair_lap(s, dx2)))
    return out, out.abs().amax(dim=(1, 2, 3))


def pair_pack(index, strides, B, n, mode, p):
    """The launchers' int64 argument array (csrc/gray_scott_pointwise.cu
    ``launch``; K15's reads the same slots): device, the pointers s, w, r,
    g, dt, out, gmax and the workspace (filled in by each call), the
    batch, species and row strides of s, w, r, g and out (0 for an operand
    the call does not read), B, n, the mode (its index in GS_MODES or
    BURGERS_MODES) and the plan (vector width, TX, TY, units a block,
    grid)."""
    return array.array("q", (index, *(0,) * 8, *strides, B, n, mode, *p))


@functools.lru_cache(maxsize=1024)
def _pair_checked(name, mode, facts):
    """Every check of a K14 (``name`` "gray_scott_pointwise") or K15 call,
    on the mode and the ``fact``s of s, out, dt, r, w and g (None where
    not given), cached by them; returns (on the CPU, the launch: the
    argument array without pointers, the launcher, the device index and
    the residual max's (length, dtype, device); None on the CPU or with no
    states).  An operand the mode does not read (w in the residual, r in
    the Jacobian) is checked as the others and left alone."""
    modes = GS_MODES if name == "gray_scott_pointwise" else BURGERS_MODES
    if mode not in modes:
        _require(False, name, f"mode must be one of {modes}")
    keys = [k for k, f in zip(("s", "out", "dt", "r", "w", "g"), facts) if f is not None]
    given = [f for f in facts if f is not None]
    _check_facts(name, given, keys.__getitem__)
    f = dict(zip(keys, given))
    dtype, device, shape, _ = f["s"]
    if not (len(shape) == 4 and shape[1] == 2 and shape[2] == shape[3]):
        _require(False, name, f"s has shape {tuple(shape)}, expected (B, 2, n, n)")
    for key in keys:
        if key != "dt" and f[key][2] != shape:
            _require(False, name, f"{key} has shape {tuple(f[key][2])}, expected {tuple(shape)}")
    B, n = shape[0], shape[2]
    if not (tuple(f["dt"][2]) == (B,) and _contiguous(*f["dt"][2:])):
        _require(False, name, f"dt must be a contiguous ({B},) tensor")
    if mode == "residual" and "r" not in f:
        _require(False, name, "the residual mode needs r")
    if mode == "jacobian" and "w" not in f:
        _require(False, name, "the jacobian mode needs w")
    if "g" in f and mode != "expl":
        _require(False, name, "g is added to EXPL steps only")
    if mode == "residual" and n == 0 and B:
        _require(False, name, "the residual's max needs states of side n >= 1")
    if device.type == "cpu" or B == 0 or n == 0:
        return device.type == "cpu", None
    reads = {"s", "out", {"residual": "r", "jacobian": "w", "expl": "g"}[mode]}
    strides = [st for key in PAIR_KEYS
               for st in (f[key][3][:3] if key in f and key in reads else (0, 0, 0))]
    p = plan(B, n, dtype.itemsize, strides, _build.sm_count(device.index))
    args = pair_pack(device.index, strides, B, n, modes.index(mode), p)
    return False, (args, _launcher("pm_" + name, dtype), device.index, (B, dtype, device))


def _pair_launch(name, launch, mode, s, out, dt, r, w, g, scalars):
    """One K14 or K15 launch from ``_pair_checked``'s launch: the pointer
    slots filled in, one ctypes call; returns out (or out and the (B,)
    residual max)."""
    tmpl, fn, index, (B, dtype, device) = launch
    stream = _build.stream(index)
    args = tmpl[:]
    args[1] = s.data_ptr()
    args[5] = dt.data_ptr()
    args[6] = out.data_ptr()
    if mode == "jacobian":
        args[2] = w.data_ptr()
    elif mode == "residual":
        gmax = torch.empty(B, dtype=dtype, device=device)
        args[3] = r.data_ptr()
        args[7] = gmax.data_ptr()
        args[8] = _workspace(index, stream, B).data_ptr()
    elif g is not None:
        args[4] = g.data_ptr()
    status = fn(args.buffer_info()[0], *scalars, stream)
    if status and mode == "residual":
        _WORKSPACE.pop((index, stream), None)   # the failed launch may have left slots set
    _build.check(status, name)
    return (out, gmax) if mode == "residual" else out


def _pair_facts(ops):
    return tuple(None if t is None else fact(t) for t in ops)


def gray_scott_pointwise(mode, s, out, dt, du, dv, a, b, dx2, r=None, w=None, g=None):
    """One fused stencil + reaction pass over B Gray-Scott pairs (u, v).

    mode "expl" (the EXPL step, out = [g +] step), "residual" (the Newton
    residual g = s - dt (D L s + R(s)) - r; returns (out, (B,) max |g| over
    both species with NaN where g holds a NaN)) or "jacobian" (the Jacobian
    at s applied to w).  s, r, w, g, out: (B, 2, n, n) views with contiguous
    rows; dt: contiguous (B,) tensor; du, dv, a, b, dx2 = dx^2 floats.  out
    must not overlap the inputs.  Returns out (or the pair).
    """
    on_cpu, launch = _pair_checked("gray_scott_pointwise", mode,
                                   _pair_facts((s, out, dt, r, w, g)))
    if on_cpu:
        return gray_scott_pointwise_plain(mode, s, out, dt, du, dv, a, b, dx2, r, w, g)
    if launch is None:
        return (out, torch.empty(s.shape[:1], dtype=s.dtype, device=s.device)
                if mode == "residual" else out)
    res = _pair_launch("gray_scott_pointwise", launch, mode, s, out, dt, r, w, g,
                       (float(du), float(dv), float(a), float(b), float(dx2)))
    gray_scott_pointwise.launches += 1
    return res


gray_scott_pointwise.launches = 0


def burgers2d_pointwise(mode, s, out, dt, nu, dx, r=None, w=None):
    """One fused stencil pass over B periodic 2D Burgers velocity fields.

    mode "residual" (the Newton residual g = s - r + dt (C(s) - nu L s);
    returns (out, (B,) max |g| over both components, NaN where g holds a
    NaN)) or "jacobian" (the linearised convection and viscosity at s
    applied to w).  s, r, w, out: (B, 2, n, n) views with contiguous rows;
    dt: contiguous (B,) tensor; nu, dx floats.  out must not overlap the
    inputs.  Returns out (or the pair).
    """
    on_cpu, launch = _pair_checked("burgers2d_pointwise", mode,
                                   _pair_facts((s, out, dt, r, w, None)))
    if on_cpu:
        return burgers2d_pointwise_plain(mode, s, out, dt, nu, dx, r, w)
    if launch is None:
        return (out, torch.empty(s.shape[:1], dtype=s.dtype, device=s.device)
                if mode == "residual" else out)
    res = _pair_launch("burgers2d_pointwise", launch, mode, s, out, dt, r, w, None,
                       (float(nu), 2 * float(dx), float(dx) ** 2))
    burgers2d_pointwise.launches += 1
    return res


burgers2d_pointwise.launches = 0
