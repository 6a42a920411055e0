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

On a space shard (``parallel``'s ('time', 'space') mesh) a state is the
slab of R of its n rows, and the stencils read the rows above and below
the slab from the neighbouring shards: the halo mode (``halo=(above,
below)``, each a contiguous (B, [2,] n) tensor of the Laplacian's operand;
K15 also ``w_halo`` in its Jacobian, whose convection differences s as well
as w).  It wraps in y only, writes the slab's R rows and keeps the
residual's per-lane max (the slab's).  K11 and K14 also have a pointwise
``prologue`` mode, K10's fused IMEX right-hand side
(``periodic.imex_prologue_plain``) for a slab's pencil solve.  A halo mode
equals the whole-state plain version on the gathered states bit for bit:
the same operations on the same values.

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
from pymgrit_tpu_torch.ops.periodic import imex_prologue_plain, ipow

AC_MODES = ("rhs", "residual", "jacobian", "prologue")
GS_MODES = ("expl", "residual", "jacobian", "prologue")
BURGERS_MODES = ("residual", "jacobian")
# the kernels' block (csrc/periodic_pointwise.cuh kThreads) and the
# blocks an SM their grid is sized for
THREADS, BLOCKS_PER_SM = 256, 8


def _north_south(x, halo=None):
    """x's rows i - 1 and i + 1 at every row i of axis -2: rolled (the
    periodic wrap), or, with halo = (above, below), the halo rows past the
    slab's first and last row."""
    if halo is None:
        return torch.roll(x, 1, -2), torch.roll(x, -1, -2)
    R = x.shape[-2]
    return (torch.cat([halo[0].unsqueeze(-2), x.narrow(-2, 0, R - 1)], -2),
            torch.cat([x.narrow(-2, 1, R - 1), halo[1].unsqueeze(-2)], -2))


def periodic_lap_plain(x, dx2, halo=None):
    """The periodic 5-point Laplacian of (B, n, n) states (or of (B, R, n)
    slabs with their halo rows, ``_north_south``), summed in the order of
    pymgrit_tpu/models/allen_cahn.py ``AllenCahn._lap``, divided by dx^2 (a
    tensor on x's device: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal instead)."""
    d = torch.full((), dx2, dtype=x.dtype, device=x.device)
    north, south = _north_south(x, halo)
    return ((((north + south) + torch.roll(x, 1, -1)) + torch.roll(x, -1, -1)) - 4.0 * x) / d


def allen_cahn_pointwise_plain(mode, u, out, fac, inv_eps2, dx2, nu, x=None, rhs=None,
                               halo=None):
    """rhs: out = u + fac (L u + f(u)); residual: out = u - fac (L u + f(u))
    - rhs, returns (out, max |out| per state, NaN-propagating as jnp.max);
    jacobian: out = x - fac (L x + (inv_eps2 (1 - (nu+1) u^nu)) x);
    prologue: out = u + fac f(u) (``imex_prologue_plain``).  halo: the rows
    above and below a slab of L's operand (u, or x in the Jacobian)."""
    f_ = fac.view(-1, 1, 1)
    if mode == "prologue":
        out.copy_(imex_prologue_plain(u[:, None], fac.view(-1, 1, 1, 1), nu, inv_eps2)[:, 0])
        return out
    p = ipow(u, nu)
    if mode == "jacobian":
        out.copy_(x - f_ * (periodic_lap_plain(x, dx2, halo)
                            + (inv_eps2 * (1.0 - (nu + 1) * p)) * x))
        return out
    lap_f = periodic_lap_plain(u, dx2, halo) + (inv_eps2 * u) * (1.0 - p)
    if mode == "rhs":
        out.copy_(u + f_ * lap_f)
        return out
    out.copy_((u - f_ * lap_f) - rhs)
    return out, out.abs().amax(dim=(1, 2))


def plan(B, n, itemsize, strides, sm, rows=None):
    """The launch shape of a K11, K14 or K15 call on B lanes of side n (of
    ``rows`` rows of n columns: a slab's R; n by default): (vector width in
    elements, TX, TY, units a block, grid).  16-byte
    vectors where n and every stride the call reads or writes are
    multiples of them (the kernel falls back to one element a thread where
    a pointer is not 16-byte aligned); TX threads across a row's vectors
    (32-THREADS, a power of two: it divides THREADS), TY = THREADS / TX
    rows a unit, each lane cut into ceil(rows / TY) units; a block walks
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
    units = B * -(-(n if rows is None else rows) // ty)
    per = max(1, -(-units // (BLOCKS_PER_SM * sm)))
    return vec, tx, ty, per, max(1, -(-units // per))


def pack(index, strides, B, n, nu, mode, p, R):
    """The launcher's int64 argument array (csrc/allen_cahn_pointwise.cu
    ``launch``): device, the pointers u, x, rhs, fac, out, gmax and the
    workspace (filled in by each call), the batch
    and row strides of u, x, rhs and out, B, n, nu, the mode (0 rhs, 1
    residual, 2 jacobian, 3 prologue), the plan (vector width, TX, TY,
    units a block, grid), the rows R of a lane (n, or a slab's) and the
    halo rows' pointers above and below (filled in by a halo call)."""
    return array.array("q", (index, *(0,) * 7, *strides, B, n, nu, mode, *p, R, 0, 0))


def _square(name, key, shape, want, mode, halo):
    """Checks that a call's first operand holds whole (square) states,
    unless a halo call or the pointwise prologue takes its slabs."""
    if not halo and mode != "prologue" and shape[-1] != shape[-2]:
        _require(False, name, f"{key} has shape {tuple(shape)}, expected {want} (or a slab of R "
                              "rows with halo=(above, below))")


def _halo_shapes(name, f, mode, lead, n, halo):
    """Checks a halo call's (B, [2,] n) contiguous halo rows."""
    if halo and mode == "prologue":
        _require(False, name, "the prologue is pointwise: it takes no halo")
    for key in ("above", "below", "w_above", "w_below"):
        if key in f and not (tuple(f[key][2]) == lead + (n,) and _contiguous(*f[key][2:])):
            _require(False, name, f"halo row {key} has shape {tuple(f[key][2])}, expected a "
                                  f"contiguous {lead + (n,)}")


@functools.lru_cache(maxsize=1024)
def _checked(mode, facts, nu, halo=False):
    """Every check of a K11 call, on the mode, the ``fact``s of u, out, fac,
    x (jacobian) or rhs (residual) and, with ``halo``, the rows above and
    below, and nu, cached by them; returns (on the CPU, the launch: the
    argument array without pointers, the launcher, the device index and
    the residual max's (length, dtype, device); None on the CPU or with no
    states)."""
    name = "allen_cahn_pointwise"
    if mode not in AC_MODES:
        _require(False, name, f"mode must be one of {AC_MODES}")
    keys = (("u", "out", "fac") + {"jacobian": ("x",), "residual": ("rhs",)}.get(mode, ())
            + (("above", "below") if halo else ()))
    if len(facts) < len(keys):
        _require(False, name, f"the {mode} mode needs {keys[3]}")
    _check_facts(name, facts, keys.__getitem__)
    f = dict(zip(keys, facts))
    dtype, device, ushape, ustride = f["u"]
    if len(ushape) != 3:
        _require(False, name, f"u has shape {tuple(ushape)}, expected (B, n, n) or a slab "
                              "(B, R, n)")
    B, R, n = ushape
    _square(name, "u", ushape, "(B, n, n)", mode, halo)
    for key in keys:
        if key not in ("fac", "above", "below") and tuple(f[key][2]) != (B, R, n):
            _require(False, name, f"{key} has shape {tuple(f[key][2])}, expected ({B}, {R}, {n})")
    _halo_shapes(name, f, mode, (B,), n, halo)
    if not (tuple(f["fac"][2]) == (B,) and _contiguous(*f["fac"][2:])):
        _require(False, name, f"fac must be a contiguous ({B},) tensor")
    if nu < 1:
        _require(False, name, "nu must be >= 1")
    if mode == "residual" and (n == 0 or R == 0) and B:
        _require(False, name, "the residual's max needs states of side n >= 1")
    if device.type == "cpu" or B == 0 or n == 0 or R == 0:
        return device.type == "cpu", None
    strides = [s for key in ("u", "x", "rhs", "out")
               for s in (f[key][3][:2] if key in f else (0, 0))]
    p = plan(B, n, dtype.itemsize, strides, _build.sm_count(device.index), R)
    args = pack(device.index, strides, B, n, nu, AC_MODES.index(mode), p, R)
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


def allen_cahn_pointwise(mode, u, out, fac, inv_eps2, dx2, nu, x=None, rhs=None, halo=None):
    """One fused stencil + reaction pass over B periodic (n, n) states.

    mode "rhs" (CN's right-hand side), "residual" (the Newton residual
    g = u - fac (L u + f(u)) - rhs; returns (out, (B,) max |g| with NaN
    where g holds a NaN)), "jacobian" (the Jacobian at u applied to x) or
    "prologue" (IMEX's u + fac f(u), pointwise).  u, x, rhs, out: (B, n,
    n) views with contiguous rows, or a space shard's (B, R, n) slabs with
    ``halo`` = (above, below), contiguous (B, n) rows of L's operand (u, or
    x in the Jacobian) past the slab's first and last row; fac: contiguous
    (B,) tensor; inv_eps2 = 1/eps^2 and dx2 = dx^2 are floats; nu >= 1 an
    integer.  out must not overlap the inputs.  Returns out (or the pair).
    """
    other = x if mode == "jacobian" else rhs if mode == "residual" else None
    ops = (u, out, fac) if other is None else (u, out, fac, other)
    if halo is not None:
        ops = ops + tuple(halo)
    on_cpu, launch = _checked(mode, tuple(map(fact, ops)), int(nu), halo is not None)
    if on_cpu:
        return allen_cahn_pointwise_plain(mode, u, out, fac, inv_eps2, dx2, nu, x, rhs, halo)
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
    if halo is not None:
        args[26], args[27] = halo[0].data_ptr(), halo[1].data_ptr()
    status = fn(args.buffer_info()[0], float(inv_eps2), float(dx2), stream)
    if status and mode == "residual":
        _WORKSPACE.pop((index, stream), None)   # the failed launch may have left slots set
    _build.check(status, "allen_cahn_pointwise")
    allen_cahn_pointwise.launches += 1
    allen_cahn_pointwise.mode_launches[_mode_key(mode, halo)] += 1
    return (out, gmax) if mode == "residual" else out


def _mode_key(mode, halo):
    """A launch's key in a stencil wrapper's ``mode_launches``."""
    return "prologue" if mode == "prologue" else "halo" if halo is not None else "whole"


allen_cahn_pointwise.launches = 0
allen_cahn_pointwise.mode_launches = {"whole": 0, "halo": 0, "prologue": 0}   # launches by mode


# ---------------------------------------------------------------------------
# K14 gray_scott_pointwise, K15 burgers2d_pointwise
# ---------------------------------------------------------------------------

# the operands of a pair call, in the order of ``_pair_checked``'s facts
# and of the launcher's pointer and stride slots (``pair_pack``)
PAIR_KEYS = ("s", "w", "r", "g", "out")


def _species_halo(halo, k):
    """Species k's rows of a pair call's (above, below) halo (None: none)."""
    return None if halo is None else (halo[0][:, k], halo[1][:, k])


def _pair_lap(x, dx2, halo=None):
    """The periodic 5-point Laplacian of both species of (B, 2, n, n) (or
    of (B, 2, R, n) slabs with their (B, 2, n) halo rows)."""
    return torch.stack([periodic_lap_plain(x[:, 0], dx2, _species_halo(halo, 0)),
                        periodic_lap_plain(x[:, 1], dx2, _species_halo(halo, 1))], 1)


def gray_scott_pointwise_plain(mode, s, out, dt, du, dv, a, b, dx2, r=None, w=None, g=None,
                               halo=None):
    """expl: out = s + dt (D L s + R(s)) [+ g]; residual: out = (s - dt (D L s
    + R(s))) - r, returns (out, max |out| per lane, NaN-propagating as
    jnp.max); jacobian: out = w - dt (D L w + R'(s) w) (expression order of
    pymgrit_tpu/models/gray_scott_2d.py ``step`` and ``_newton``);
    prologue: out = s + dt R(s) (``imex_prologue_plain``).  halo: the rows
    above and below a slab of L's operand (s, or w in the Jacobian)."""
    d = dt.view(-1, 1, 1)
    if mode == "prologue":
        out.copy_(imex_prologue_plain(s, dt.view(-1, 1, 1, 1), gray_scott=(a, b)))
        return out
    u, v = s[:, 0], s[:, 1]
    if mode == "jacobian":
        wu, wv = w[:, 0], w[:, 1]
        lap = _pair_lap(w, dx2, halo)
        ru = (-(v * v) - a) * wu + ((-2.0 * u) * v) * wv
        rv = (v * v) * wu + ((2.0 * u) * v - b) * wv
        out.copy_(torch.stack([wu - d * (du * lap[:, 0] + ru), wv - d * (dv * lap[:, 1] + rv)], 1))
        return out
    lap = _pair_lap(s, dx2, halo)
    uv2 = u * (v * v)
    f = torch.stack([du * lap[:, 0] + (-uv2 + a * (1.0 - u)), dv * lap[:, 1] + (uv2 - b * v)], 1)
    d = d[:, None]
    if mode == "expl":
        x = s + d * f
        out.copy_(x if g is None else g + x)
        return out
    out.copy_((s - d * f) - r)
    return out, out.abs().amax(dim=(1, 2, 3))


def _ddx(w, two_dx, halo=None):
    """(w_i+1,j - w_i-1,j) / (2 dx), with two_dx a tensor on w's device:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, where JAX (and the kernel) divides.  halo: a slab's rows
    above and below (``_north_south``)."""
    north, south = _north_south(w, halo)
    return (south - north) / two_dx


def _ddy(w, two_dx):
    """(w_i,j+1 - w_i,j-1) / (2 dx), as ``_ddx``."""
    return (torch.roll(w, -1, -1) - torch.roll(w, 1, -1)) / two_dx


def burgers2d_pointwise_plain(mode, s, out, dt, nu, dx, r=None, w=None, halo=None,
                              w_halo=None):
    """residual: out = (s - r) + dt (C(s) - nu L s), returns (out, max |out|
    per lane, NaN-propagating); jacobian: out = w + dt (C'(s) w - nu L w)
    (expression order of pymgrit_tpu/models/burgers.py ``Burgers2D.step``).
    halo, w_halo: the rows above and below a slab of s and of w."""
    d = dt.view(-1, 1, 1, 1)
    two_dx, dx2 = torch.full((), 2 * dx, dtype=s.dtype, device=s.device), dx ** 2
    u, v = s[:, 0], s[:, 1]
    hu, hv = _species_halo(halo, 0), _species_halo(halo, 1)
    if mode == "jacobian":
        wu, wv = w[:, 0], w[:, 1]
        wu_h, wv_h = _species_halo(w_halo, 0), _species_halo(w_halo, 1)
        cu = u * _ddx(wu, two_dx, wu_h) + wu * _ddx(u, two_dx, hu) + v * _ddy(wu, two_dx) \
            + wv * _ddy(u, two_dx)
        cv = u * _ddx(wv, two_dx, wv_h) + wu * _ddx(v, two_dx, hv) + v * _ddy(wv, two_dx) \
            + wv * _ddy(v, two_dx)
        out.copy_(w + d * (torch.stack([cu, cv], 1) - nu * _pair_lap(w, dx2, w_halo)))
        return out
    conv = torch.stack([u * _ddx(u, two_dx, hu) + v * _ddy(u, two_dx),
                        u * _ddx(v, two_dx, hv) + v * _ddy(v, two_dx)], 1)
    out.copy_((s - r) + d * (conv - nu * _pair_lap(s, dx2, halo)))
    return out, out.abs().amax(dim=(1, 2, 3))


def pair_pack(index, strides, B, n, mode, p, R):
    """The launchers' int64 argument array (csrc/gray_scott_pointwise.cu
    ``launch``; K15's reads the same slots): device, the pointers s, w, r,
    g, dt, out, gmax and the workspace (filled in by each call), the
    batch, species and row strides of s, w, r, g and out (0 for an operand
    the call does not read), B, n, the mode (its index in GS_MODES or
    BURGERS_MODES), the plan (vector width, TX, TY, units a block, grid),
    the rows R of a lane (n, or a slab's) and the halo rows' pointers
    above and below, then K15's of w above and below (filled in by a halo
    call)."""
    return array.array("q", (index, *(0,) * 8, *strides, B, n, mode, *p, R, 0, 0, 0, 0))


# the facts a pair call is checked on, in ``_pair_checked``'s order
PAIR_FACTS = ("s", "out", "dt", "r", "w", "g", "above", "below", "w_above", "w_below")


@functools.lru_cache(maxsize=1024)
def _pair_checked(name, mode, facts):
    """Every check of a K14 (``name`` "gray_scott_pointwise") or K15 call,
    on the mode and the ``fact``s of ``PAIR_FACTS`` (None where not
    given), cached by them; returns (on the CPU, the launch: the argument
    array without pointers, the launcher, the device index and the
    residual max's (length, dtype, device); None on the CPU or with no
    states).  An operand the mode does not read (w in the residual, r in
    the Jacobian) is checked as the others and left alone."""
    modes = GS_MODES if name == "gray_scott_pointwise" else BURGERS_MODES
    if mode not in modes:
        _require(False, name, f"mode must be one of {modes}")
    keys = [k for k, f in zip(PAIR_FACTS, facts) if f is not None]
    given = [f for f in facts if f is not None]
    _check_facts(name, given, keys.__getitem__)
    f = dict(zip(keys, given))
    dtype, device, shape, _ = f["s"]
    if not (len(shape) == 4 and shape[1] == 2):
        _require(False, name, f"s has shape {tuple(shape)}, expected (B, 2, n, n) or a slab "
                              "(B, 2, R, n)")
    B, R, n = shape[0], shape[2], shape[3]
    halo = "above" in f
    _square(name, "s", shape, "(B, 2, n, n)", mode, halo)
    for key in keys:
        if key not in ("dt", "above", "below", "w_above", "w_below") and f[key][2] != shape:
            _require(False, name, f"{key} has shape {tuple(f[key][2])}, expected {tuple(shape)}")
    if halo != ("below" in f) or ("w_above" in f) != ("w_below" in f):
        _require(False, name, "a halo is a pair of rows (above, below)")
    if "w_above" in f and not (name == "burgers2d_pointwise" and mode == "jacobian" and halo):
        _require(False, name, "w's halo belongs to K15's Jacobian on a slab (with s's)")
    if name == "burgers2d_pointwise" and mode == "jacobian" and halo and "w_above" not in f:
        _require(False, name, "the Jacobian on a slab needs w's halo rows too")
    _halo_shapes(name, f, mode, (B, 2), n, halo)
    if not (tuple(f["dt"][2]) == (B,) and _contiguous(*f["dt"][2:])):
        _require(False, name, f"dt must be a contiguous ({B},) tensor")
    if mode == "residual" and "r" not in f:
        _require(False, name, "the residual mode needs r")
    if mode == "jacobian" and "w" not in f:
        _require(False, name, "the jacobian mode needs w")
    if "g" in f and mode != "expl":
        _require(False, name, "g is added to EXPL steps only")
    if mode == "residual" and (n == 0 or R == 0) and B:
        _require(False, name, "the residual's max needs states of side n >= 1")
    if device.type == "cpu" or B == 0 or n == 0 or R == 0:
        return device.type == "cpu", None
    reads = {"s", "out", {"residual": "r", "jacobian": "w", "expl": "g"}.get(mode)}
    strides = [st for key in PAIR_KEYS
               for st in (f[key][3][:3] if key in f and key in reads else (0, 0, 0))]
    p = plan(B, n, dtype.itemsize, strides, _build.sm_count(device.index), R)
    args = pair_pack(device.index, strides, B, n, modes.index(mode), p, R)
    return False, (args, _launcher("pm_" + name, dtype), device.index, (B, dtype, device))


def _pair_launch(name, launch, mode, s, out, dt, r, w, g, scalars, halo=None, w_halo=None):
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
    for slot, rows in ((33, halo), (35, w_halo)):
        if rows is not None:
            args[slot], args[slot + 1] = rows[0].data_ptr(), rows[1].data_ptr()
    status = fn(args.buffer_info()[0], *scalars, stream)
    if status and mode == "residual":
        _WORKSPACE.pop((index, stream), None)   # the failed launch may have left slots set
    _build.check(status, name)
    return (out, gmax) if mode == "residual" else out


def _pair_facts(ops, halo=None, w_halo=None):
    rows = tuple(halo or (None, None)) + tuple(w_halo or (None, None))
    return tuple(None if t is None else fact(t) for t in tuple(ops) + rows)


def gray_scott_pointwise(mode, s, out, dt, du, dv, a, b, dx2, r=None, w=None, g=None,
                         halo=None):
    """One fused stencil + reaction pass over B Gray-Scott pairs (u, v).

    mode "expl" (the EXPL step, out = [g +] step), "residual" (the Newton
    residual g = s - dt (D L s + R(s)) - r; returns (out, (B,) max |g| over
    both species with NaN where g holds a NaN)), "jacobian" (the Jacobian
    at s applied to w) or "prologue" (IMEX's s + dt R(s), pointwise).  s,
    r, w, g, out: (B, 2, n, n) views with contiguous rows, or a space
    shard's (B, 2, R, n) slabs with ``halo`` = (above, below), contiguous
    (B, 2, n) rows of L's operand (s, or w in the Jacobian) past the slab's
    first and last row; dt: contiguous (B,) tensor; du, dv, a, b, dx2 =
    dx^2 floats.  out must not overlap the inputs.  Returns out (or the
    pair).
    """
    on_cpu, launch = _pair_checked("gray_scott_pointwise", mode,
                                   _pair_facts((s, out, dt, r, w, g), halo))
    if on_cpu:
        return gray_scott_pointwise_plain(mode, s, out, dt, du, dv, a, b, dx2, r, w, g, halo)
    if launch is None:
        return (out, torch.empty(s.shape[:1], dtype=s.dtype, device=s.device)
                if mode == "residual" else out)
    res = _pair_launch("gray_scott_pointwise", launch, mode, s, out, dt, r, w, g,
                       (float(du), float(dv), float(a), float(b), float(dx2)), halo)
    gray_scott_pointwise.launches += 1
    gray_scott_pointwise.mode_launches[_mode_key(mode, halo)] += 1
    return res


gray_scott_pointwise.launches = 0
gray_scott_pointwise.mode_launches = {"whole": 0, "halo": 0, "prologue": 0}   # launches by mode


def burgers2d_pointwise(mode, s, out, dt, nu, dx, r=None, w=None, halo=None, w_halo=None):
    """One fused stencil pass over B periodic 2D Burgers velocity fields.

    mode "residual" (the Newton residual g = s - r + dt (C(s) - nu L s);
    returns (out, (B,) max |g| over both components, NaN where g holds a
    NaN)) or "jacobian" (the linearised convection and viscosity at s
    applied to w).  s, r, w, out: (B, 2, n, n) views with contiguous rows,
    or a space shard's (B, 2, R, n) slabs with ``halo`` = (above, below),
    contiguous (B, 2, n) rows of s past the slab's first and last row, and
    in the Jacobian ``w_halo``, w's; dt: contiguous (B,) tensor; nu, dx
    floats.  out must not overlap the inputs.  Returns out (or the pair).
    """
    on_cpu, launch = _pair_checked("burgers2d_pointwise", mode,
                                   _pair_facts((s, out, dt, r, w, None), halo, w_halo))
    if on_cpu:
        return burgers2d_pointwise_plain(mode, s, out, dt, nu, dx, r, w, halo, w_halo)
    if launch is None:
        return (out, torch.empty(s.shape[:1], dtype=s.dtype, device=s.device)
                if mode == "residual" else out)
    res = _pair_launch("burgers2d_pointwise", launch, mode, s, out, dt, r, w, None,
                       (float(nu), 2 * float(dx), float(dx) ** 2), halo, w_halo)
    burgers2d_pointwise.launches += 1
    burgers2d_pointwise.mode_launches[_mode_key(mode, halo)] += 1
    return res


burgers2d_pointwise.launches = 0
burgers2d_pointwise.mode_launches = {"whole": 0, "halo": 0}   # launches by mode
