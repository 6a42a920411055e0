"""Runge-Kutta integrators on batches of lanes, and kernels K12
``dopri45_arenstorf`` (``csrc/dopri45_arenstorf.cu``) and K13
``rk4_brusselator`` (``csrc/rk4_brusselator.cu``), both CUDA C++, beside
their plain versions.

Counterpart of ``pymgrit_tpu/ops/runge_kutta.py``: classic RK4 and the
adaptive Dormand-Prince 5(4) pair with scipy's RK45 controller (safety 0.9,
factor clamp [0.2, 10], error exponent -1/5, RMS error norm with scale
atol + rtol max(|y0|, |y1|), Hairer's initial step, after a rejection the
next growth is capped at 1, ``max_steps`` counts attempts).  Every function
here takes a batch of lanes, (B, d) states and (B,) times, and masks lanes
as the JAX package's ``vmap``-ed ``lax.while_loop`` does: every lane runs
the attempt, a lane that is done keeps its state.  Each call restarts the
controller with a fresh initial step; no step size carries over.

K12 runs the whole adaptive loop of one Arenstorf lane in one thread
(replaces ``dopri45_integrate`` composed with
pymgrit_tpu/models/arenstorf_orbit.py ``ArenstorfOrbit._f``), for J lanes
of L chained steps in one launch.  K13 runs J chains of L classic RK4
steps of the Brusselator (replaces ``rk4_step`` composed with
pymgrit_tpu/models/brusselator.py ``Brusselator._f``), one thread a lane.
Both take the one-call launch path: the checks and packed argument array
are cached by the operands' facts (``_dopri_checked``, ``_rk4_checked``).

The plain versions take the correctly rounded ``ieee_sqrt.sqrt_rn`` and
divide by tensors where the JAX package divides (``_sixth``,
``_initial_step``); ``**`` is PyTorch's pow, which differs from XLA's in
the last bit or two (in 2.3 % of the float64 results of ``x ** 0.2`` on
10^5 random x, on the CPU).
"""

from __future__ import annotations

import array
import functools
import struct

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import (_check_facts, _contiguous, _launcher, _require,
                                                fact)
from pymgrit_tpu_torch.ops.ieee_sqrt import sqrt_rn

# Dormand-Prince 5(4) tableau (the pair of scipy.integrate.RK45)
_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
# error weights b5 - b4, with the FSAL stage k7
_E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40)

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ERR_EXP = -1.0 / 5.0
MAX_STEPS = 10_000


def _sixth(dt):
    """dt / 6, divided by a 0-d tensor on dt's device: PyTorch's CUDA
    division by a Python scalar multiplies by its rounded reciprocal, where
    the JAX package (and K13) divides."""
    return dt / torch.full((), 6.0, dtype=dt.dtype, device=dt.device)


def rk4_step(f, y, t0, t1):
    """One classic RK4 step of every lane: y (B, d), t0, t1 (B,)."""
    dt = (t1 - t0)[:, None]
    k1 = f(t0, y)
    k2 = f(t0 + dt[:, 0] / 2, y + dt / 2 * k1)
    k3 = f(t0 + dt[:, 0] / 2, y + dt / 2 * k2)
    k4 = f(t0 + dt[:, 0], y + dt * k3)
    return y + _sixth(dt) * (k1 + 2 * k2 + 2 * k3 + k4)


def _rms(x):
    return sqrt_rn(torch.mean(torch.square(x), dim=1))


def _hundredth_over(d):
    """0.01 / d, divided by a 0-d tensor on d's device: PyTorch computes a
    Python scalar over a tensor as reciprocal() * 0.01, where the JAX
    package (and K12) divides."""
    return torch.full((), 0.01, dtype=d.dtype, device=d.device) / d


def _initial_step(f, t0, y0, f0, rtol, atol):
    """Hairer's initial step of every lane (scipy _ivp/common.py)."""
    scale = atol + torch.abs(y0) * rtol
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    y1 = y0 + h0[:, None] * f0
    f1 = f(t0 + h0, y1)
    d2 = _rms((f1 - f0) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15),
                     torch.clamp_min(h0 * 1e-3, 1e-6),
                     _hundredth_over(torch.maximum(d1, d2)) ** 0.2)
    return torch.minimum(100 * h0, h1)


def _attempt(f, t, y, fy, h, rtol, atol):
    """One Dormand-Prince attempt of step h from (t, y) with f(t, y) = fy:
    (y_new, f(t + h, y_new), RMS error norm)."""
    hc = h[:, None]
    ks = [fy]
    for i in range(1, 6):
        dy = torch.zeros_like(y)
        for j in range(i):
            dy = dy + _A[i][j] * ks[j]
        ks.append(f(t + _C[i] * h, y + hc * dy))
    dy5 = torch.zeros_like(y)
    for j in range(6):
        dy5 = dy5 + _B[j] * ks[j]
    y_new = y + hc * dy5
    f_new = f(t + h, y_new)
    ks.append(f_new)
    err = torch.zeros_like(y)
    for j in range(7):
        err = err + _E[j] * ks[j]
    err = err * hc
    scale = atol + torch.maximum(torch.abs(y), torch.abs(y_new)) * rtol
    return y_new, f_new, _rms(err / scale)


def dopri45_integrate(f, y0, t0, t1, rtol=1e-3, atol=1e-6, max_steps=MAX_STEPS):
    """Integrate y' = f(t, y) adaptively from t0 to t1 > t0, every lane.

    y0: (B, d); t0, t1: (B,).  Returns (y, attempts, rejections), the two
    counts (B,) int64 tensors.
    """
    f0 = f(t0, y0)
    h_abs = torch.minimum(_initial_step(f, t0, y0, f0, rtol, atol), t1 - t0)
    t, y, fy = t0, y0, f0
    n = torch.zeros(t0.shape, dtype=torch.int64, device=t0.device)
    rej = torch.zeros_like(n)
    rejected = torch.zeros(t0.shape, dtype=torch.bool, device=t0.device)
    active = (t < t1) & (n < max_steps)
    while bool(active.any()):
        h = torch.minimum(h_abs, t1 - t)
        y_new, f_new, err = _attempt(f, t, y, fy, h, rtol, atol)
        accept = err < 1.0
        grow = _SAFETY * err ** _ERR_EXP
        factor_acc = torch.where(err == 0.0, _MAX_FACTOR, torch.clamp_max(grow, _MAX_FACTOR))
        factor_acc = torch.where(rejected, torch.clamp_max(factor_acc, 1.0), factor_acc)
        factor_rej = torch.clamp_min(grow, _MIN_FACTOR)
        h_new = torch.where(accept, h_abs * factor_acc, h_abs * factor_rej)
        take = active & accept
        t = torch.where(take, t + h, t)
        y = torch.where(take[:, None], y_new, y)
        fy = torch.where(take[:, None], f_new, fy)
        h_abs = torch.where(active, h_new, h_abs)
        rejected = torch.where(active, ~accept, rejected)
        n = n + active
        rej = rej + (active & ~accept)
        active = (t < t1) & (n < max_steps)
    return y, n, rej


# ---------------------------------------------------------------------------
# K12 dopri45_arenstorf
# ---------------------------------------------------------------------------

ARENSTORF_A = 0.012277471


def _double_bits(v: float) -> int:
    return struct.unpack("<q", struct.pack("<d", v))[0]


def arenstorf_f(a=ARENSTORF_A):
    """The restricted three-body right-hand side on (B, 4) states
    (expression order of pymgrit_tpu/models/arenstorf_orbit.py ``_f``)."""
    b = 1 - a

    def f(t, y):
        y0, y1, y2, y3 = y.unbind(1)
        d1 = ((y0 + a) ** 2 + y1 ** 2) ** 1.5
        d2 = ((y0 - b) ** 2 + y1 ** 2) ** 1.5
        return torch.stack([y2, y3,
                            y0 + 2 * y3 - b * (y0 + a) / d1 - a * (y0 - b) / d2,
                            y1 - 2 * y2 - b * y1 / d1 - a * y1 / d2], 1)
    return f


def dopri45_arenstorf_plain(seed, tp, tc, out, g=None, rtol=1e-3, atol=1e-6, a=ARENSTORF_A,
                            max_steps=MAX_STEPS, attempts=None):
    """J chains of L adaptive Arenstorf steps (``dopri45_integrate``);
    attempts (L, J) int32 receives each step's attempt count."""
    f = arenstorf_f(a)
    x = seed
    for k in range(out.shape[1]):
        x, n, _ = dopri45_integrate(f, x, tp[k], tc[k], rtol, atol, max_steps)
        if attempts is not None:
            attempts[k] = n
        if g is not None:
            x = g[:, k] + x
        out[:, k] = x
    return out


def dopri45_arenstorf_pack(index, strides, J, L, max_steps, rtol, atol, a):
    """The launcher's int64 argument array (csrc/dopri45_arenstorf.cu
    ``launch``): device, six pointers (filled in by each call: seed, tp,
    tc, out, g, attempts; 0 for an absent g or attempts), the strides
    (seed's lane stride, out's lane and step strides, g's lane and step
    strides), J, L, max_steps and the bits of rtol, atol and a as doubles."""
    return array.array("q", (index, *(0,) * 6, *strides, J, L, max_steps,
                             *map(_double_bits, (rtol, atol, a))))


# dopri45_arenstorf's operands in the order of their facts (g and attempts
# are None where absent)
_DOPRI_KEYS = ("seed", "tp", "tc", "out", "g", "attempts")


@functools.lru_cache(maxsize=1024)
def _dopri_checked(facts, rtol, atol, a, max_steps):
    """Every check of a K12 call, on the ``fact``s of seed, tp, tc, out, g
    and attempts (None where absent) and the scalars, cached by them (K12
    runs at every F- and C-relaxation and coarsest march of an Arenstorf
    solve); returns (on the CPU, the launch: the argument array without
    pointers, the launcher and the device index; None on the CPU or with
    nothing to do)."""
    name = "dopri45_arenstorf"
    *floats, fatt = facts
    present = [(k, f) for k, f in zip(_DOPRI_KEYS, floats) if f is not None]
    _check_facts(name, [f for _, f in present], [k for k, _ in present].__getitem__)
    (dtype, device, sshape, sstride), tpf, tcf, (_, _, oshape, ostride), fg = floats
    if not (len(sshape) == 2 and sshape[1] == 4):
        _require(False, name, f"seed has shape {tuple(sshape)}, expected (J, 4)")
    J = sshape[0]
    if not (len(oshape) == 3 and oshape[0] == J and oshape[2] == 4):
        _require(False, name, f"out has shape {tuple(oshape)}, expected ({J}, L, 4)")
    L = oshape[1]
    if fg is not None and fg[2] != oshape:
        _require(False, name, "g must have the shape of out")
    if not (tuple(tpf[2]) == (L, J) and tcf[2] == tpf[2] and _contiguous(*tpf[2:])
            and _contiguous(*tcf[2:])):
        _require(False, name, f"tp and tc must be contiguous ({L}, {J}) tensors")
    if fatt is not None and not (tuple(fatt[2]) == (L, J) and _contiguous(*fatt[2:])
                                 and fatt[0] == torch.int32 and fatt[1] == device):
        _require(False, name, f"attempts must be a contiguous ({L}, {J}) int32 tensor on {device}")
    if not 0 <= max_steps <= 0x7fffffff:
        _require(False, name, f"max_steps = {max_steps} must lie in [0, 2^31)")
    if device.type == "cpu" or J * L == 0:
        return device.type == "cpu", None
    gs = fg[3][:2] if fg is not None else (0, 0)
    args = dopri45_arenstorf_pack(device.index, (sstride[0], *ostride[:2], *gs), J, L, max_steps,
                                  rtol, atol, a)
    return False, (args, _launcher("pm_dopri45_arenstorf", dtype), device.index)


def dopri45_arenstorf(seed, tp, tc, out, g=None, rtol=1e-3, atol=1e-6, a=ARENSTORF_A,
                      max_steps=MAX_STEPS, attempts=None):
    """Chained adaptive DOPRI5(4) steps of the Arenstorf orbit, every step
    written: out[:, k] = [g[:, k] +] integrate(out[:, k-1], tp[k], tc[k]).

    seed: (J, 4) states; tp, tc: contiguous (L, J) step times; out, g:
    (J, L, 4) views (g optional); attempts: optional contiguous (L, J) int32
    tensor that receives the attempt count of every lane and step.  out
    must not overlap seed or g.  Returns out.

    The checks and the packed argument array are cached by the operands'
    facts and the scalars (``_dopri_checked``); a call on the card fills in
    the pointers and makes one ctypes call.
    """
    facts = tuple(None if t is None else fact(t) for t in (seed, tp, tc, out, g, attempts))
    on_cpu, launch = _dopri_checked(facts, float(rtol), float(atol), float(a), int(max_steps))
    if on_cpu:
        return dopri45_arenstorf_plain(seed, tp, tc, out, g, rtol, atol, a, max_steps, attempts)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1], args[2], args[3], args[4] = seed.data_ptr(), tp.data_ptr(), tc.data_ptr(), \
        out.data_ptr()
    if g is not None:
        args[5] = g.data_ptr()
    if attempts is not None:
        args[6] = attempts.data_ptr()
    _build.check(fn(args.buffer_info()[0], _build.stream(index)), "dopri45_arenstorf")
    dopri45_arenstorf.launches += 1
    return out


dopri45_arenstorf.launches = 0


# ---------------------------------------------------------------------------
# K13 rk4_brusselator
# ---------------------------------------------------------------------------


def brusselator_f(a, b):
    """The Brusselator right-hand side on (B, 2) states (expression order
    of pymgrit_tpu/models/brusselator.py ``Brusselator._f``)."""
    def f(t, y):
        q = y[:, 0] ** 2
        return torch.stack([a + q * y[:, 1] - (b + 1) * y[:, 0], b * y[:, 0] - q * y[:, 1]], 1)
    return f


def rk4_brusselator_plain(seed, tp, tc, out, g=None, a=1.0, b=3.0):
    """J chains of L classic RK4 steps (``rk4_step``)."""
    f = brusselator_f(a, b)
    x = seed
    for k in range(out.shape[1]):
        x = rk4_step(f, x, tp[k], tc[k])
        if g is not None:
            x = g[:, k] + x
        out[:, k] = x
    return out


def rk4_brusselator_pack(index, strides, J, L, a, b):
    """The launcher's int64 argument array (csrc/rk4_brusselator.cu
    ``launch``): device, five pointers (filled in by each call: seed, tp,
    tc, out, g), the strides (seed's lane stride, out's lane and step
    strides, g's lane and step strides), J, L and the bits of a, b and
    b + 1 as doubles."""
    return array.array("q", (index, *(0,) * 5, *strides, J, L,
                             *map(_double_bits, (a, b, b + 1))))


# rk4_brusselator's operands in the order of their facts
_RK4_KEYS = ("seed", "tp", "tc", "out", "g")


@functools.lru_cache(maxsize=1024)
def _rk4_checked(facts, a, b):
    """Every check of a K13 call, on the ``fact``s of seed, tp, tc, out (and
    g), a and b, cached by them (K13 runs at every F- and C-relaxation and
    coarsest march of a Brusselator solve); returns (on the CPU, the launch:
    the argument array without pointers, the launcher and the device index;
    None on the CPU or with nothing to do)."""
    name = "rk4_brusselator"
    _check_facts(name, facts, _RK4_KEYS.__getitem__)
    (dtype, device, sshape, sstride), tpf, tcf, (_, _, oshape, ostride) = facts[:4]
    if not (len(sshape) == 2 and sshape[1] == 2):
        _require(False, name, f"seed has shape {tuple(sshape)}, expected (J, 2)")
    J = sshape[0]
    if not (len(oshape) == 3 and oshape[0] == J and oshape[2] == 2):
        _require(False, name, f"out has shape {tuple(oshape)}, expected ({J}, L, 2)")
    L = oshape[1]
    if len(facts) == 5 and facts[4][2] != oshape:
        _require(False, name, "g must have the shape of out")
    if not (tuple(tpf[2]) == (L, J) and tcf[2] == tpf[2] and _contiguous(*tpf[2:])
            and _contiguous(*tcf[2:])):
        _require(False, name, f"tp and tc must be contiguous ({L}, {J}) tensors")
    if device.type == "cpu" or J * L == 0:
        return device.type == "cpu", None
    gs = facts[4][3][:2] if len(facts) == 5 else (0, 0)
    args = rk4_brusselator_pack(device.index, (sstride[0], *ostride[:2], *gs), J, L, a, b)
    return False, (args, _launcher("pm_rk4_brusselator", dtype), device.index)


def rk4_brusselator(seed, tp, tc, out, g=None, a=1.0, b=3.0):
    """Chained RK4 steps of the Brusselator, every step written (K13).

    seed: (J, 2) states; tp, tc: contiguous (L, J) step start and end
    times; out, g: (J, L, 2) views (g optional, added after each step).
    out must not overlap seed or g.  Returns out.

    The checks and the packed argument array are cached by the operands'
    facts (``_rk4_checked``); a call on the card fills in the pointers and
    makes one ctypes call.
    """
    ops = (seed, tp, tc, out) if g is None else (seed, tp, tc, out, g)
    on_cpu, launch = _rk4_checked(tuple(map(fact, ops)), float(a), float(b))
    if on_cpu:
        return rk4_brusselator_plain(seed, tp, tc, out, g, a, b)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1], args[2], args[3], args[4] = seed.data_ptr(), tp.data_ptr(), tc.data_ptr(), \
        out.data_ptr()
    if g is not None:
        args[5] = g.data_ptr()
    _build.check(fn(args.buffer_info()[0], _build.stream(index)), "rk4_brusselator")
    rk4_brusselator.launches += 1
    return out


rk4_brusselator.launches = 0
