"""Kernel K7 ``theta_rhs2d`` (CUDA C++, ``csrc/theta_rhs2d.cu``) beside its
plain PyTorch version.

K7 replaces the stencil part of the physical-basis heat step in
pymgrit_tpu/models/heat_2d.py (``Heat2D.step`` and ``step_batched``): it
assembles the right-hand side of the implicit solve (BE, CN), or computes
the whole explicit step (FE), in one pass over the state: a 5-point stencil
and elementwise work, bound by the bytes of the state read and written.  It
runs before every physical step's K5 solve, mostly at the coarse levels'
small batches, where a launch costs host time more than device time; so the
wrapper keeps host time down as K3's does (``row_norms``): its checks and
the launcher's argument array are cached by the operands' dtype, device,
shapes and strides (``_checked``), and a launch is one ctypes call with the
array's address (its pointer slots filled in), the four scalars and the
stream.  The kernel rounds each operation of the plain version once, in
its order, so the two agree bit for bit.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import array
import functools

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import _check_facts, _contiguous, _launcher, _require, fact

MODES = {"BE": 0, "CN": 1, "FE": 2}


def _apply_L_interior(u, fx, fy):
    """The 5-point operator on the interior rows of full states (..., P, Q)."""
    return (2 * (fx + fy) * u[..., 1:-1, 1:-1]
            - fy * u[..., 1:-1, :-2] - fy * u[..., 1:-1, 2:]
            - fx * u[..., :-2, 1:-1] - fx * u[..., 2:, 1:-1])


def theta_rhs2d_plain(u, out, dt, theta, fx, fy, rhs1, rhs0, lift=None, ring=None, g=None):
    """BE / CN: out = the interior right-hand side of the implicit solve;
    FE: out = the whole explicit step [+ g] (expression order of
    ``pymgrit_tpu/models/heat_2d.py`` ``Heat2D.step`` / ``step_batched``)."""
    B, P, Q = u.shape
    d = dt if not isinstance(dt, torch.Tensor) else dt.view(B, 1, 1)
    if theta == 0.0:
        r0 = rhs0.reshape(B, P - 2, Q - 2)
        lu = torch.zeros_like(u)
        lu[:, 1:-1, 1:-1] = _apply_L_interior(u, fx, fy)
        v = ring + u - d * lu
        v[:, 1:-1, 1:-1] += d * r0
    else:
        u_int = u[:, 1:-1, 1:-1]
        r1 = rhs1.reshape(B, P - 2, Q - 2)
        shift = d * theta
        if theta == 1.0:
            v = u_int + d * r1 + shift * lift
        else:
            r0 = rhs0.reshape(B, P - 2, Q - 2)
            v = (u_int - shift * _apply_L_interior(u, fx, fy)) \
                + d * (theta * r1 + (1 - theta) * r0) + shift * lift
    out.copy_(v if g is None else g + v)
    return out


# theta_rhs2d's operands in the order of its argument array's pointer
# slots 1-8 (csrc/theta_rhs2d.cu ``launch``)
_KEYS = ("u", "out", "rhs1", "rhs0", "lift", "ring", "g", "dt")


def pack(index, us, os, r_sb, gs, B, P, Q, mode):
    """The launcher's int64 argument array (csrc/theta_rhs2d.cu ``launch``):
    device, eight operand pointers (filled in by each call), u's and out's
    batch and row strides, the rhs rows' batch stride, g's batch and row
    strides, B, P, Q, the mode (0 BE, 1 CN, 2 FE)."""
    return array.array("q", (index, *(0,) * 8, *us, *os, r_sb, *gs, B, P, Q, mode))


@functools.lru_cache(maxsize=1024)
def _checked(facts, present, theta):
    """Every check of a K7 call, on the ``fact``s of the operands given
    (``present``: which of ``_KEYS``) and theta, cached by them (K7 runs
    before every physical step's solve: 791 times a TOMS solve); returns
    (on the CPU, the launch: the argument array without pointers, the
    launcher, the device index; None on the CPU or with no states)."""
    name = "theta_rhs2d"
    keys = [k for k, p in zip(_KEYS, present) if p]
    _check_facts(name, facts, keys.__getitem__)
    f = dict(zip(keys, facts))
    dtype, device, ushape, ustride = f["u"]
    if len(ushape) != 3:
        _require(False, name, f"u has shape {tuple(ushape)}, expected (B, P, Q)")
    B, P, Q = ushape
    if P < 3 or Q < 3:
        _require(False, name, "states need an interior")
    fe = theta == 0.0
    shape = (B, P, Q) if fe else (B, P - 2, Q - 2)
    if tuple(f["out"][2]) != shape:
        _require(False, name, f"out has shape {tuple(f['out'][2])}, expected {shape}")
    if "g" in f and not (fe and tuple(f["g"][2]) == shape):
        _require(False, name, "g is added to FE steps only, and must have the shape of out")
    N = (P - 2) * (Q - 2)
    if not (tuple(f["rhs1"][2]) == (B, N) and f["rhs0"][2] == f["rhs1"][2]
            and f["rhs0"][3] == f["rhs1"][3]):
        _require(False, name, f"rhs1 and rhs0 must be ({B}, {N}) views with equal strides")
    if not 0.0 <= theta <= 1.0:
        _require(False, name, "theta must lie in [0, 1]")
    if fe and not ("ring" in f and tuple(f["ring"][2]) == (P, Q) and _contiguous(*f["ring"][2:])):
        _require(False, name, f"FE needs a contiguous ({P}, {Q}) ring field")
    if not fe and not ("lift" in f and tuple(f["lift"][2]) == (P - 2, Q - 2)
                       and _contiguous(*f["lift"][2:])):
        _require(False, name, f"BE/CN need a contiguous ({P - 2}, {Q - 2}) lift")
    if "dt" in f and not (tuple(f["dt"][2]) == (B,) and _contiguous(*f["dt"][2:])):
        _require(False, name, f"a dt tensor must be a contiguous ({B},) vector")
    if device.type == "cpu" or B == 0:
        return device.type == "cpu", None
    mode = 2 if fe else 0 if theta == 1.0 else 1
    gs = f["g"][3][:2] if "g" in f else (0, 0)
    args = pack(device.index, ustride[:2], f["out"][3][:2], f["rhs1"][3][0], gs, B, P, Q, mode)
    return False, (args, _launcher("pm_theta_rhs2d", dtype), device.index)


def theta_rhs2d(u, out, dt, theta, fx, fy, rhs1, rhs0, lift=None, ring=None, g=None):
    """The stencil pass of one physical theta-step of B states.

    u: (B, P, Q) full states (views, last axis contiguous); theta 1 (BE) or
    in (0, 1) (CN): out is the (B, P - 2, Q - 2) right-hand side
    u_int - theta'*dt*(L u)_int + dt*(rhs mix) + theta*dt*lift, with lift the
    (P - 2, Q - 2) bc coupling; theta 0 (FE): out is the (B, P, Q) step
    ring + u - dt*L u + dt*rhs0 [+ g], ring the (P, Q) bc field.  rhs1, rhs0:
    (B, (P - 2)(Q - 2)) row views of the rhs at the step's end and start
    (batch stride 0 for a time-independent rhs); dt: float or (B,) tensor;
    g: FE only (BE/CN add g after the solve).  out must not overlap u.
    Returns out.
    """
    dt_t = dt if isinstance(dt, torch.Tensor) else None
    ops = (u, out, rhs1, rhs0, lift, ring, g, dt_t)
    on_cpu, launch = _checked(tuple(fact(t) for t in ops if t is not None),
                              tuple(t is not None for t in ops), float(theta))
    if on_cpu:
        return theta_rhs2d_plain(u, out, dt, theta, fx, fy, rhs1, rhs0, lift, ring, g)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    for k, t in enumerate(ops):
        if t is not None:
            args[1 + k] = t.data_ptr()
    _build.check(fn(args.buffer_info()[0], 0.0 if dt_t is not None else float(dt), float(theta),
                    float(fx), float(fy), _build.stream(index)), "theta_rhs2d")
    theta_rhs2d.launches += 1
    return out


theta_rhs2d.launches = 0
