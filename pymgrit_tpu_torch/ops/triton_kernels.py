"""Kernel K13 ``rk4_brusselator`` (Triton) beside its plain PyTorch
version: the Brusselator's RK4 chain.  (Every other kernel of the port is
CUDA C++ under ``csrc/``; the periodic stencils K11, K14 and K15 have
their wrappers in ``pointwise``.)

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the Triton kernel or raise.  ``triton`` is imported on the
first launch (the CPU tests import this module without it); the kernel
body below is a plain function until ``_jit()`` compiles it, and the
``tl`` name it uses is bound then.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _require
from pymgrit_tpu_torch.ops.runge_kutta import rk4_step

tl = None            # triton.language, bound by _jit() on first launch
_JIT = {}            # kernel name -> triton.JITFunction
_COEF_CACHE = {}     # (coeffs, dtype, device) -> coefficient tensor


def _rk4_brusselator_body(x_ptr, out_ptr, g_ptr, tp_ptr, tc_ptr, c_ptr, x_sj, o_sj, o_sk,
                          g_sj, g_sk, J, L, HAS_G: tl.constexpr, BLOCK: tl.constexpr):
    # J chains of L classic RK4 steps of the Brusselator, one lane per
    # element: y' = (a + x^2 y - (b+1) x, b x - x^2 y); c_ptr holds (a, b,
    # b+1); tp, tc: (L, J) step times.  out[:, k] = [g[:, k] +] step.
    lane = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = lane < J
    ln = lane.to(tl.int64)
    a = tl.load(c_ptr)
    bb = tl.load(c_ptr + 1)
    b1 = tl.load(c_ptr + 2)
    y0 = tl.load(x_ptr + ln * x_sj, mask=mask, other=0.0)
    y1 = tl.load(x_ptr + ln * x_sj + 1, mask=mask, other=0.0)
    for k in range(L):
        dt = (tl.load(tc_ptr + k * J + ln, mask=mask, other=0.0)
              - tl.load(tp_ptr + k * J + ln, mask=mask, other=0.0))
        h2 = dt / 2
        q = y0 * y0
        k1a = (a + q * y1) - b1 * y0
        k1b = bb * y0 - q * y1
        s0 = y0 + h2 * k1a
        s1 = y1 + h2 * k1b
        q = s0 * s0
        k2a = (a + q * s1) - b1 * s0
        k2b = bb * s0 - q * s1
        s0 = y0 + h2 * k2a
        s1 = y1 + h2 * k2b
        q = s0 * s0
        k3a = (a + q * s1) - b1 * s0
        k3b = bb * s0 - q * s1
        s0 = y0 + dt * k3a
        s1 = y1 + dt * k3b
        q = s0 * s0
        k4a = (a + q * s1) - b1 * s0
        k4b = bb * s0 - q * s1
        h6 = dt / 6
        y0 = y0 + h6 * (((k1a + 2 * k2a) + 2 * k3a) + k4a)
        y1 = y1 + h6 * (((k1b + 2 * k2b) + 2 * k3b) + k4b)
        if HAS_G:
            y0 = tl.load(g_ptr + ln * g_sj + k * g_sk, mask=mask, other=0.0) + y0
            y1 = tl.load(g_ptr + ln * g_sj + k * g_sk + 1, mask=mask, other=0.0) + y1
        tl.store(out_ptr + ln * o_sj + k * o_sk, y0, mask=mask)
        tl.store(out_ptr + ln * o_sj + k * o_sk + 1, y1, mask=mask)


def _jit():
    """Import triton and compile-wrap the kernel body (once)."""
    global tl
    if not _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT["rk4_brusselator"] = triton.jit(_rk4_brusselator_body)
    return _JIT


def _coefficients(coeffs, dtype, device):
    """The kernel's float scalars as a device tensor (Triton types a Python
    float argument as float32), made once per values, dtype and device."""
    key = (tuple(float(c) for c in coeffs), dtype, device)
    c = _COEF_CACHE.get(key)
    if c is None:
        c = _COEF_CACHE[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return c


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
    """J chains of L classic RK4 steps (``ops.runge_kutta.rk4_step``)."""
    f = brusselator_f(a, b)
    x = seed
    for k in range(out.shape[1]):
        x = rk4_step(f, x, tp[k], tc[k])
        if g is not None:
            x = g[:, k] + x
        out[:, k] = x
    return out


def rk4_brusselator(seed, tp, tc, out, g=None, a=1.0, b=3.0):
    """Chained RK4 steps of the Brusselator, every step written.

    seed: (J, 2) states; tp, tc: contiguous (L, J) step start and end
    times; out, g: (J, L, 2) views (g optional, added after each step).
    out must not overlap seed or g.  Returns out.
    """
    name = "rk4_brusselator"
    ops = dict(seed=seed, tp=tp, tc=tc, out=out)
    if g is not None:
        ops["g"] = g
    _check_operands(name, ops)
    _require(seed.dim() == 2 and seed.shape[1] == 2, name,
             f"seed has shape {tuple(seed.shape)}, expected (J, 2)")
    J = seed.shape[0]
    _require(out.dim() == 3 and out.shape[0] == J and out.shape[2] == 2, name,
             f"out has shape {tuple(out.shape)}, expected ({J}, L, 2)")
    L = out.shape[1]
    _require(g is None or g.shape == out.shape, name, "g must have the shape of out")
    _require(tuple(tp.shape) == (L, J) and tp.shape == tc.shape and tp.is_contiguous()
             and tc.is_contiguous(), name, f"tp and tc must be contiguous ({L}, {J}) tensors")
    if seed.device.type == "cpu":
        return rk4_brusselator_plain(seed, tp, tc, out, g, a, b)
    if J == 0 or L == 0:
        return out
    c = _coefficients((a, b, b + 1), seed.dtype, seed.device)
    block = 128
    with torch.cuda.device(seed.device):
        _jit()["rk4_brusselator"][(-(-J // block),)](
            seed, out, g if g is not None else out, tp, tc, c, seed.stride(0), out.stride(0),
            out.stride(1), g.stride(0) if g is not None else 0, g.stride(1) if g is not None else 0,
            J, L, HAS_G=g is not None, BLOCK=block, num_warps=4)
    rk4_brusselator.launches += 1
    return out


rk4_brusselator.launches = 0
