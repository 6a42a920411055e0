"""Kernels K4 ``cpoint_combine``, K7 ``theta_rhs2d``, K11
``allen_cahn_pointwise``, K13 ``rk4_brusselator``, K14
``gray_scott_pointwise`` and K15 ``burgers2d_pointwise`` (Triton), each
beside its plain PyTorch version.  (K3 ``residual_row_norms``, K18
``restrict_combine``, K19 ``interpolate_combine`` and K21
``indexed_combine`` are CUDA C++: ``csrc/residual_row_norms.cu``,
``csrc/restrict_combine.cu``, ``csrc/interpolate_combine.cu``,
``csrc/indexed_combine.cu``.)

K4 replaces the elementwise parts of the C-point phases in
pymgrit_tpu/core/solver.py: the weighted C update (``_c_relax``), the FAS
right-hand side ``g_tail`` (``_fas_residual``) and the coarse-grid
correction (``_error_correction``).  It is bound by the bytes it reads and
writes: up to four strided row views read and one written, one program per
(row, block of N), fused into one pass.
K7 replaces the stencil part of the physical-basis heat step in
pymgrit_tpu/models/heat_2d.py (``Heat2D.step`` and ``step_batched``): it
assembles the right-hand side of the implicit solve (BE, CN), or computes
the whole explicit step (FE), in one pass over the state: a 5-point stencil
and elementwise work, bound by the bytes of the state read and written.
K11, K14 and K15 are the same kind of pass for the periodic nonlinear
models (pymgrit_tpu/models/allen_cahn.py, gray_scott_2d.py, burgers.py):
the Newton residual with its per-lane max, the Jacobian matvec, and
(K14) the explicit Gray-Scott step; K14 and K15 hold both species of a
lane in one program.  K13 is the Brusselator's RK4 chain.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the Triton kernel or raise.  ``triton`` is imported on the
first launch (the CPU tests import this module without it); the kernel
bodies below are plain functions until ``_jit()`` compiles them, and the
``tl`` name they use is bound then.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _require
from pymgrit_tpu_torch.ops.periodic import ipow
from pymgrit_tpu_torch.ops.runge_kutta import rk4_step

tl = None            # triton.language, bound by _jit() on first launch
_JIT = {}            # kernel name -> triton.JITFunction
_COEF_CACHE = {}     # (coeffs, dtype, device) -> coefficient tensor

_BLOCK = 1024
MAX_TERMS = 4


def _combine_body(out_ptr, x0_ptr, x1_ptr, x2_ptr, x3_ptr, c_ptr, so, s0, s1, s2, s3,
                  N, NT: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    idx = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = idx < N
    acc = tl.load(c_ptr) * tl.load(x0_ptr + row * s0 + idx, mask=mask)
    if NT > 1:
        acc = acc + tl.load(c_ptr + 1) * tl.load(x1_ptr + row * s1 + idx, mask=mask)
    if NT > 2:
        acc = acc + tl.load(c_ptr + 2) * tl.load(x2_ptr + row * s2 + idx, mask=mask)
    if NT > 3:
        acc = acc + tl.load(c_ptr + 3) * tl.load(x3_ptr + row * s3 + idx, mask=mask)
    tl.store(out_ptr + row * so + idx, acc, mask=mask)


def _theta_rhs_body(u_ptr, out_ptr, r1_ptr, r0_ptr, lift_ptr, ring_ptr, g_ptr, dt_ptr, c_ptr,
                    u_sb, u_sr, o_sb, o_sr, r_sb, g_sb, g_sr, P, Q,
                    MODE: tl.constexpr, HAS_G: tl.constexpr, DT_TENSOR: tl.constexpr,
                    BLOCK: tl.constexpr):
    # MODE 0: BE, 1: CN -- out is the (P, Q) interior; 2: FE -- out is the
    # full (P, Q) state.  u is always the full state.  c_ptr holds
    # (dt, theta, fx, fy) in the working dtype (a float argument would be
    # rounded to float32).
    b = tl.program_id(0).to(tl.int64)
    idx = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = idx < P * Q
    i = idx // Q
    j = idx - i * Q
    if DT_TENSOR:
        d = tl.load(dt_ptr + b)
    else:
        d = tl.load(c_ptr)
    theta = tl.load(c_ptr + 1)
    fx = tl.load(c_ptr + 2)
    fy = tl.load(c_ptr + 3)
    if MODE == 2:
        inner = mask & (i > 0) & (i < P - 1) & (j > 0) & (j < Q - 1)
        uc_ptr = u_ptr + b * u_sb + i * u_sr + j
        uc = tl.load(uc_ptr, mask=mask, other=0.0)
        lu = (2 * (fx + fy) * uc - fy * tl.load(uc_ptr - 1, mask=inner, other=0.0)
              - fy * tl.load(uc_ptr + 1, mask=inner, other=0.0)
              - fx * tl.load(uc_ptr - u_sr, mask=inner, other=0.0)
              - fx * tl.load(uc_ptr + u_sr, mask=inner, other=0.0))
        r0 = tl.load(r0_ptr + b * r_sb + (i - 1) * (Q - 2) + (j - 1), mask=inner, other=0.0)
        ring = tl.load(ring_ptr + idx, mask=mask, other=0.0)
        # the reference adds the bc data onto the carried ring
        v = tl.where(inner, (uc - d * lu) + d * r0, ring + uc)
    else:
        uc_ptr = u_ptr + b * u_sb + (i + 1) * u_sr + (j + 1)
        uc = tl.load(uc_ptr, mask=mask, other=0.0)
        r1 = tl.load(r1_ptr + b * r_sb + idx, mask=mask, other=0.0)
        lift = tl.load(lift_ptr + idx, mask=mask, other=0.0)
        shift = d * theta
        if MODE == 0:
            v = uc + d * r1 + shift * lift
        else:
            lu = (2 * (fx + fy) * uc - fy * tl.load(uc_ptr - 1, mask=mask, other=0.0)
                  - fy * tl.load(uc_ptr + 1, mask=mask, other=0.0)
                  - fx * tl.load(uc_ptr - u_sr, mask=mask, other=0.0)
                  - fx * tl.load(uc_ptr + u_sr, mask=mask, other=0.0))
            r0 = tl.load(r0_ptr + b * r_sb + idx, mask=mask, other=0.0)
            v = (uc - shift * lu) + d * (theta * r1 + (1 - theta) * r0) + shift * lift
    if HAS_G:
        v = tl.load(g_ptr + b * g_sb + i * g_sr + j, mask=mask, other=0.0) + v
    tl.store(out_ptr + b * o_sb + i * o_sr + j, v, mask=mask)


def _allen_cahn_body(u_ptr, x_ptr, r_ptr, out_ptr, max_ptr, fac_ptr, c_ptr,
                     u_sb, u_sr, x_sb, x_sr, r_sb, r_sr, o_sb, o_sr, n, NBLK,
                     MODE: tl.constexpr, NU: tl.constexpr, BLOCK: tl.constexpr):
    # MODE 0: out = u + fac (L u + f(u))                (CN right-hand side)
    # MODE 1: out = u - fac (L u + f(u)) - r, with each program's max |out|
    #         (NaN if any entry is NaN) in max_ptr[b, block]
    # MODE 2: out = x - fac (L x + (1 - (NU+1) u^NU) x / eps^2)  (Jacobian)
    # f(u) = (u / eps^2)(1 - u^NU); L is the periodic 5-point Laplacian; c_ptr
    # holds (1 / eps^2, dx^2) in the working dtype; fac is per state.
    b = tl.program_id(0).to(tl.int64)
    blk = tl.program_id(1)
    idx = blk * BLOCK + tl.arange(0, BLOCK)
    mask = idx < n * n
    i = idx // n
    j = idx - i * n
    im = tl.where(i == 0, n - 1, i - 1)
    ip = tl.where(i == n - 1, 0, i + 1)
    jm = tl.where(j == 0, n - 1, j - 1)
    jp = tl.where(j == n - 1, 0, j + 1)
    fac = tl.load(fac_ptr + b)
    inv_eps2 = tl.load(c_ptr)
    dx2 = tl.load(c_ptr + 1)
    ub = u_ptr + b * u_sb
    u = tl.load(ub + i * u_sr + j, mask=mask, other=0.0)
    if MODE == 2:
        xb = x_ptr + b * x_sb
        xs = x_sr
        x = tl.load(xb + i * xs + j, mask=mask, other=0.0)
    else:
        xb = ub
        xs = u_sr
        x = u
    lap = ((((tl.load(xb + im * xs + j, mask=mask, other=0.0)
              + tl.load(xb + ip * xs + j, mask=mask, other=0.0))
             + tl.load(xb + i * xs + jm, mask=mask, other=0.0))
            + tl.load(xb + i * xs + jp, mask=mask, other=0.0)) - 4.0 * x) / dx2
    p = u
    for _ in tl.static_range(NU - 1):
        p = p * u
    if MODE == 2:
        v = x - fac * (lap + (inv_eps2 * (1.0 - (NU + 1) * p)) * x)
    else:
        f = (inv_eps2 * u) * (1.0 - p)
        if MODE == 0:
            v = u + fac * (lap + f)
        else:
            r = tl.load(r_ptr + b * r_sb + i * r_sr + j, mask=mask, other=0.0)
            v = (u - fac * (lap + f)) - r
            a = tl.where(mask, tl.abs(v), 0.0)
            # tl.max drops NaN; a sum of the NaN entries (0 where there are
            # none) adds it back, so a NaN lane reports NaN as jnp.max does
            nan = tl.sum(tl.where(mask & (v != v), v, 0.0), axis=0)
            tl.store(max_ptr + b * NBLK + blk, tl.max(a, axis=0) + nan)
    tl.store(out_ptr + b * o_sb + i * o_sr + j, v, mask=mask)


def _gray_scott_body(s_ptr, w_ptr, r_ptr, g_ptr, out_ptr, max_ptr, dt_ptr, c_ptr,
                     s_sb, s_ss, s_sr, w_sb, w_ss, w_sr, r_sb, r_ss, r_sr, g_sb, g_ss, g_sr,
                     o_sb, o_ss, o_sr, n, NBLK, MODE: tl.constexpr, HAS_G: tl.constexpr,
                     BLOCK: tl.constexpr):
    # Both species (u, v) of one lane's block of points.  D = diag(du, dv),
    # R(u, v) = (-u v^2 + a (1 - u), u v^2 - b v), L the periodic 5-point
    # Laplacian; c_ptr holds (du, dv, a, b, dx^2) in the working dtype.
    # MODE 0: out = s + dt (D L s + R(s)) [+ g]                (EXPL step)
    # MODE 1: out = (s - dt (D L s + R(s))) - r, with each program's max |out|
    #         over both species (NaN if any entry is NaN) in max_ptr[b, block]
    # MODE 2: out = w - dt (D L w + R'(s) w)                   (Jacobian)
    b = tl.program_id(0).to(tl.int64)
    blk = tl.program_id(1)
    idx = blk * BLOCK + tl.arange(0, BLOCK)
    mask = idx < n * n
    i = idx // n
    j = idx - i * n
    im = tl.where(i == 0, n - 1, i - 1)
    ip = tl.where(i == n - 1, 0, i + 1)
    jm = tl.where(j == 0, n - 1, j - 1)
    jp = tl.where(j == n - 1, 0, j + 1)
    dt = tl.load(dt_ptr + b)
    du = tl.load(c_ptr)
    dv = tl.load(c_ptr + 1)
    a = tl.load(c_ptr + 2)
    bb = tl.load(c_ptr + 3)
    dx2 = tl.load(c_ptr + 4)
    su = s_ptr + b * s_sb
    sv = su + s_ss
    u = tl.load(su + i * s_sr + j, mask=mask, other=0.0)
    v = tl.load(sv + i * s_sr + j, mask=mask, other=0.0)
    if MODE == 2:
        xu_p = w_ptr + b * w_sb
        xv_p = xu_p + w_ss
        xs = w_sr
        xu = tl.load(xu_p + i * xs + j, mask=mask, other=0.0)
        xv = tl.load(xv_p + i * xs + j, mask=mask, other=0.0)
    else:
        xu_p = su
        xv_p = sv
        xs = s_sr
        xu = u
        xv = v
    lap_u = ((((tl.load(xu_p + im * xs + j, mask=mask, other=0.0)
                + tl.load(xu_p + ip * xs + j, mask=mask, other=0.0))
               + tl.load(xu_p + i * xs + jm, mask=mask, other=0.0))
              + tl.load(xu_p + i * xs + jp, mask=mask, other=0.0)) - 4.0 * xu) / dx2
    lap_v = ((((tl.load(xv_p + im * xs + j, mask=mask, other=0.0)
                + tl.load(xv_p + ip * xs + j, mask=mask, other=0.0))
               + tl.load(xv_p + i * xs + jm, mask=mask, other=0.0))
              + tl.load(xv_p + i * xs + jp, mask=mask, other=0.0)) - 4.0 * xv) / dx2
    if MODE == 2:
        vv = v * v
        ru = (-vv - a) * xu + ((-2.0 * u) * v) * xv
        rv = vv * xu + ((2.0 * u) * v - bb) * xv
        ou = xu - dt * (du * lap_u + ru)
        ov = xv - dt * (dv * lap_v + rv)
    else:
        uv2 = u * (v * v)
        fu = du * lap_u + (-uv2 + a * (1.0 - u))
        fv = dv * lap_v + (uv2 - bb * v)
        if MODE == 0:
            ou = u + dt * fu
            ov = v + dt * fv
            if HAS_G:
                gu = g_ptr + b * g_sb
                ou = tl.load(gu + i * g_sr + j, mask=mask, other=0.0) + ou
                ov = tl.load(gu + g_ss + i * g_sr + j, mask=mask, other=0.0) + ov
        else:
            rp = r_ptr + b * r_sb
            ou = (u - dt * fu) - tl.load(rp + i * r_sr + j, mask=mask, other=0.0)
            ov = (v - dt * fv) - tl.load(rp + r_ss + i * r_sr + j, mask=mask, other=0.0)
            # tl.max drops NaN; the sum of the NaN entries puts it back
            nan = (tl.sum(tl.where(mask & (ou != ou), ou, 0.0), axis=0)
                   + tl.sum(tl.where(mask & (ov != ov), ov, 0.0), axis=0))
            big = tl.maximum(tl.max(tl.where(mask, tl.abs(ou), 0.0), axis=0),
                             tl.max(tl.where(mask, tl.abs(ov), 0.0), axis=0))
            tl.store(max_ptr + b * NBLK + blk, big + nan)
    op = out_ptr + b * o_sb
    tl.store(op + i * o_sr + j, ou, mask=mask)
    tl.store(op + o_ss + i * o_sr + j, ov, mask=mask)


def _burgers2d_body(s_ptr, w_ptr, r_ptr, out_ptr, max_ptr, dt_ptr, c_ptr,
                    s_sb, s_ss, s_sr, w_sb, w_ss, w_sr, r_sb, r_ss, r_sr, o_sb, o_ss, o_sr,
                    n, NBLK, MODE: tl.constexpr, BLOCK: tl.constexpr):
    # The velocity (u, v) of one lane's block of points; Dx, Dy the periodic
    # central differences, L the 5-point Laplacian, C(s) = (u Dx u + v Dy u,
    # u Dx v + v Dy v); c_ptr holds (nu, 2 dx, dx^2) in the working dtype.
    # MODE 0: out = (s - r) + dt (C(s) - nu L s), with each program's max
    #         |out| over both components (NaN if any entry is NaN)
    # MODE 1: out = w + dt (C'(s) w - nu L w)                  (Jacobian)
    b = tl.program_id(0).to(tl.int64)
    blk = tl.program_id(1)
    idx = blk * BLOCK + tl.arange(0, BLOCK)
    mask = idx < n * n
    i = idx // n
    j = idx - i * n
    im = tl.where(i == 0, n - 1, i - 1)
    ip = tl.where(i == n - 1, 0, i + 1)
    jm = tl.where(j == 0, n - 1, j - 1)
    jp = tl.where(j == n - 1, 0, j + 1)
    dt = tl.load(dt_ptr + b)
    nu = tl.load(c_ptr)
    two_dx = tl.load(c_ptr + 1)
    dx2 = tl.load(c_ptr + 2)
    su = s_ptr + b * s_sb
    sv = su + s_ss
    u = tl.load(su + i * s_sr + j, mask=mask, other=0.0)
    v = tl.load(sv + i * s_sr + j, mask=mask, other=0.0)
    u_im = tl.load(su + im * s_sr + j, mask=mask, other=0.0)
    u_ip = tl.load(su + ip * s_sr + j, mask=mask, other=0.0)
    u_jm = tl.load(su + i * s_sr + jm, mask=mask, other=0.0)
    u_jp = tl.load(su + i * s_sr + jp, mask=mask, other=0.0)
    v_im = tl.load(sv + im * s_sr + j, mask=mask, other=0.0)
    v_ip = tl.load(sv + ip * s_sr + j, mask=mask, other=0.0)
    v_jm = tl.load(sv + i * s_sr + jm, mask=mask, other=0.0)
    v_jp = tl.load(sv + i * s_sr + jp, mask=mask, other=0.0)
    dxu = (u_ip - u_im) / two_dx
    dyu = (u_jp - u_jm) / two_dx
    dxv = (v_ip - v_im) / two_dx
    dyv = (v_jp - v_jm) / two_dx
    if MODE == 0:
        lap_u = ((((u_im + u_ip) + u_jm) + u_jp) - 4.0 * u) / dx2
        lap_v = ((((v_im + v_ip) + v_jm) + v_jp) - 4.0 * v) / dx2
        rp = r_ptr + b * r_sb
        ou = (u - tl.load(rp + i * r_sr + j, mask=mask, other=0.0)) \
            + dt * ((u * dxu + v * dyu) - nu * lap_u)
        ov = (v - tl.load(rp + r_ss + i * r_sr + j, mask=mask, other=0.0)) \
            + dt * ((u * dxv + v * dyv) - nu * lap_v)
        # tl.max drops NaN; the sum of the NaN entries puts it back
        nan = (tl.sum(tl.where(mask & (ou != ou), ou, 0.0), axis=0)
               + tl.sum(tl.where(mask & (ov != ov), ov, 0.0), axis=0))
        big = tl.maximum(tl.max(tl.where(mask, tl.abs(ou), 0.0), axis=0),
                         tl.max(tl.where(mask, tl.abs(ov), 0.0), axis=0))
        tl.store(max_ptr + b * NBLK + blk, big + nan)
    else:
        wu_p = w_ptr + b * w_sb
        wv_p = wu_p + w_ss
        wu = tl.load(wu_p + i * w_sr + j, mask=mask, other=0.0)
        wv = tl.load(wv_p + i * w_sr + j, mask=mask, other=0.0)
        wu_im = tl.load(wu_p + im * w_sr + j, mask=mask, other=0.0)
        wu_ip = tl.load(wu_p + ip * w_sr + j, mask=mask, other=0.0)
        wu_jm = tl.load(wu_p + i * w_sr + jm, mask=mask, other=0.0)
        wu_jp = tl.load(wu_p + i * w_sr + jp, mask=mask, other=0.0)
        wv_im = tl.load(wv_p + im * w_sr + j, mask=mask, other=0.0)
        wv_ip = tl.load(wv_p + ip * w_sr + j, mask=mask, other=0.0)
        wv_jm = tl.load(wv_p + i * w_sr + jm, mask=mask, other=0.0)
        wv_jp = tl.load(wv_p + i * w_sr + jp, mask=mask, other=0.0)
        cu = ((u * ((wu_ip - wu_im) / two_dx) + wu * dxu) + v * ((wu_jp - wu_jm) / two_dx)) \
            + wv * dyu
        cv = ((u * ((wv_ip - wv_im) / two_dx) + wu * dxv) + v * ((wv_jp - wv_jm) / two_dx)) \
            + wv * dyv
        lap_u = ((((wu_im + wu_ip) + wu_jm) + wu_jp) - 4.0 * wu) / dx2
        lap_v = ((((wv_im + wv_ip) + wv_jm) + wv_jp) - 4.0 * wv) / dx2
        ou = wu + dt * (cu - nu * lap_u)
        ov = wv + dt * (cv - nu * lap_v)
    op = out_ptr + b * o_sb
    tl.store(op + i * o_sr + j, ou, mask=mask)
    tl.store(op + o_ss + i * o_sr + j, ov, mask=mask)


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
    """Import triton and compile-wrap the kernel bodies (once)."""
    global tl
    if not _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT["combine"] = triton.jit(_combine_body)
        _JIT["theta_rhs"] = triton.jit(_theta_rhs_body)
        _JIT["allen_cahn"] = triton.jit(_allen_cahn_body)
        _JIT["rk4_brusselator"] = triton.jit(_rk4_brusselator_body)
        _JIT["gray_scott"] = triton.jit(_gray_scott_body)
        _JIT["burgers2d"] = triton.jit(_burgers2d_body)
    return _JIT


# ---------------------------------------------------------------------------
# K4 cpoint_combine
# ---------------------------------------------------------------------------


def cpoint_combine_plain(out, terms, coeffs):
    """out = sum_k coeffs[k] * terms[k], summed left to right."""
    acc = coeffs[0] * terms[0]
    for c, x in zip(coeffs[1:], terms[1:]):
        acc = acc + c * x
    out.copy_(acc)
    return out


def _overlaps_partially(a, b) -> bool:
    """True if a and b share memory without being the same view."""
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    if a.data_ptr() == b.data_ptr() and a.stride() == b.stride():
        return False
    size = a.element_size()

    def span(t):
        last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
        return t.data_ptr(), t.data_ptr() + (last + 1) * size

    (a0, a1), (b0, b1) = span(a), span(b)
    if a1 <= b0 or b1 <= a0:
        return False
    # interleaved rows of one tube (e.g. rows m-1::m and m::m) are disjoint
    # when both views step by the same row stride and their row offsets
    # differ by at least one row length
    if a.stride(0) == b.stride(0) and a.stride(0) >= a.shape[1]:
        off = abs(a.data_ptr() - b.data_ptr()) // size
        return off % a.stride(0) < a.shape[1] or a.stride(0) - off % a.stride(0) < a.shape[1]
    return True


def _coefficients(coeffs, dtype, device):
    key = (tuple(float(c) for c in coeffs), dtype, device)
    c = _COEF_CACHE.get(key)
    if c is None:
        c = _COEF_CACHE[key] = torch.tensor(key[0], dtype=dtype, device=device)
    return c


def cpoint_combine(out, terms, coeffs):
    """out_rows = sum_k coeffs[k] * terms[k]_rows for 1..4 (R, N) row views.

    out may be one of the terms (the same view: an in-place update); it
    must not otherwise overlap a term.  coeffs are Python floats.  Returns
    out.
    """
    name = "cpoint_combine"
    _require(1 <= len(terms) <= MAX_TERMS and len(coeffs) == len(terms), name,
             f"needs 1..{MAX_TERMS} terms with one coefficient each")
    ops = {"out": out, **{f"term{k}": t for k, t in enumerate(terms)}}
    _check_operands(name, ops)
    _require(out.dim() == 2 and all(t.shape == out.shape for t in terms), name,
             "out and every term must be (R, N) views of one shape")
    for k, t in enumerate(terms):
        _require(not _overlaps_partially(out, t), name,
                 f"out overlaps term{k} without being the same view")
    if out.device.type == "cpu":
        return cpoint_combine_plain(out, terms, coeffs)
    R, N = out.shape
    if R and N:
        xs = list(terms) + [terms[0]] * (MAX_TERMS - len(terms))
        c = _coefficients(coeffs, out.dtype, out.device)
        grid = (R, -(-N // _BLOCK))
        with torch.cuda.device(out.device):
            _jit()["combine"][grid](out, *xs, c, out.stride(0),
                                    *(x.stride(0) for x in xs), N,
                                    NT=len(terms), BLOCK=_BLOCK, num_warps=4)
        cpoint_combine.launches += 1
    return out


cpoint_combine.launches = 0


# ---------------------------------------------------------------------------
# K7 theta_rhs2d
# ---------------------------------------------------------------------------


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
    name = "theta_rhs2d"
    fe = float(theta) == 0.0
    ops = dict(u=u, out=out, rhs1=rhs1, rhs0=rhs0)
    for key, t in dict(lift=lift, ring=ring, g=g).items():
        if t is not None:
            ops[key] = t
    if isinstance(dt, torch.Tensor):
        ops["dt"] = dt
    _check_operands(name, ops)
    _require(u.dim() == 3, name, f"u has shape {tuple(u.shape)}, expected (B, P, Q)")
    B, P, Q = u.shape
    _require(P >= 3 and Q >= 3, name, "states need an interior")
    shape = (B, P, Q) if fe else (B, P - 2, Q - 2)
    _require(tuple(out.shape) == shape, name,
             f"out has shape {tuple(out.shape)}, expected {shape}")
    _require(g is None or (fe and tuple(g.shape) == shape), name,
             "g is added to FE steps only, and must have the shape of out")
    N = (P - 2) * (Q - 2)
    _require(tuple(rhs1.shape) == (B, N) and rhs0.shape == rhs1.shape
             and rhs0.stride() == rhs1.stride(), name,
             f"rhs1 and rhs0 must be ({B}, {N}) views with equal strides")
    _require(0.0 <= float(theta) <= 1.0, name, "theta must lie in [0, 1]")
    if fe:
        _require(ring is not None and tuple(ring.shape) == (P, Q) and ring.is_contiguous(),
                 name, f"FE needs a contiguous ({P}, {Q}) ring field")
    else:
        _require(lift is not None and tuple(lift.shape) == (P - 2, Q - 2)
                 and lift.is_contiguous(), name,
                 f"BE/CN need a contiguous ({P - 2}, {Q - 2}) lift")
    _require(not isinstance(dt, torch.Tensor)
             or (tuple(dt.shape) == (B,) and dt.is_contiguous()), name,
             f"a dt tensor must be a contiguous ({B},) vector")
    if u.device.type == "cpu":
        return theta_rhs2d_plain(u, out, dt, theta, fx, fy, rhs1, rhs0, lift, ring, g)
    if B == 0:
        return out
    mode = 2 if fe else (0 if float(theta) == 1.0 else 1)
    dt_t = dt if isinstance(dt, torch.Tensor) else None
    c = _coefficients((0.0 if dt_t is not None else dt, theta, fx, fy), u.dtype, u.device)
    grid = (B, -(-(shape[1] * shape[2]) // _BLOCK))
    with torch.cuda.device(u.device):
        _jit()["theta_rhs"][grid](
            u, out, rhs1, rhs0, lift if lift is not None else u, ring if ring is not None else u,
            g if g is not None else out, dt_t if dt_t is not None else u, c,
            u.stride(0), u.stride(1), out.stride(0), out.stride(1), rhs1.stride(0),
            g.stride(0) if g is not None else 0, g.stride(1) if g is not None else 0,
            shape[1], shape[2], MODE=mode, HAS_G=g is not None, DT_TENSOR=dt_t is not None,
            BLOCK=_BLOCK, num_warps=4)
    theta_rhs2d.launches += 1
    return out


theta_rhs2d.launches = 0


# ---------------------------------------------------------------------------
# K11 allen_cahn_pointwise
# ---------------------------------------------------------------------------

AC_MODES = ("rhs", "residual", "jacobian")


def periodic_lap_plain(x, dx2):
    """The periodic 5-point Laplacian of (B, n, n) states, summed in the
    order of pymgrit_tpu/models/allen_cahn.py ``AllenCahn._lap``."""
    return ((((torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) + torch.roll(x, 1, 2))
             + torch.roll(x, -1, 2)) - 4.0 * x) / dx2


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


def allen_cahn_pointwise(mode, u, out, fac, inv_eps2, dx2, nu, x=None, rhs=None):
    """One fused stencil + reaction pass over B periodic (n, n) states.

    mode "rhs" (CN's right-hand side), "residual" (the Newton residual
    g = u - fac (L u + f(u)) - rhs; returns (out, (B,) max |g| with NaN
    where g holds a NaN)) or "jacobian" (the Jacobian at u applied to x).
    u, x, rhs, out: (B, n, n) views with contiguous rows; fac: contiguous
    (B,) tensor; inv_eps2 = 1/eps^2 and dx2 = dx^2 are floats; nu >= 1 an
    integer.  out must not overlap the inputs.  Returns out (or the pair).
    """
    name = "allen_cahn_pointwise"
    _require(mode in AC_MODES, name, f"mode must be one of {AC_MODES}")
    ops = dict(u=u, out=out, fac=fac)
    if mode == "jacobian":
        _require(x is not None, name, "the jacobian mode needs x")
        ops["x"] = x
    if mode == "residual":
        _require(rhs is not None, name, "the residual mode needs rhs")
        ops["rhs"] = rhs
    _check_operands(name, ops)
    _require(u.dim() == 3 and u.shape[1] == u.shape[2], name,
             f"u has shape {tuple(u.shape)}, expected (B, n, n)")
    B, n = u.shape[0], u.shape[1]
    for key, t in ops.items():
        if key != "fac":
            _require(tuple(t.shape) == (B, n, n), name,
                     f"{key} has shape {tuple(t.shape)}, expected ({B}, {n}, {n})")
    _require(tuple(fac.shape) == (B,) and fac.is_contiguous(), name,
             f"fac must be a contiguous ({B},) tensor")
    _require(int(nu) >= 1, name, "nu must be >= 1")
    if u.device.type == "cpu":
        return allen_cahn_pointwise_plain(mode, u, out, fac, inv_eps2, dx2, nu, x, rhs)
    nblk = -(-(n * n) // _BLOCK)
    part = torch.empty((B, nblk), dtype=u.dtype, device=u.device) if mode == "residual" else None
    if B:
        c = _coefficients((inv_eps2, dx2), u.dtype, u.device)
        xs = x if x is not None else u
        rs = rhs if rhs is not None else u
        with torch.cuda.device(u.device):
            _jit()["allen_cahn"][(B, nblk)](
                u, xs, rs, out, part if part is not None else out, fac, c,
                u.stride(0), u.stride(1), xs.stride(0), xs.stride(1), rs.stride(0), rs.stride(1),
                out.stride(0), out.stride(1), n, nblk, MODE=AC_MODES.index(mode), NU=int(nu),
                BLOCK=_BLOCK, num_warps=4)
        allen_cahn_pointwise.launches += 1
    if mode == "residual":
        # torch.amax keeps a NaN partial
        return out, part.amax(dim=1)
    return out


allen_cahn_pointwise.launches = 0


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


# ---------------------------------------------------------------------------
# K14 gray_scott_pointwise, K15 burgers2d_pointwise
# ---------------------------------------------------------------------------

GS_MODES = ("expl", "residual", "jacobian")
BURGERS_MODES = ("residual", "jacobian")


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


def _check_pairs(name, mode, modes, s, out, dt, extra):
    _require(mode in modes, name, f"mode must be one of {modes}")
    ops = dict(s=s, out=out, dt=dt, **{k: t for k, t in extra.items() if t is not None})
    _check_operands(name, ops)
    _require(s.dim() == 4 and s.shape[1] == 2 and s.shape[2] == s.shape[3], name,
             f"s has shape {tuple(s.shape)}, expected (B, 2, n, n)")
    for key, t in ops.items():
        if key != "dt":
            _require(t.shape == s.shape, name,
                     f"{key} has shape {tuple(t.shape)}, expected {tuple(s.shape)}")
    B = s.shape[0]
    _require(tuple(dt.shape) == (B,) and dt.is_contiguous(), name,
             f"dt must be a contiguous ({B},) tensor")


def gray_scott_pointwise(mode, s, out, dt, du, dv, a, b, dx2, r=None, w=None, g=None):
    """One fused stencil + reaction pass over B Gray-Scott pairs (u, v).

    mode "expl" (the EXPL step, out = [g +] step), "residual" (the Newton
    residual g = s - dt (D L s + R(s)) - r; returns (out, (B,) max |g| over
    both species with NaN where g holds a NaN)) or "jacobian" (the Jacobian
    at s applied to w).  s, r, w, g, out: (B, 2, n, n) views with contiguous
    rows; dt: contiguous (B,) tensor; du, dv, a, b, dx2 = dx^2 floats.  out
    must not overlap the inputs.  Returns out (or the pair).
    """
    name = "gray_scott_pointwise"
    _check_pairs(name, mode, GS_MODES, s, out, dt, dict(r=r, w=w, g=g))
    _require(mode != "residual" or r is not None, name, "the residual mode needs r")
    _require(mode != "jacobian" or w is not None, name, "the jacobian mode needs w")
    _require(g is None or mode == "expl", name, "g is added to EXPL steps only")
    if s.device.type == "cpu":
        return gray_scott_pointwise_plain(mode, s, out, dt, du, dv, a, b, dx2, r, w, g)
    B, n = s.shape[0], s.shape[2]
    nblk = -(-(n * n) // _BLOCK)
    part = torch.empty((B, nblk), dtype=s.dtype, device=s.device) if mode == "residual" else None
    if B:
        c = _coefficients((du, dv, a, b, dx2), s.dtype, s.device)
        ws, rs, gs = (x if x is not None else s for x in (w, r, g))
        with torch.cuda.device(s.device):
            _jit()["gray_scott"][(B, nblk)](
                s, ws, rs, gs, out, part if part is not None else out, dt, c, *s.stride()[:3],
                *ws.stride()[:3], *rs.stride()[:3], *gs.stride()[:3], *out.stride()[:3], n, nblk,
                MODE=GS_MODES.index(mode), HAS_G=g is not None, BLOCK=_BLOCK, num_warps=4)
        gray_scott_pointwise.launches += 1
    if mode == "residual":
        # torch.amax keeps a NaN partial
        return out, part.amax(dim=1)
    return out


gray_scott_pointwise.launches = 0


def _ddx(w, two_dx):
    return (torch.roll(w, -1, -2) - torch.roll(w, 1, -2)) / two_dx


def _ddy(w, two_dx):
    return (torch.roll(w, -1, -1) - torch.roll(w, 1, -1)) / two_dx


def burgers2d_pointwise_plain(mode, s, out, dt, nu, dx, r=None, w=None):
    """residual: out = (s - r) + dt (C(s) - nu L s), returns (out, max |out|
    per lane, NaN-propagating); jacobian: out = w + dt (C'(s) w - nu L w)
    (expression order of pymgrit_tpu/models/burgers.py ``Burgers2D.step``)."""
    d = dt.view(-1, 1, 1, 1)
    two_dx, dx2 = 2 * dx, dx ** 2
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


def burgers2d_pointwise(mode, s, out, dt, nu, dx, r=None, w=None):
    """One fused stencil pass over B periodic 2D Burgers velocity fields.

    mode "residual" (the Newton residual g = s - r + dt (C(s) - nu L s);
    returns (out, (B,) max |g| over both components, NaN where g holds a
    NaN)) or "jacobian" (the linearised convection and viscosity at s
    applied to w).  s, r, w, out: (B, 2, n, n) views with contiguous rows;
    dt: contiguous (B,) tensor; nu, dx floats.  out must not overlap the
    inputs.  Returns out (or the pair).
    """
    name = "burgers2d_pointwise"
    _check_pairs(name, mode, BURGERS_MODES, s, out, dt, dict(r=r, w=w))
    _require(mode != "residual" or r is not None, name, "the residual mode needs r")
    _require(mode != "jacobian" or w is not None, name, "the jacobian mode needs w")
    if s.device.type == "cpu":
        return burgers2d_pointwise_plain(mode, s, out, dt, nu, dx, r, w)
    B, n = s.shape[0], s.shape[2]
    nblk = -(-(n * n) // _BLOCK)
    part = torch.empty((B, nblk), dtype=s.dtype, device=s.device) if mode == "residual" else None
    if B:
        c = _coefficients((nu, 2 * dx, dx ** 2), s.dtype, s.device)
        ws, rs = (x if x is not None else s for x in (w, r))
        with torch.cuda.device(s.device):
            _jit()["burgers2d"][(B, nblk)](
                s, ws, rs, out, part if part is not None else out, dt, c, *s.stride()[:3],
                *ws.stride()[:3], *rs.stride()[:3], *out.stride()[:3], n, nblk,
                MODE=BURGERS_MODES.index(mode), BLOCK=_BLOCK, num_warps=4)
        burgers2d_pointwise.launches += 1
    if mode == "residual":
        return out, part.amax(dim=1)
    return out


burgers2d_pointwise.launches = 0
