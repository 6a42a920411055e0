"""Kernels K13 ``rk4_brusselator``, K14 ``gray_scott_pointwise`` and K15
``burgers2d_pointwise`` (Triton), each beside its plain PyTorch version.
(K3 ``residual_row_norms``, K4 ``cpoint_combine``, K7 ``theta_rhs2d``, K11
``allen_cahn_pointwise``, K18 ``restrict_combine``, K19
``interpolate_combine`` and K21 ``indexed_combine`` are CUDA C++:
``csrc/residual_row_norms.cu``, ``csrc/indexed_combine.cu`` (wrappers in
``indexed``), ``csrc/theta_rhs2d.cu`` (wrapper in ``theta_rhs``),
``csrc/allen_cahn_pointwise.cu`` (wrapper in ``pointwise``),
``csrc/restrict_combine.cu``, ``csrc/interpolate_combine.cu``.)

K14 and K15 are stencil passes for the periodic nonlinear models
(pymgrit_tpu/models/gray_scott_2d.py, burgers.py): the Newton residual
with its per-lane max, the Jacobian matvec, and (K14) the explicit
Gray-Scott step; each holds both species of a lane in one program.  K13
is the Brusselator's RK4 chain.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the Triton kernel or raise.  ``triton`` is imported on the
first launch (the CPU tests import this module without it); the kernel
bodies below are plain functions until ``_jit()`` compiles them, and the
``tl`` name they use is bound then.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _require
from pymgrit_tpu_torch.ops.pointwise import periodic_lap_plain
from pymgrit_tpu_torch.ops.runge_kutta import rk4_step

tl = None            # triton.language, bound by _jit() on first launch
_JIT = {}            # kernel name -> triton.JITFunction
_COEF_CACHE = {}     # (coeffs, dtype, device) -> coefficient tensor

_BLOCK = 1024


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
        _JIT["rk4_brusselator"] = triton.jit(_rk4_brusselator_body)
        _JIT["gray_scott"] = triton.jit(_gray_scott_body)
        _JIT["burgers2d"] = triton.jit(_burgers2d_body)
    return _JIT


def _coefficients(coeffs, dtype, device):
    """The kernels' float scalars as a device tensor (Triton types a Python
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
