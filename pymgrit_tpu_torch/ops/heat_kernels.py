"""Kernels K1 ``interval_affine`` and K2 ``theta_chain`` (CUDA C++), each
beside its plain PyTorch version.

Dispatch: a tensor on the CPU goes to the plain version; a CUDA tensor
launches the kernel from ``csrc/`` (built on first use by ``_build``) or
raises.  Each wrapper checks device, dtype, shape and strides first and
counts its launches in ``<wrapper>.launches``.

All rows are addressed with strides, so the solver passes strided views of
its level tubes and the kernels write straight into them.  In every 2-D or
3-D operand the last axis (the N state coefficients) must be contiguous.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.ops import _build

_FLOATS = (torch.float32, torch.float64)


def _require(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def _check_operands(name: str, tensors: dict) -> None:
    """Common checks against the first tensor's dtype and device."""
    ref = next(iter(tensors.values()))
    _require(ref.dtype in _FLOATS, name, f"dtype {ref.dtype} is not float32/float64")
    for key, t in tensors.items():
        _require(t.dtype == ref.dtype, name, f"{key} has dtype {t.dtype}, expected {ref.dtype}")
        _require(t.device == ref.device, name, f"{key} is on {t.device}, expected {ref.device}")
        _require(t.shape[-1] <= 1 or t.stride(-1) == 1, name,
                 f"{key} must be contiguous in its last axis")
    _require(ref.device.type in ("cpu", "cuda"), name, f"unsupported device {ref.device}")


def _launcher(name: str, dtype: torch.dtype):
    return getattr(_build.library(), f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")


# ---------------------------------------------------------------------------
# K1 interval_affine
# ---------------------------------------------------------------------------


def interval_affine_plain(x, A, G, out, r0=0, seed_out=None):
    """out[j, r] = A[r0 + r] * x[j] + G[r0 + r]; seed_out[j] = x[j]."""
    R = out.shape[1]
    out.copy_(x[:, None] * A[None, r0:r0 + R] + G[None, r0:r0 + R])
    if seed_out is not None:
        seed_out.copy_(x)
    return out


def interval_affine(x, A, G, out, r0=0, seed_out=None):
    """Closed-form interval relaxation into ``out``.

    x: (J, N) seeds; A, G: (T, N) contiguous tables; out: (J, R, N) view
    with any interval and row strides (row-major, interval-major or the
    tube's own block view), rows r0..r0+R-1 of the tables; seed_out:
    optional (J, N) view that receives a copy of x.  Returns out.
    """
    name = "interval_affine"
    ops = dict(x=x, A=A, G=G, out=out)
    if seed_out is not None:
        ops["seed_out"] = seed_out
    _check_operands(name, ops)
    J, N = x.shape
    R = out.shape[1]
    _require(A.dim() == 2 and A.shape == G.shape and A.shape[1] == N
             and A.is_contiguous() and G.is_contiguous(), name,
             "A and G must be contiguous (T, N) tables")
    _require(out.dim() == 3 and out.shape[0] == J and out.shape[2] == N, name,
             f"out has shape {tuple(out.shape)}, expected ({J}, R, {N})")
    _require(0 <= r0 and r0 + R <= A.shape[0], name,
             f"rows {r0}..{r0 + R - 1} outside the {A.shape[0]}-row table")
    _require(seed_out is None or tuple(seed_out.shape) == (J, N), name,
             "seed_out must have the shape of x")
    if x.device.type == "cpu":
        return interval_affine_plain(x, A, G, out, r0, seed_out)
    if J == 0 or N == 0:
        return out
    fn = _launcher("pm_interval_affine", x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), x.stride(0), A.data_ptr(), G.data_ptr(), r0, R, J, N,
                out.data_ptr(), out.stride(0), out.stride(1),
                seed_out.data_ptr() if seed_out is not None else None,
                seed_out.stride(0) if seed_out is not None else 0, stream)
    _build.check(status, name)
    interval_affine.launches += 1
    return out


interval_affine.launches = 0


# ---------------------------------------------------------------------------
# K2 theta_chain
# ---------------------------------------------------------------------------


def theta_chain_plain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g=None):
    """J chains of L spectral theta-steps (expression order of
    ``Heat2D._step_spectral``), each step plus g[:, k] when given."""
    x = x0
    for k in range(out.shape[1]):
        d = dt[k][:, None]
        shift = d * theta
        if theta == 1.0:
            b = x + d * rhs1[k] + shift * lift
        else:
            b = (x - shift * (x * lam)) + (shift * 2.0) * lift \
                + d * (theta * rhs1[k] + (1 - theta) * rhs0[k])
        x = b / (1.0 + shift * lam)
        if g is not None:
            x = g[:, k] + x
        out[:, k] = x
    return out


def theta_chain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g=None):
    """Sequential spectral theta-steps of J chains, every step written.

    x0: (J, N) seeds; out: (J, L, N) view; g: optional (J, L, N) view added
    after each step; dt: (L, J) contiguous step sizes; lam, lift: (N,)
    eigenvalues and lifted boundary data; rhs1, rhs0: (L, J, N) views of the
    rhs at the step's end and start (strides 0 for a time-independent rhs;
    rhs0 is read only when theta != 1).  out must not overlap x0 or g.
    Returns out.
    """
    name = "theta_chain"
    ops = dict(x0=x0, out=out, dt=dt, lam=lam, lift=lift, rhs1=rhs1, rhs0=rhs0)
    if g is not None:
        ops["g"] = g
    _check_operands(name, ops)
    J, N = x0.shape
    L = out.shape[1]
    _require(out.dim() == 3 and out.shape[0] == J and out.shape[2] == N, name,
             f"out has shape {tuple(out.shape)}, expected ({J}, L, {N})")
    _require(g is None or g.shape == out.shape, name, "g must have the shape of out")
    _require(tuple(dt.shape) == (L, J) and dt.is_contiguous(), name,
             f"dt must be a contiguous ({L}, {J}) tensor")
    _require(tuple(lam.shape) == (N,) and tuple(lift.shape) == (N,), name,
             "lam and lift must have shape (N,)")
    _require(rhs1.shape == out.shape[1:2] + (J, N) and rhs0.shape == rhs1.shape
             and rhs0.stride() == rhs1.stride(), name,
             "rhs1 and rhs0 must be (L, J, N) views with equal strides")
    _require(float(theta) > 0.0, name, "theta must be > 0 (BE or CN)")
    if x0.device.type == "cpu":
        return theta_chain_plain(x0, out, dt, lam, lift, rhs1, rhs0, theta, g)
    if J == 0 or L == 0 or N == 0:
        return out
    fn = _launcher("pm_theta_chain", x0.dtype)
    stream = torch.cuda.current_stream(x0.device).cuda_stream
    status = fn(x0.data_ptr(), x0.stride(0), out.data_ptr(), out.stride(0), out.stride(1),
                g.data_ptr() if g is not None else None,
                g.stride(0) if g is not None else 0, g.stride(1) if g is not None else 0,
                dt.data_ptr(), lam.data_ptr(), lift.data_ptr(), rhs1.data_ptr(),
                rhs0.data_ptr(), rhs1.stride(0), rhs1.stride(1), float(theta),
                J, L, N, stream)
    _build.check(status, name)
    theta_chain.launches += 1
    return out


theta_chain.launches = 0
