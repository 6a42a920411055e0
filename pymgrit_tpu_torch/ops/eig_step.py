"""Kernel K22 ``eig_step`` (CUDA C++, ``csrc/eig_step.cu``) beside its plain
PyTorch version: Diffusion2D's backward-Euler step in the generalized
eigenbasis of its operator, on B lanes in row form,

    y_b = ((x_b W^T) / (1 + dt_b lam)) V^T,

the row form of JAX's ``V @ ((W @ u) / (1 + dt * lam))``
(pymgrit_tpu/models/diffusion_2d.py ``Diffusion2D.step``).  The two dense
products run on the shared FP64 product tile (``csrc/dmma_tile.cuh``): on
the FP64 tensor cores (DMMA) in float64 and on the CUDA cores (FFMA, never
TF32) in float32, with the plan ``product_tile.product_plan`` picks from
the shapes; see the source for the design.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pymgrit_tpu_torch.ops import _build, product_tile
from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _launcher, _require


def eig_step_plain(x, out, W, V, lam, dt):
    """out = ((x W^T) / (1 + dt lam)) V^T row by row."""
    uh = x @ W.T
    out.copy_((uh / (1.0 + dt[:, None] * lam[None])) @ V.T)
    return out


def eig_step(x, out, W, V, lam, dt):
    """Backward-Euler eigenbasis step of B lanes (K22).

    x, out: (B, N) views (any lane stride; out may be x); W, V: contiguous
    (N, N) tables; lam: contiguous (N,) eigenvalues; dt: contiguous (B,)
    step sizes.  Returns out.
    """
    name = "eig_step"
    _check_operands(name, dict(x=x, out=out, W=W, V=V, lam=lam, dt=dt))
    if not (x.dim() == 2 and out.shape == x.shape):
        _require(False, name,
                 f"x {tuple(x.shape)} and out {tuple(out.shape)} must be equal (B, N) views")
    B, N = x.shape
    if not (W.shape == (N, N) and V.shape == (N, N) and W.is_contiguous() and V.is_contiguous()):
        _require(False, name, f"W and V must be contiguous ({N}, {N}) tables")
    if not (lam.shape == (N,) and lam.is_contiguous()):
        _require(False, name, f"lam must be a contiguous ({N},) vector")
    if not (dt.shape == (B,) and dt.is_contiguous()):
        _require(False, name, f"dt must be a contiguous ({B},) vector")
    if x.device.type == "cpu":
        return eig_step_plain(x, out, W, V, lam, dt)
    if B == 0 or N == 0:
        return out
    _launch(x, out, W, V, lam, dt, plan(x, W, V))
    eig_step.launches += 1
    return out


def plan(x, W, V):
    """The product plan of both of K22's products for lanes x and tables W,
    V (the work buffer between them is a fresh (B, N) tensor)."""
    B, N = x.shape
    return _plan(B, N, x.dtype, x.stride(0), x.data_ptr() % 16, W.data_ptr() % 16,
                 V.data_ptr() % 16)


@functools.lru_cache(maxsize=256)
def _plan(B, N, dtype, sx, x_mod, w_mod, v_mod):
    """plan() by what it depends on: shapes, the lane stride and each
    pointer's offset from 16-byte alignment."""
    es = 8 if dtype == torch.float64 else 4
    copy = product_tile.copy_bytes
    lanes = min(copy((x_mod,), (0, sx, 1), (1, B, N), es), copy((0,), (0, N, 1), (1, B, N), es))
    table = copy((w_mod, v_mod), (0, N, 1), (1, N, N), es)
    return product_tile.product_plan(1, B, N, N, str(dtype).split(".")[-1], lanes, table)


def _launch(x, out, W, V, lam, dt, plan):
    """Both products of K22 on the given plan."""
    B, N = x.shape
    # the (B, N) work buffer between the products, then the partials
    buf = product_tile.workspace(plan, x.dtype, x.device, lead=B * N)
    work = buf.data_ptr()
    ws = work + B * N * x.element_size() if plan.splits > 1 else 0
    args = (ctypes.c_int64 * 22)(
        x.data_ptr(), x.stride(0), W.data_ptr(), V.data_ptr(), lam.data_ptr(), dt.data_ptr(),
        work, ws, out.data_ptr(), out.stride(0), B, N, *plan.launch_args())
    status = _launcher("pm_eig_step", x.dtype)(args, _build.stream(x.get_device()))
    _build.check(status, "eig_step")


eig_step.launches = 0
