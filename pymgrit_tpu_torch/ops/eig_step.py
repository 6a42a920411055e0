"""Kernel K22 ``eig_step`` (CUDA C++, ``csrc/eig_step.cu``) beside its plain
PyTorch version: Diffusion2D's backward-Euler step in the generalized
eigenbasis of its operator, on B lanes in row form,

    y_b = ((x_b W^T) / (1 + dt_b lam)) V^T,

the row form of JAX's ``V @ ((W @ u) / (1 + dt * lam))``
(pymgrit_tpu/models/diffusion_2d.py ``Diffusion2D.step``).  The two dense
products run on the FP64 tensor cores (DMMA) in float64 and on the CUDA
cores (FFMA, never TF32) in float32; see the source for the design.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.ops import _build
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
    _require(x.dim() == 2 and out.shape == x.shape, name,
             f"x {tuple(x.shape)} and out {tuple(out.shape)} must be equal (B, N) views")
    B, N = x.shape
    _require(tuple(W.shape) == (N, N) and tuple(V.shape) == (N, N) and W.is_contiguous()
             and V.is_contiguous(), name, f"W and V must be contiguous ({N}, {N}) tables")
    _require(tuple(lam.shape) == (N,) and lam.is_contiguous(), name,
             f"lam must be a contiguous ({N},) vector")
    _require(tuple(dt.shape) == (B,) and dt.is_contiguous(), name,
             f"dt must be a contiguous ({B},) vector")
    if x.device.type == "cpu":
        return eig_step_plain(x, out, W, V, lam, dt)
    if B == 0 or N == 0:
        return out
    work = torch.empty((B, N), dtype=x.dtype, device=x.device)
    fn = _launcher("pm_eig_step", x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), x.stride(0), W.data_ptr(), V.data_ptr(), lam.data_ptr(),
                dt.data_ptr(), work.data_ptr(), out.data_ptr(), out.stride(0), B, N, stream)
    _build.check(status, name)
    eig_step.launches += 1
    return out


eig_step.launches = 0
