"""Kernel K3 ``residual_row_norms`` (CUDA C++, ``csrc/residual_row_norms.cu``)
beside its plain PyTorch version.

K3 replaces pymgrit_tpu/core/solver.py ``_point_residual_norms`` with its
default ``state_norm`` (``vector.batched_norm``): the 2-norm of each row of
Phi(u_{c-1}) - u_c that the convergence check reduces.  It is bound by the
bytes it reads (two rows, one value written a row).  Its squares mode
leaves the root out: each space shard's part of a C-point's norm, which
the sharded executor adds over the space group before the root
(``parallel.shard_solver``).  The wrapper keeps host
time down as K18's does (``transfer``): its checks and the launcher's
argument array are cached by the operands' dtype, device, shapes and
strides (``_checked``), and a launch is one ctypes call with the array's
address and the three pointers.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import array
import functools

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import _check_facts, _launcher, _require, fact
from pymgrit_tpu_torch.ops.ieee_sqrt import sqrt_rn


def residual_row_norms_plain(s, u, squares=False):
    """Per-row 2-norm of s - u: (R, N), (R, N) -> (R,); with ``squares``
    the per-row sum of squares (the norm without its root)."""
    total = torch.sum(torch.square(s - u), dim=1)
    return total if squares else sqrt_rn(total)


def pack(index, R, N, s_stride, u_stride):
    """The launcher's int64 argument array (csrc/residual_row_norms.cu
    ``launch``): device, R, N, s's and u's row strides."""
    return array.array("q", (index, R, N, s_stride, u_stride))


@functools.lru_cache(maxsize=1024)
def _checked(facts, squares=False):
    """Every check of a K3 call, on the ``fact``s of s and u and the mode,
    cached by them (the squares mode has a launcher of its own); returns
    (on the CPU, the launch: the argument array, its address, the launcher
    and the device index; None on the CPU or with no rows)."""
    name = "residual_row_norms"
    _check_facts(name, facts, ("s", "u").__getitem__)
    (dtype, device, sshape, sstride), (_, _, ushape, ustride) = facts
    if not (len(sshape) == 2 and sshape == ushape):
        _require(False, name,
                 f"s {tuple(sshape)} and u {tuple(ushape)} must be equal (R, N) views")
    on_cpu, launch = device.type == "cpu", None
    if not on_cpu and sshape[0]:
        index = device.index
        args = pack(index, *sshape, sstride[0], ustride[0])
        name = "pm_residual_row_norms_squares" if squares else "pm_residual_row_norms"
        launch = (args, args.buffer_info()[0], _launcher(name, dtype), index)
    return on_cpu, launch


def residual_row_norms(s, u, squares=False):
    """||s_i - u_i||_2 for every row i of two (R, N) row views (rows at any
    stride, u's may be 0; each row contiguous); with ``squares``,
    ||s_i - u_i||_2^2 (the sum of squares, no root)."""
    on_cpu, launch = _checked((fact(s), fact(u)), bool(squares))
    if on_cpu:
        return residual_row_norms_plain(s, u, squares)
    out = torch.empty(s.shape[0], dtype=s.dtype, device=s.device)
    if launch is not None:
        _, addr, fn, index = launch
        _build.check(fn(addr, s.data_ptr(), u.data_ptr(), out.data_ptr(), _build.stream(index)),
                     "residual_row_norms")
        residual_row_norms.launches += 1
        residual_row_norms.mode_launches["squares" if squares else "norms"] += 1
        if squares and s.dtype == torch.float32:
            residual_row_norms.mode_launches["squares float32"] += 1
    return out


residual_row_norms.launches = 0
# launches by mode; "squares float32" counts the squares mode's float32
# launches again (a DD slab's norms: K25's float32 resid rows)
residual_row_norms.mode_launches = {"norms": 0, "squares": 0, "squares float32": 0}
