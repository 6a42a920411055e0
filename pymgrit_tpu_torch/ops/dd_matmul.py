"""Kernel K26 ``dd_matmul`` (CUDA C++, ``csrc/dd_matmul.cu``) beside its
plain version, and ``matmul_dd``, the counterpart of the JAX package's
``pymgrit_tpu/ops/ozaki.py::matmul_dd``.

The JAX package multiplies double-double operands by the Ozaki scheme on
the TPU's bf16 matrix unit (no float64 there).  Hopper has float64 tensor
cores, so K26 forms each operand value as the exact float64 ``hi + lo``,
accumulates in float64 on DMMA and splits each sum back into a DD pair.
That is about k 2^-53 accurate (k the contraction length) against Ozaki's
2^-48, and not bitwise equal to the JAX package; the port holds it to a
stated tolerance.  The plain version does the same in one float64
``torch.matmul``.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops import dd as _dd
from pymgrit_tpu_torch.ops.dd import DD


def _split64(c: torch.Tensor):
    hi = c.to(torch.float32)
    return hi, (c - hi.to(torch.float64)).to(torch.float32)


def dd_matmul_plain(a: DD, b: DD, out: DD = None) -> DD:
    """C = A B of (batch, M, K) and (batch, K, N) DD operands: the float64
    product of hi + lo, split into (hi, lo)."""
    c = torch.matmul(a.hi.double() + a.lo.double(), b.hi.double() + b.lo.double())
    hi, lo = _split64(c)
    if out is None:
        return _dd._raw(hi, lo, a.ops)
    out.hi.copy_(hi)
    out.lo.copy_(lo)
    return out


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dd_matmul: {msg}")


def dd_matmul(a: DD, b: DD, out: DD = None) -> DD:
    """Batched DD products C_b = A_b B_b (K26).

    a: (batch, M, K) and b: (batch, K, N) DD views with any strides (hi and
    lo strided alike; batch stride 0 for one matrix shared by the batch);
    out: optional (batch, M, N) DD view (hi and lo strided alike) that must
    not overlap a or b.  Returns out, or a new DD without it.
    """
    _require(isinstance(a, DD) and isinstance(b, DD), "operands must be DD pairs")
    _require(a.ndim == 3 and b.ndim == 3, f"operands must be 3-D, got {tuple(a.shape)} and "
             f"{tuple(b.shape)}")
    batch, M, K = a.shape
    _require(b.shape[0] == batch and b.shape[1] == K,
             f"shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    N = b.shape[2]
    ts = [a.hi, a.lo, b.hi, b.lo] + ([] if out is None else [out.hi, out.lo])
    _require(all(t.dtype == torch.float32 for t in ts), "DD components must be float32")
    dev = a.hi.device
    _require(all(t.device == dev for t in ts), f"operands must lie on {dev}")
    for name, x in (("a", a), ("b", b)) + ((("out", out),) if out is not None else ()):
        _require(x.hi.stride() == x.lo.stride(), f"{name}: hi and lo must be strided alike")
    if out is not None:
        _require(tuple(out.shape) == (batch, M, N), f"out has shape {tuple(out.shape)}, expected "
                 f"({batch}, {M}, {N})")
    if dev.type == "cpu" or any(_dd._is_batched(t) for t in ts):
        _require(dev.type == "cpu", "K26 takes no vmapped tensor on the card")
        return dd_matmul_plain(a, b, out)
    if out is None:
        out = _dd._raw(torch.empty((batch, M, N), dtype=torch.float32, device=dev),
                       torch.empty((batch, M, N), dtype=torch.float32, device=dev), a.ops)
    if batch == 0 or M == 0 or N == 0:
        return out
    ptrs = [a.hi.data_ptr(), a.lo.data_ptr(), b.hi.data_ptr(), b.lo.data_ptr(),
            out.hi.data_ptr(), out.lo.data_ptr()]
    strides = list(a.hi.stride()) + list(b.hi.stride()) + list(out.hi.stride())
    status = _build.library().pm_dd_matmul((ctypes.c_void_p * 6)(*ptrs),
                                           (ctypes.c_int64 * 9)(*strides),
                                           (ctypes.c_int64 * 4)(batch, M, N, K),
                                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, "dd_matmul")
    dd_matmul.launches += 1
    return out


dd_matmul.launches = 0


def matmul_dd(a, b) -> DD:
    """C = a @ b in double-double; a, b may be DD, numpy float64 (split
    exactly) or torch tensors (taken as float32).  1-D operands follow
    numpy's matmul rules, leading batch axes broadcast, and a contraction
    of any length is one product (no chunking: K26 accumulates in float64).
    One ``ops.dd_matmul`` call (the kernel set of the first DD operand)."""
    ops = _dd._ops_of(a, b)
    dev = next((x.device for x in (a, b) if isinstance(x, (DD, torch.Tensor))), None)
    a = _dd.coerce(a, dev, ops)
    b = _dd.coerce(b, dev, ops)
    a_vec, b_vec = a.ndim == 1, b.ndim == 1
    if a_vec:
        a = a.reshape(1, -1)
    if b_vec:
        b = b.reshape(-1, 1)
    K = a.shape[-1]
    if b.shape[-2] != K:
        raise ValueError(f"matmul_dd contraction mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    M, N = a.shape[-2], b.shape[-1]

    def batched(x, rows, cols):
        x = x.expand(*lead, rows, cols)
        hi, lo = x.hi.reshape(-1, rows, cols), x.lo.reshape(-1, rows, cols)
        if hi.stride() != lo.stride():        # a float32 tensor's zero lo
            hi, lo = hi.contiguous(), lo.contiguous()
        return _dd._raw(hi, lo, x.ops)

    out = ops.dd_matmul(batched(a, M, K), batched(b, K, N))
    out = out.reshape(*lead, M, N)
    if a_vec:
        out = out[..., 0, :]
    if b_vec:
        out = out[..., 0]
    return out
