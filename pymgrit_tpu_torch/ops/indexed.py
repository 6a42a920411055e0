"""Kernel K21 ``indexed_combine`` (Triton, body in ``triton_kernels``) beside
its plain PyTorch version: the row gathers, drop-scatters and weighted sums
of non-uniform coarsening.

Replaces the index-based phases of pymgrit_tpu/core/solver.py on a level
whose C-points are not evenly strided (``LevelInfo.uniform`` False): the
ragged F-chains' g gather and drop-scatter (``_f_relax``, ``vector.take`` /
``vector.set_at(mode='drop')``), the C-runs' weighted update and scatter
(``_c_relax``), the FAS right-hand side at gathered C-rows
(``_fas_residual``), the indexed correction add (``_error_correction``,
``vector.add_at``) and nested iteration's indexed set.  One pass computes

    out[io[r]] = sum_k c_k * term_k[i_k[r]]      for every row r,

where each row index is optional (rows in order) and an output index equal
to the out tube's length drops the row (the padding of the ragged chains).
It is a fused elementwise pass with row gathers, bound by the bytes of the
rows it reads and writes: Triton serves it as well as CUDA C++ would (one
program per (row, block of columns); each program loads its row indices
itself).  The coefficients ride in a device tensor of the working dtype
(Triton types a Python float as float32), and the sum runs left to right,
so it rounds as the plain version does; NaN propagates.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the Triton kernel or raise.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.ops import triton_kernels
from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _require

MAX_TERMS = 3


def indexed_combine_plain(out, terms, coeffs, io=None, idx=()):
    """out[io] = sum_k coeffs[k] * terms[k][idx[k]] (index_select, then
    index_copy_ of the rows whose io is in range)."""
    idx = list(idx) + [None] * (len(terms) - len(idx))
    rows = [t if i is None else torch.index_select(t, 0, i) for t, i in zip(terms, idx)]
    acc = coeffs[0] * rows[0]
    for c, x in zip(coeffs[1:], rows[1:]):
        acc = acc + c * x
    if io is None:
        out.copy_(acc)
    else:
        keep = io < out.shape[0]
        out.index_copy_(0, io[keep], acc[keep])
    return out


def _check_index(name, key, i, R, device):
    _require(i.dtype == torch.int64 and i.dim() == 1 and i.is_contiguous(), name,
             f"{key} must be a contiguous 1-D int64 tensor")
    _require(i.shape[0] == R, name, f"{key} has {i.shape[0]} rows, expected {R}")
    _require(i.device == device, name, f"{key} is on {i.device}, expected {device}")


def indexed_combine(out, terms, coeffs, io=None, idx=()):
    """out[io[r]] = sum_k coeffs[k] * terms[k][idx[k][r]] for r < R (K21).

    out: a (T, N) row view; terms: 1..3 (T_k, N) row views; coeffs: Python
    floats; io, idx[k]: optional contiguous (R,) int64 tensors on the
    device (None, or an absent entry of idx: rows in order).  R is io's
    length, else out's row count; a term without an index has R rows.  Rows
    with io[r] == T are dropped; every other index must lie in its tensor
    (not checked: that would read the indices back to the host).  A term
    may share memory with out only where it is read at the rows it writes.
    Returns out.
    """
    name = "indexed_combine"
    terms, idx = list(terms), list(idx) + [None] * (len(terms) - len(idx))
    _require(1 <= len(terms) <= MAX_TERMS and len(coeffs) == len(terms)
             and len(idx) == len(terms), name,
             f"needs 1..{MAX_TERMS} terms with one coefficient and at most one index each")
    _check_operands(name, {"out": out, **{f"term{k}": t for k, t in enumerate(terms)}})
    _require(out.dim() == 2 and all(t.dim() == 2 and t.shape[1] == out.shape[1] for t in terms),
             name, "out and every term must be (rows, N) views of one N")
    R = io.shape[0] if io is not None else out.shape[0]
    if io is not None:
        _check_index(name, "io", io, R, out.device)
    for k, (t, i) in enumerate(zip(terms, idx)):
        if i is None:
            _require(t.shape[0] == R, name, f"term{k} has {t.shape[0]} rows, expected {R}")
        else:
            _check_index(name, f"idx{k}", i, R, out.device)
    if out.device.type == "cpu":
        return indexed_combine_plain(out, terms, coeffs, io, idx)
    N = out.shape[1]
    if R and N:
        xs = terms + [terms[0]] * (MAX_TERMS - len(terms))
        ii = [i if i is not None else out for i in idx] + [out] * (MAX_TERMS - len(idx))
        c = triton_kernels._coefficients(coeffs, out.dtype, out.device)
        grid = (R, -(-N // triton_kernels._BLOCK))
        with torch.cuda.device(out.device):
            triton_kernels._jit()["indexed_combine"][grid](
                out, io if io is not None else out, *xs, *ii, c, out.stride(0),
                *(x.stride(0) for x in xs), out.shape[0], N, NT=len(terms),
                HAS_IO=io is not None, HAS_I0=idx[0] is not None,
                HAS_I1=len(idx) > 1 and idx[1] is not None,
                HAS_I2=len(idx) > 2 and idx[2] is not None,
                BLOCK=triton_kernels._BLOCK, num_warps=4)
        indexed_combine.launches += 1
    return out


indexed_combine.launches = 0
