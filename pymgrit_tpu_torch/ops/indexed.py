"""Kernel K21 ``indexed_combine`` (CUDA C++, ``csrc/indexed_combine.cu``)
beside its plain PyTorch version: the row gathers, drop-scatters and
weighted sums of non-uniform coarsening.

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
It is bound by the bytes of the rows it reads and writes, and a call is
small (a ragged65 gather moves 35 MB in about 0.01 ms), so the wrapper's
host time counts as much as the kernel: the checks, the launch plan
(``plan``: vector width, segments a row, grid) and the argument array
(``pack``) are cached by the operands' dtype, device, shapes and strides
(``_checked``), no message is formatted unless a check fails, and the
launch is one ctypes call with the array, this call's pointers filled in,
and the coefficients as doubles, which the kernel takes by value.  The sum
runs left to right with each product and sum rounded once, so the kernel
equals the plain version bit for bit; NaN propagates.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import array
import functools

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import _check_facts, _launcher, _require, fact

MAX_TERMS = 3
# the kernel's launch shape (csrc/indexed_combine.cu: kThreads, kMinBlocks,
# kUnroll): a warp item is one segment of 32 x UNROLL[terms] vectors
THREADS, BLOCKS_PER_SM = 256, 4
UNROLL = {1: 4, 2: 2, 3: 2}


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
    """Checks of an index tensor's ``fact``."""
    dtype, dev, shape, stride = i
    if not (dtype == torch.int64 and len(shape) == 1 and (shape[0] <= 1 or stride[0] == 1)):
        _require(False, name, f"{key} must be a contiguous 1-D int64 tensor")
    if shape[0] != R:
        _require(False, name, f"{key} has {shape[0]} rows, expected {R}")
    if dev != device:
        _require(False, name, f"{key} is on {dev}, expected {device}")


def _key(k):
    return "out" if k == 0 else f"term{k - 1}"


@functools.lru_cache(maxsize=1024)
def _checked(facts, io, idx):
    """Every check of a call on the ``fact``s of out and the terms, of io
    (or None) and of each term's index (or None), cached by them; returns
    (R, on the CPU, the launch: the argument array without pointers, the
    launcher and the device index; None on the CPU or with nothing to
    do)."""
    name = "indexed_combine"
    _check_facts(name, facts, _key)
    dtype, device, shape = facts[0][:3]
    N = shape[-1]
    if not (len(shape) == 2 and all(len(f[2]) == 2 and f[2][1] == N for f in facts[1:])):
        _require(False, name, "out and every term must be (rows, N) views of one N")
    R = io[2][0] if io is not None else shape[0]
    if io is not None:
        _check_index(name, "io", io, R, device)
    for k, (f, i) in enumerate(zip(facts[1:], idx)):
        if i is None:
            if f[2][0] != R:
                _require(False, name, f"term{k} has {f[2][0]} rows, expected {R}")
        else:
            _check_index(name, f"idx{k}", i, R, device)
    on_cpu, launch = device.type == "cpu", None
    if not on_cpu and R and N:
        nt, index, strides = len(facts) - 1, device.index, tuple(f[3][0] for f in facts)
        p = plan(R, N, dtype.itemsize, nt, _build.sm_count(index))
        launch = (pack(index, (0,) * (nt + 1), 0, (0,) * nt, strides, shape[0], R, N, nt, p),
                  _launcher("pm_indexed_combine", dtype), index)
    return R, on_cpu, launch


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
    nt = len(terms)
    if not (1 <= nt <= MAX_TERMS and len(coeffs) == nt and len(idx) <= nt):
        _require(False, "indexed_combine",
                 f"needs 1..{MAX_TERMS} terms with one coefficient and at most one index each")
    if len(idx) < nt:
        idx = (*idx, *(None,) * (nt - len(idx)))
    R, on_cpu, launch = _checked(
        (fact(out), *map(fact, terms)), None if io is None else fact(io),
        tuple([None if i is None else fact(i) for i in idx]))
    if on_cpu:
        return indexed_combine_plain(out, terms, coeffs, io, idx)
    if launch is not None:
        _launch(launch, out, terms, coeffs, io, idx)
        indexed_combine.launches += 1
    return out


indexed_combine.launches = 0


def _launch(launch, out, terms, coeffs, io, idx):
    """One launch of K21 on checked operands (idx: one entry a term): the
    cached argument array (``_checked``) with this call's pointers filled
    in."""
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1] = out.data_ptr()
    if io is not None:
        args[2] = io.data_ptr()
    for k in range(len(terms)):
        args[3 + k] = terms[k].data_ptr()
        if idx[k] is not None:
            args[6 + k] = idx[k].data_ptr()
    c = (*coeffs, 0.0, 0.0)
    status = fn(args.buffer_info()[0], float(c[0]), float(c[1]), float(c[2]),
                _build.stream(index))
    _build.check(status, "indexed_combine")


def plan(R, N, es, nt, sms):
    """(vector width, segments a row, grid) of one launch.

    R rows of N elements of es bytes, nt terms, sms: the card's SM count.
    The vector width is 16 bytes' worth of elements; the kernel decides row
    by row whether a row takes it (every operand's row pointer at one offset
    from 16-byte alignment) or scalar loads, with the same segments.  A
    segment is 32 x UNROLL[nt] vectors; the grid is the card's resident
    blocks, or fewer where the rows' segments do not fill them (a block
    holds THREADS / 32 warps, one item each).
    """
    vec = 16 // es
    segs = -(-N // (32 * UNROLL[nt] * vec))
    grid = max(1, min(sms * BLOCKS_PER_SM, -(-R * segs // (THREADS // 32))))
    return vec, segs, grid


def pack(index, ptrs, io, idx, strides, T, R, N, nt, plan):
    """The launcher's int64 argument array (csrc/indexed_combine.cu
    ``launch``): device, out, io, x0-x2, i0-i2 (0: none), out's and x0-x2's
    row strides, T, R, N, segments a row, terms, vector width, grid.  ptrs
    and strides: out's, then each term's.  (An ``array`` of int64: its
    buffer's address is the launcher's argument; it builds faster than a
    ctypes array.)"""
    vec, segs, grid = plan
    pad = (0,) * (MAX_TERMS - nt)
    return array.array("q", (index, ptrs[0], io, *ptrs[1:], *pad, *idx, *pad, *strides, *pad,
                             T, R, N, segs, nt, vec, grid))
