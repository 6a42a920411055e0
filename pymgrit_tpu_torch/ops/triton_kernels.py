"""Kernels K3 ``residual_row_norms`` and K4 ``cpoint_combine`` (Triton),
each beside its plain PyTorch version.

K3 replaces pymgrit_tpu/core/solver.py ``_point_residual_norms`` with
``vector.batched_norm``: the per-C-point 2-norm of Phi(u_{c-1}) - u_c that
the convergence check reduces.  K4 replaces the elementwise parts of the
C-point phases in the same file: the weighted C update (``_c_relax``), the
FAS right-hand side ``g_tail`` (``_fas_residual``) and the coarse-grid
correction (``_error_correction``).  Both are bound by the bytes they read
(and, for K4, write): K3 reads two rows and writes one scalar per row, one
program per row with a blocked sum; K4 reads up to four strided row views
and writes one, one program per (row, block of N), fused into one pass.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the Triton kernel or raise.  ``triton`` is imported on the
first launch (the CPU tests import this module without it); the kernel
bodies below are plain functions until ``_jit()`` compiles them, and the
``tl`` name they use is bound then.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _require

tl = None            # triton.language, bound by _jit() on first launch
_JIT = {}            # kernel name -> triton.JITFunction
_COEF_CACHE = {}     # (coeffs, dtype, device) -> coefficient tensor

_BLOCK = 1024
MAX_TERMS = 4


def _row_norms_body(s_ptr, u_ptr, out_ptr, N, s_stride, u_stride,
                    BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=out_ptr.dtype.element_ty)
    for start in range(0, N, BLOCK):
        idx = start + offs
        mask = idx < N
        s = tl.load(s_ptr + row * s_stride + idx, mask=mask, other=0.0)
        u = tl.load(u_ptr + row * u_stride + idx, mask=mask, other=0.0)
        d = s - u
        acc += d * d
    tl.store(out_ptr + row, tl.sqrt(tl.sum(acc, axis=0)))


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


def _jit():
    """Import triton and compile-wrap the kernel bodies (once)."""
    global tl
    if not _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT["row_norms"] = triton.jit(_row_norms_body)
        _JIT["combine"] = triton.jit(_combine_body)
    return _JIT


# ---------------------------------------------------------------------------
# K3 residual_row_norms
# ---------------------------------------------------------------------------


def residual_row_norms_plain(s, u):
    """Per-row 2-norm of s - u: (R, N), (R, N) -> (R,)."""
    return torch.sqrt(torch.sum(torch.square(s - u), dim=1))


def residual_row_norms(s, u):
    """||s_i - u_i||_2 for every row i of two (R, N) row views."""
    name = "residual_row_norms"
    _check_operands(name, dict(s=s, u=u))
    _require(s.dim() == 2 and s.shape == u.shape, name,
             f"s {tuple(s.shape)} and u {tuple(u.shape)} must be equal (R, N) views")
    if s.device.type == "cpu":
        return residual_row_norms_plain(s, u)
    R, N = s.shape
    out = torch.empty(R, dtype=s.dtype, device=s.device)
    if R:
        with torch.cuda.device(s.device):
            _jit()["row_norms"][(R,)](s, u, out, N, s.stride(0), u.stride(0),
                                      BLOCK=_BLOCK, num_warps=4)
        residual_row_norms.launches += 1
    return out


residual_row_norms.launches = 0


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
