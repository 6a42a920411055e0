"""Coarsest-level solves for elementwise affine steps: kernels K8
``affine_prefix`` and K9 ``affine_windows`` (CUDA C++), each beside its
plain PyTorch version.

Counterpart of ``pymgrit_tpu/ops/prefix.py`` and of the truncated windows
of ``pymgrit_tpu/core/at_mgrit.py``.  A step that is affine and elementwise
in the state,

    u_k = A_k * u_{k-1} + c_k,

covers Dahlquist (all four integrators) and the spectral heat models.
Affine maps compose associatively, (A2, c2) o (A1, c1) = (A2 A1, A2 c1 + c2),
so all n states follow in O(log n) depth instead of n sequential steps
(``Mgrit(coarsest_prefix=True)``); AT-MGRIT instead lets every coarsest
point re-integrate only its last k-1 steps (``AtMgrit(k)``).

Operands are (rows, N) views whose last axis is contiguous; A and b may
have row stride 0 (one row broadcast over every step).  Dispatch as in
``heat_kernels``: CPU tensors go to the plain version, CUDA tensors launch
the kernel or raise.
"""

from __future__ import annotations

import math

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _launcher, _require
from pymgrit_tpu_torch.ops.indexed import _overlaps_partially


def affine_prefix_states(A, c, x0):
    """All states of ``u_k = A_k * u_{k-1} + c_k`` for k = 1..n.

    A and c are (n, ...) tensors that broadcast against the state x0;
    returns the (n, ...) tube ``[u_1, ..., u_n]`` (x0 itself is not
    included).  A log-depth doubling scan: round d composes every map with
    the one d steps before it, so after ceil(log2 n) rounds entry k holds
    the composition of steps 1..k.  Products of many factors may underflow
    to 0, which is harmless (no division by them)."""
    shape = torch.broadcast_shapes(A.shape, c.shape, (A.shape[0],) + tuple(x0.shape))
    A_cum = torch.broadcast_to(A, shape).clone()
    c_cum = torch.broadcast_to(c, shape).clone()
    n, d = shape[0], 1
    while d < n:
        A_hi, c_hi = A_cum[d:], c_cum[d:]
        c_new = A_hi * c_cum[:n - d] + c_hi
        A_hi.mul_(A_cum[:n - d].clone())
        c_hi.copy_(c_new)
        d *= 2
    return A_cum * x0 + c_cum


# ---------------------------------------------------------------------------
# K8 affine_prefix
# ---------------------------------------------------------------------------


def affine_prefix_plain(A, b, x0, out, g=None):
    """out[k] = A[k] * out[k-1] + (b[k] [+ g[k]]), out[-1] = x0."""
    c = b if g is None else b + g
    out.copy_(affine_prefix_states(A, c, x0))
    return out


def _rows_view(name, key, t, n, N):
    _require(t.dim() == 2 and tuple(t.shape) == (n, N), name,
             f"{key} has shape {tuple(t.shape)}, expected ({n}, {N})")


def affine_prefix(A, b, x0, out, g=None):
    """All states of the affine recurrence, written into ``out``.

    A, b: (n, N) views (row stride 0 allowed); x0: (N,) contiguous; out:
    (n, N) view; g: optional (n, N) view added to b.  out must not overlap
    an input.  Returns out.
    """
    name = "affine_prefix"
    ops = dict(A=A, b=b, x0=x0, out=out)
    if g is not None:
        ops["g"] = g
    _check_operands(name, ops)
    _require(out.dim() == 2, name, f"out has shape {tuple(out.shape)}, expected (n, N)")
    n, N = out.shape
    for key, t in dict(A=A, b=b, g=g).items():
        if t is not None:
            _rows_view(name, key, t, n, N)
    _require(tuple(x0.shape) == (N,) and x0.is_contiguous(), name,
             f"x0 must be a contiguous ({N},) row")
    _require(out.stride(0) >= N or n <= 1, name, "out rows must not overlap")
    if out.device.type == "cpu":
        return affine_prefix_plain(A, b, x0, out, g)
    if n == 0 or N == 0:
        return out
    chunk = math.isqrt(n - 1) + 1                     # ceil(sqrt(n))
    nchunks = -(-n // chunk)
    P = torch.empty((nchunks, N), dtype=out.dtype, device=out.device)
    C = torch.empty_like(P)
    fn = _launcher("pm_affine_prefix", out.dtype)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    status = fn(A.data_ptr(), A.stride(0), b.data_ptr(), b.stride(0),
                g.data_ptr() if g is not None else None, g.stride(0) if g is not None else 0,
                x0.data_ptr(), out.data_ptr(), out.stride(0), P.data_ptr(), C.data_ptr(),
                n, N, chunk, stream)
    _build.check(status, name)
    affine_prefix.launches += 1
    return out


affine_prefix.launches = 0


# ---------------------------------------------------------------------------
# K9 affine_windows
# ---------------------------------------------------------------------------


def _step_rows(t, idx):
    """Rows idx of a (rows, N) view (one row for a row-stride-0 view)."""
    return t[:1] if t.stride(0) == 0 else t[idx]


def affine_windows_plain(u, A, b, g, out, k):
    """Lane p: x = u[max(0, p-k+1)], then x = g[i-1] + (A[i-1] x + b[i-1])
    for i = max(0, p-k+1)+1 .. p; out[p] = x.  Masked steps over all lanes,
    as ``pymgrit_tpu.AtMgrit`` runs them."""
    nt = u.shape[0]
    p = torch.arange(nt, device=u.device)
    ws = torch.clamp(p - k + 1, min=0)
    x = u[ws]
    for s in range(1, min(k, nt)):
        i = ws + s
        r = torch.clamp(i, max=nt - 1) - 1
        stepped = g[r] + (_step_rows(A, r) * x + _step_rows(b, r))
        x = torch.where((i <= p)[:, None], stepped, x)
    out.copy_(x)
    return out


def affine_windows(u, A, b, g, out, k):
    """AT-MGRIT's truncated windows of an affine step, written into ``out``.

    u: (nt, N) view (the coarse tube); A, b, g: (nt-1, N) views, row i-1 the
    step into point i (A and b may have row stride 0); out: (nt, N) view that
    must not overlap u; k >= 1 the window length.  Returns out.
    """
    name = "affine_windows"
    _check_operands(name, dict(u=u, A=A, b=b, g=g, out=out))
    _require(u.dim() == 2 and u.shape[0] >= 1, name,
             f"u has shape {tuple(u.shape)}, expected (nt, N)")
    nt, N = u.shape
    _rows_view(name, "out", out, nt, N)
    for key, t in dict(A=A, b=b, g=g).items():
        _rows_view(name, key, t, nt - 1, N)
    _require(int(k) >= 1, name, f"k = {k} must be >= 1")
    _require(out.data_ptr() != u.data_ptr() and not _overlaps_partially(out, u), name,
             "out must not overlap u")
    if u.device.type == "cpu":
        return affine_windows_plain(u, A, b, g, out, int(k))
    if N == 0:
        return out
    fn = _launcher("pm_affine_windows", u.dtype)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    status = fn(u.data_ptr(), u.stride(0), A.data_ptr(), A.stride(0), b.data_ptr(), b.stride(0),
                g.data_ptr(), g.stride(0), out.data_ptr(), out.stride(0), nt, N, int(k), stream)
    _build.check(status, name)
    affine_windows.launches += 1
    return out


affine_windows.launches = 0
