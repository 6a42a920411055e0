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
the kernel or raise.  K9 takes the one-call launch path (its checks, plan
and packed argument array cached by the operands' facts).
"""

from __future__ import annotations

import array
import functools
import math

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import (_check_facts, _check_operands, _launcher,
                                                _require, fact)
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


# K9's largest block (csrc/affine_windows.cu: kMaxThreads) and its run of
# lanes a thread
K9_THREADS = 256
K9_LANES = 32


def affine_windows_plan(nt, N, k, sms):
    """(lanes a thread Q, runs a column, threads a block, grid) of one K9
    launch on a card of ``sms`` SMs: a thread owns one column's run of Q =
    K9_LANES consecutive lanes, so a row is loaded once for Q lanes, where
    k > Q (a run then has its fixed shape) and the runs still fill 4 blocks
    of K9_THREADS an SM (the TOMS width); else Q = 1 (the short or narrow
    tubes, Dahlquist's one column: their rows stay in the caches, and the
    lanes' parallelism is what counts); blocks of K9_THREADS where the
    threads fill 2 blocks an SM, else of 64."""
    wide = k > K9_LANES and N * -(-nt // K9_LANES) >= 4 * K9_THREADS * sms
    Q = K9_LANES if wide else 1
    runs = -(-nt // Q)
    threads = N * runs
    block = K9_THREADS if threads >= 2 * K9_THREADS * sms else 64
    return Q, runs, block, max(1, -(-threads // block))


def affine_windows_pack(index, strides, nt, N, k, rows, plan):
    """The launcher's int64 argument array (csrc/affine_windows.cu
    ``launch``): device, five pointers (filled in by each call: u, A, b, g,
    out), the row strides of u, A, b, g, out, nt, N, k, Q, runs a column,
    A or b with rows (a row stride that is not 0), threads a block,
    grid."""
    Q, runs, block, grid = plan
    return array.array("q", (index, *(0,) * 5, *strides, nt, N, k, Q, runs, int(rows), block,
                             grid))


@functools.lru_cache(maxsize=256)
def _windows_checked(facts, k):
    """Every check of a K9 call that its operands' ``fact``s decide (u, A,
    b, g, out) and k, cached by them (the overlap of out and u is checked
    on every call); returns (on the CPU, the launch: the argument array
    without pointers, the launcher and the device index; None on the CPU or
    with nothing to do)."""
    name = "affine_windows"
    _check_facts(name, facts, ("u", "A", "b", "g", "out").__getitem__)
    (dtype, device, ushape, ustride), fa, fb, fg, fo = facts
    if not (len(ushape) == 2 and ushape[0] >= 1):
        _require(False, name, f"u has shape {tuple(ushape)}, expected (nt, N)")
    nt, N = ushape
    for key, f, rows in (("out", fo, nt), ("A", fa, nt - 1), ("b", fb, nt - 1),
                         ("g", fg, nt - 1)):
        if tuple(f[2]) != (rows, N):
            _require(False, name, f"{key} has shape {tuple(f[2])}, expected ({rows}, {N})")
    if k < 1:
        _require(False, name, f"k = {k} must be >= 1")
    if device.type == "cpu" or N == 0:
        return device.type == "cpu", None
    strides = tuple(f[3][0] for f in (facts[0], fa, fb, fg, fo))
    args = affine_windows_pack(device.index, strides, nt, N, k, fa[3][0] != 0 or fb[3][0] != 0,
                               affine_windows_plan(nt, N, k, _build.sm_count(device.index)))
    return False, (args, _launcher("pm_affine_windows", dtype), device.index)


def affine_windows(u, A, b, g, out, k):
    """AT-MGRIT's truncated windows of an affine step, written into ``out``.

    u: (nt, N) view (the coarse tube); A, b, g: (nt-1, N) views, row i-1 the
    step into point i (A and b may have row stride 0); out: (nt, N) view that
    must not overlap u; k >= 1 the window length.  Returns out.

    The checks, the plan and the packed argument array are cached by the
    operands' facts and k (``_windows_checked``); a call on the card checks
    the overlap of out and u, fills in the pointers and makes one ctypes
    call.
    """
    k = int(k)
    on_cpu, launch = _windows_checked((fact(u), fact(A), fact(b), fact(g), fact(out)), k)
    if out.data_ptr() == u.data_ptr() or _overlaps_partially(out, u):
        _require(False, "affine_windows", "out must not overlap u")
    if on_cpu:
        return affine_windows_plain(u, A, b, g, out, k)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1], args[2], args[3] = u.data_ptr(), A.data_ptr(), b.data_ptr()
    args[4], args[5] = g.data_ptr(), out.data_ptr()
    _build.check(fn(args.buffer_info()[0], _build.stream(index)), "affine_windows")
    affine_windows.launches += 1
    return out


affine_windows.launches = 0
