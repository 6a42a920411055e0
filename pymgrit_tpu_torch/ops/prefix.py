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
the kernel or raise.  Both take the one-call launch path (the checks, plan
and packed argument array cached by the operands' facts).
"""

from __future__ import annotations

import array
import functools

import torch

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.heat_kernels import (_check_facts, _contiguous, _launcher, _require,
                                                fact)
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


# K8's blocks (csrc/affine_prefix.cu: kWide, kNarrow), a narrow block's
# widest column group (kMaxW) and its tile buffers' shared memory at most
# (kNarrowSmem)
K8_WIDE_THREADS = 128
K8_NARROW_THREADS = 1024
K8_MAX_COLUMNS = 32
K8_NARROW_SMEM = 192 * 1024


def _tile_elements(R):
    """Elements of one of a narrow tile's buffers (csrc/affine_prefix.cu
    ``tile_elements``): 1024 R, with one element of padding every 32."""
    return K8_NARROW_THREADS * R + (K8_NARROW_THREADS * R - 1) // 32 + 1


def affine_prefix_plan(n, N, sms, streamed=1, es=8):
    """(regime, threads a block, columns a block W, segments a column S,
    rows a segment a tile R, grid) of one K8 launch on a card of ``sms``
    SMs, for n rows of N columns, ``streamed`` operands read row by row (A
    and b where their row stride is not 0, g where given) of ``es`` bytes
    an element.  "wide" where blocks of K8_WIDE_THREADS columns fill three
    quarters of the SMs (the TOMS width, 16129 columns: 127 blocks): a
    thread a column walks all n rows (S = 1, R = n).  Else "narrow": blocks
    of K8_NARROW_THREADS threads, W columns each (the least power of two up
    to K8_MAX_COLUMNS that keeps the blocks to one wave: Dahlquist's one
    column, W = 1), the rows walked in tiles of S = K8_NARROW_THREADS / W
    segments of R rows, as few tiles as K8_NARROW_SMEM holds and as even
    as they can be."""
    fill = -(-3 * sms // 4)
    if -(-N // K8_WIDE_THREADS) >= fill:
        return "wide", K8_WIDE_THREADS, K8_WIDE_THREADS, 1, n, -(-N // K8_WIDE_THREADS)
    W = 1
    while W < K8_MAX_COLUMNS and -(-N // W) > sms:
        W *= 2
    S = K8_NARROW_THREADS // W
    bufs = max(1, streamed)
    R_max = 1
    while bufs * _tile_elements(R_max + 1) * es <= K8_NARROW_SMEM:
        R_max += 1
    tiles = -(-n // (S * R_max))
    tile_rows = -(-n // tiles)
    return "narrow", K8_NARROW_THREADS, W, S, -(-tile_rows // S), -(-N // W)


def affine_prefix_pack(index, strides, n, N, plan):
    """The launcher's int64 argument array (csrc/affine_prefix.cu
    ``launch``): device, five pointers (filled in by each call: A, b, g or
    0, x0, out), the row strides of A, b, g, out, n, N, the regime (0 wide,
    1 narrow), columns a block, segments a column, rows a segment, grid."""
    regime, _, W, S, R, grid = plan
    return array.array("q", (index, *(0,) * 5, *strides, n, N, int(regime == "narrow"), W, S, R,
                             grid))


# affine_prefix's operands in the order of their facts
_PREFIX_KEYS = ("A", "b", "x0", "out", "g")


@functools.lru_cache(maxsize=256)
def _prefix_checked(facts):
    """Every check of a K8 call, on the ``fact``s of A, b, x0, out (and g),
    cached by them; returns (on the CPU, the launch: the argument array
    without pointers, the launcher and the device index; None on the CPU
    or with nothing to do)."""
    name = "affine_prefix"
    _check_facts(name, facts, _PREFIX_KEYS.__getitem__)
    fa, fb, (_, _, xshape, xstride), (dtype, device, oshape, ostride) = facts[:4]
    fg = facts[4] if len(facts) == 5 else None
    if len(oshape) != 2:
        _require(False, name, f"out has shape {tuple(oshape)}, expected (n, N)")
    n, N = oshape
    for key, f in (("A", fa), ("b", fb), ("g", fg)):
        if f is not None and tuple(f[2]) != (n, N):
            _require(False, name, f"{key} has shape {tuple(f[2])}, expected ({n}, {N})")
    if not (tuple(xshape) == (N,) and _contiguous(xshape, xstride)):
        _require(False, name, f"x0 must be a contiguous ({N},) row")
    if not (n <= 1 or ostride[0] >= N):
        _require(False, name, "out rows must not overlap")
    if device.type == "cpu" or n * N == 0:
        return device.type == "cpu", None
    strides = tuple(f[3][0] if f is not None else 0 for f in (fa, fb, fg)) + (ostride[0],)
    streamed = int(strides[0] != 0) + int(strides[1] != 0) + int(fg is not None)
    plan = affine_prefix_plan(n, N, _build.sm_count(device.index), streamed,
                              torch.finfo(dtype).bits // 8)
    args = affine_prefix_pack(device.index, strides, n, N, plan)
    return False, (args, _launcher("pm_affine_prefix", dtype), device.index)


def affine_prefix(A, b, x0, out, g=None):
    """All states of the affine recurrence, written into ``out``.

    A, b: (n, N) views (row stride 0 allowed); x0: (N,) contiguous; out:
    (n, N) view; g: optional (n, N) view added to b.  out must not overlap
    an input.  Returns out.

    The checks, the plan and the packed argument array are cached by the
    operands' facts (``_prefix_checked``); a call on the card fills in the
    pointers and makes one ctypes call.
    """
    ops = (A, b, x0, out) if g is None else (A, b, x0, out, g)
    on_cpu, launch = _prefix_checked(tuple(map(fact, ops)))
    if on_cpu:
        return affine_prefix_plain(A, b, x0, out, g)
    if launch is None:
        return out
    tmpl, fn, index = launch
    args = tmpl[:]
    args[1], args[2], args[4], args[5] = A.data_ptr(), b.data_ptr(), x0.data_ptr(), out.data_ptr()
    if g is not None:
        args[3] = g.data_ptr()
    _build.check(fn(args.buffer_info()[0], _build.stream(index)), "affine_prefix")
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
