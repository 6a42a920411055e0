"""Kernels K18 ``restrict_combine`` (CUDA C++, ``csrc/restrict_combine.cu``)
and K19 ``interpolate_combine`` (CUDA C++, ``csrc/interpolate_combine.cu``)
beside their plain PyTorch versions: the heat grid transfers of
pymgrit_tpu/models/grid_transfer_heat.py fused with the solver phase around
them.

* Restriction R: 1D full weighting ``[1/4, 1/2, 1/4]`` between nested
  interior-point Dirichlet grids (fine n -> coarse (n - 1) / 2,
  ``GridTransferHeat.restriction``), or 2D injection ``u[::2, ::2]``
  between nested vertex grids with their ring (fine 2n - 1 -> coarse n,
  ``GridTransferHeat2D.restriction``).
* Interpolation P: 1D linear interpolation with zero Dirichlet ends (coarse
  n -> fine 2n + 1, ``GridTransferHeat.interpolation``), or 2D bilinear
  interpolation (coarse n -> fine 2n - 1: a copy at coincident vertices,
  two-point means on edges, four-point means at cell centres,
  ``_interp_1d_vertex`` along axis 0, then axis 1).

K18 computes ``out = R(sum_k c_k x_k) + sum_j d_j y_j`` over the rows of a
tube: the FAS right-hand side of ``Mgrit._fas_residual`` (terms
``Phi(u[cm-1]), u[cm](, g[cm])``, adds ``v_c, Phi_c(v_c)``), and with one
term and no add the heat transfers' batched ``restriction``.  K19 computes
``dst += P(a - b)`` (the coarse-grid correction of ``_error_correction``) or
``dst = P(a)`` (nested iteration, the batched ``interpolation``).  Both
are passes of reads, stencil weights and sums, bound by the bytes they
move; the combination and the transfer never meet device memory in
between, where the unfused route writes the combined fine rows, reads them
back to restrict, and runs K4 after.  Both round each difference, product
and sum once, in the plain version's order, so they equal their plain
versions bit for bit.  Their calls are small (spatial65's FAS call moves
45 MB in about 0.013 ms, the 1D example's a few kB), so the wrappers keep
host time down: every check but the overlaps, the launch plan (a grid and
its stride through the flat range of points, ``restrict_plan`` /
``interpolate_plan``) and the argument array (``restrict_pack`` /
``interpolate_pack``) are cached by the operands' dtype, device, shapes
and strides (``_restrict_checked`` / ``_interp_checked``), messages are
formatted only on failure, and the launch is one ctypes call: K18's with
the array, this call's pointers filled in, and the coefficients as
doubles; K19's with the cached array and the three pointers.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import array
import functools

import torch

from pymgrit_tpu_torch.ops import _build, triton_kernels
from pymgrit_tpu_torch.ops.heat_kernels import (_check_facts, _contiguous, _launcher, _require,
                                                fact)

MAX_TERMS, MAX_ADDS = 3, 2
# K18's launch shape (csrc/restrict_combine.cu: kThreads, kMinBlocks,
# U): coarse points a thread handles a pass, by dim
THREADS, BLOCKS_PER_SM = 256, 4
UNROLL = {1: 2, 2: 4}
# K19's (csrc/interpolate_combine.cu: kThreads, kMinBlocks, U): fine
# points a thread handles a pass
INTERP_THREADS, INTERP_BLOCKS_PER_SM, INTERP_UNROLL = 256, 4, 4


# ---------------------------------------------------------------------------
# the transfers on the trailing axes (one state or a batch of states)
# ---------------------------------------------------------------------------


def full_weighting(u):
    """1D full-weighting restriction along the last axis: n -> (n - 1) / 2."""
    return u[..., :-2:2] * 0.25 + u[..., 1:-1:2] * 0.5 + u[..., 2::2] * 0.25


def linear_interpolation(u):
    """1D linear interpolation along the last axis, zero Dirichlet ends:
    n -> 2n + 1 (the scatter-adds of the JAX version, in its order)."""
    n = u.shape[-1]
    even = torch.zeros(u.shape[:-1] + (n + 1,), dtype=u.dtype, device=u.device)
    even[..., :-1] += 0.5 * u
    even[..., 1:] += 0.5 * u
    out = torch.empty(u.shape[:-1] + (2 * n + 1,), dtype=u.dtype, device=u.device)
    out[..., 1::2] = u
    out[..., ::2] = even
    return out


def injection(u):
    """2D injection along the last two axes: coarse[i, j] = fine[2i, 2j]."""
    return u[..., ::2, ::2]


def _interp_vertex(u, axis):
    u = u.movedim(axis, 0)
    n = u.shape[0]
    out = torch.empty((2 * n - 1,) + tuple(u.shape[1:]), dtype=u.dtype, device=u.device)
    out[::2] = u
    out[1::2] = 0.5 * (u[:-1] + u[1:])
    return out.movedim(0, axis)


def bilinear_interpolation(u):
    """2D bilinear interpolation along the last two axes: n -> 2n - 1."""
    return _interp_vertex(_interp_vertex(u, -2), -1)


_RESTRICT = {1: full_weighting, 2: injection}
_INTERPOLATE = {1: linear_interpolation, 2: bilinear_interpolation}


def coarse_shape(fine, dim):
    if dim == 1:
        return ((fine[0] - 1) // 2,)
    return tuple((n + 1) // 2 for n in fine)


def fine_shape(coarse, dim):
    if dim == 1:
        return (2 * coarse[0] + 1,)
    return tuple(2 * n - 1 for n in coarse)


# ---------------------------------------------------------------------------
# K18 restrict_combine
# ---------------------------------------------------------------------------


def restrict_combine_plain(out, terms, coeffs, adds=(), add_coeffs=(), dim=1):
    """out = R(sum_k coeffs[k] terms[k]) + (sum_j add_coeffs[j] adds[j]),
    each sum left to right."""
    acc = coeffs[0] * terms[0]
    for c, x in zip(coeffs[1:], terms[1:]):
        acc = acc + c * x
    r = _RESTRICT[dim](acc)
    if adds:
        s = add_coeffs[0] * adds[0]
        for d, y in zip(add_coeffs[1:], adds[1:]):
            s = s + d * y
        r = r + s
    out.copy_(r)
    return out


def _states_contiguous(t):
    """True iff every state (row) of the (R, ...) batch t is contiguous."""
    return _contiguous_states(t.shape, t.stride())


@functools.lru_cache(maxsize=1024)
def _contiguous_states(shape, stride):
    return _contiguous(shape[1:], stride[1:])


def contiguous_states(t):
    """t, or a copy of it where its states are not contiguous (rows may
    keep any stride)."""
    return t if _states_contiguous(t) else t.contiguous()


def _check_state_facts(name, key, shape, stride, R, want):
    if shape != (R, *want):
        _require(False, name, f"{key} has shape {tuple(shape)}, expected {(R,) + tuple(want)}")
    if not _contiguous_states(shape, stride):
        _require(False, name, f"{key} must hold each state contiguously")


def _restrict_key(nt):
    def key(k):
        return "out" if k == 0 else f"term{k - 1}" if k <= nt else f"add{k - 1 - nt}"
    return key


@functools.lru_cache(maxsize=1024)
def _restrict_checked(dim, nt, facts):
    """Every check of a K18 call but the overlaps, on the ``fact``s of out,
    the terms and the adds, cached by them; returns (R, on the CPU, the
    element size, which operands are empty, the launch: the argument array
    without pointers, the launcher and the device index; None on the CPU
    or with no rows)."""
    name = "restrict_combine"
    _check_facts(name, facts, _restrict_key(nt))
    (dtype, device, oshape, _), t0 = facts[0], facts[1]
    if not (len(oshape) == dim + 1 and len(t0[2]) == dim + 1):
        _require(False, name, f"out and the terms must be (R, ...) batches of {dim}D states")
    R, fine = t0[2][0], tuple(t0[2][1:])
    if dim == 2 and not (fine[0] % 2 == 1 and fine[1] % 2 == 1):
        _require(False, name, f"2D fine states need odd sides, got {fine}")
    if min(fine) < 3:
        _require(False, name, f"fine states {fine} are too small")
    coarse = coarse_shape(fine, dim)
    for k, f in enumerate(facts[1:nt + 1]):
        _check_state_facts(name, f"term{k}", f[2], f[3], R, fine)
    for k, f in enumerate(facts[nt + 1:]):
        _check_state_facts(name, f"add{k}", f[2], f[3], R, coarse)
    _check_state_facts(name, "out", oshape, facts[0][3], R, coarse)
    on_cpu, launch = device.type == "cpu", None
    if not on_cpu and R:
        nf = fine[0] if dim == 1 else fine[0] * fine[1]
        if nf > 2 ** 31 - 1:
            _require(False, name, f"fine states of {nf} points exceed 2^31 - 1")
        index, na = device.index, len(facts) - 1 - nt
        Pc, Qc = (1, coarse[0]) if dim == 1 else coarse
        plan = restrict_plan(R, Pc, Qc, dim, _build.sm_count(index))
        launch = (restrict_pack(index, (0,) * len(facts), tuple(f[3][0] for f in facts), nt, na,
                                R, fine[-1], Pc, Qc, dim, plan),
                  _launcher("pm_restrict_combine", dtype), index)
    return R, on_cpu, dtype.itemsize, tuple(0 in f[2] for f in facts), launch


def restrict_combine(out, terms, coeffs, adds=(), add_coeffs=(), dim=1):
    """out_r = R(sum_k coeffs[k] terms[k]_r) + sum_j add_coeffs[j] adds[j]_r
    for every row r (K18).

    terms: 1..3 (R, *fine) views; adds: 0..2 (R, *coarse) views; out: an
    (R, *coarse) view; each state contiguous, rows at any stride.  dim 1:
    fine (n,), coarse ((n - 1) / 2,), R full weighting; dim 2: fine (P, Q)
    odd, coarse ((P + 1) / 2, (Q + 1) / 2), R injection.  coeffs and
    add_coeffs are Python floats.  out must not overlap an input other than
    as the same view of an add.  Returns out.
    """
    name = "restrict_combine"
    nt, na = len(terms), len(adds)
    if dim not in (1, 2):
        _require(False, name, "dim must be 1 or 2")
    if not (1 <= nt <= MAX_TERMS and len(coeffs) == nt):
        _require(False, name, f"needs 1..{MAX_TERMS} terms with one coefficient each")
    if not (na <= MAX_ADDS and len(add_coeffs) == na):
        _require(False, name, f"takes 0..{MAX_ADDS} adds with one coefficient each")
    ops = (out, *terms, *adds)
    R, on_cpu, es, empty, launch = _restrict_checked(dim, nt, tuple(map(fact, ops)))
    # out may share memory with an input only as the same view or as rows
    # interleaved with it, and with an input of another shape not at all;
    # storages are told apart by their base pointers (no storage object),
    # and an empty tensor overlaps nothing
    ptrs = [t.data_ptr() for t in ops]
    base = ptrs[0] - out.storage_offset() * es
    for k in range(1, len(ops)):
        t = ops[k]
        if (ptrs[k] - t.storage_offset() * es == base and not (empty[0] or empty[k])
                and not (out.shape == t.shape and not triton_kernels._overlaps_partially(
                    out.view(out.shape[0], -1), t.view(t.shape[0], -1)))):
            _require(False, name, f"out overlaps {_restrict_key(nt)(k)}")
    if on_cpu:
        return restrict_combine_plain(out, terms, coeffs, adds, add_coeffs, dim)
    if launch is not None:
        _launch_restrict(launch, ptrs, coeffs, add_coeffs)
        restrict_combine.launches += 1
    return out


restrict_combine.launches = 0


def _launch_restrict(launch, ptrs, coeffs, add_coeffs):
    """One launch of K18: the cached argument array (``_restrict_checked``)
    with this call's pointers (out's, the terms', the adds') filled in."""
    tmpl, fn, index = launch
    nt = len(coeffs)
    args = tmpl[:]
    args[1] = ptrs[0]
    for k in range(nt):
        args[2 + k] = ptrs[1 + k]
    for k in range(len(add_coeffs)):
        args[5 + k] = ptrs[1 + nt + k]
    c, d = (*coeffs, 0.0, 0.0), (*add_coeffs, 0.0, 0.0)
    status = fn(args.buffer_info()[0], float(c[0]), float(c[1]), float(c[2]), float(d[0]),
                float(d[1]), _build.stream(index))
    _build.check(status, "restrict_combine")


def restrict_plan(R, Pc, Qc, dim, sms):
    """(grid, dr, di, dj) of one K18 launch on R rows of Pc x Qc coarse
    points (Pc = 1 in 1D) on a card of sms SMs (``stride_plan``)."""
    return stride_plan(R, Pc, Qc, THREADS, UNROLL[dim], sms * BLOCKS_PER_SM)


@functools.lru_cache(maxsize=256)
def stride_plan(R, P, Q, threads, unroll, blocks):
    """(grid, dr, di, dj) of a launch that walks R rows of P x Q points as one
    flat range: ``blocks`` blocks of ``threads`` (the card's resident
    blocks), or fewer where the points do not fill them at ``unroll`` a
    thread; and the grid's stride S = grid x threads points split as
    S = (dr P + di) Q + dj, which the kernel adds to a point's (row, point
    row, point) with carries instead of dividing."""
    grid = max(1, min(blocks, -(-R * P * Q // (threads * unroll))))
    dr, rem = divmod(grid * threads, P * Q)
    di, dj = divmod(rem, Q)
    return grid, dr, di, dj


def restrict_pack(index, ptrs, strides, nt, na, R, Qf, Pc, Qc, dim, plan):
    """The launcher's int64 argument array (csrc/restrict_combine.cu
    ``launch``): device, out, x0-x2, y0-y1 (0: none), out's, x0-x2's and
    y0-y1's row strides, R, Qf (a fine row's length, the fine n in 1D), Pc,
    Qc, dim, terms, adds, then the plan: grid, dr, di, dj.  ptrs and
    strides: out's, the nt terms', the na adds'.  (An ``array`` of int64:
    its buffer's address is the launcher's argument.)"""
    xp, yp = (0,) * (MAX_TERMS - nt), (0,) * (MAX_ADDS - na)
    return array.array("q", (index, ptrs[0], *ptrs[1:nt + 1], *xp, *ptrs[nt + 1:], *yp,
                             strides[0], *strides[1:nt + 1], *xp, *strides[nt + 1:], *yp,
                             R, Qf, Pc, Qc, dim, nt, na, *plan))


# ---------------------------------------------------------------------------
# K19 interpolate_combine
# ---------------------------------------------------------------------------


def interpolate_combine_plain(dst, a, b=None, dim=1):
    """dst += P(a - b), or dst = P(a) without b."""
    if b is None:
        dst.copy_(_INTERPOLATE[dim](a))
    else:
        dst.copy_(dst + _INTERPOLATE[dim](a - b))
    return dst


@functools.lru_cache(maxsize=1024)
def _interp_checked(dim, facts):
    """Every check of a K19 call but the overlaps, on the ``fact``s of dst,
    a (and b), cached by them; returns (on the CPU, the element size, which
    operands are empty, the launch: the argument array, its address, the
    launcher and the device index; None on the CPU or with no rows)."""
    name = "interpolate_combine"
    _check_facts(name, facts, ("dst", "a", "b").__getitem__)
    (dtype, device, dshape, dstride), (_, _, ashape, _) = facts[0], facts[1]
    if not (len(ashape) == dim + 1 and len(dshape) == dim + 1):
        _require(False, name, f"dst and a must be (R, ...) batches of {dim}D states")
    R, coarse = ashape[0], tuple(ashape[1:])
    if not all(n >= (1 if dim == 1 else 2) for n in coarse):
        _require(False, name, f"coarse states {coarse} are too small")
    fine = fine_shape(coarse, dim)
    for key, f in zip(("a", "b"), facts[1:]):
        _check_state_facts(name, key, f[2], f[3], R, coarse)
    _check_state_facts(name, "dst", dshape, dstride, R, fine)
    on_cpu, launch = device.type == "cpu", None
    if not on_cpu and R:
        (Pc, Qc), (Pf, Qf) = ((1, coarse[0]), (1, fine[0])) if dim == 1 else (coarse, fine)
        if Pf * Qf > 2 ** 31 - 1:
            _require(False, name, f"fine states of {Pf * Qf} points exceed 2^31 - 1")
        index = device.index
        plan = interpolate_plan(R, Pf, Qf, _build.sm_count(index))
        args = interpolate_pack(index, tuple(f[3][0] for f in facts), R, Pc, Qc, Pf, Qf, dim,
                                plan)
        launch = (args, args.buffer_info()[0], _launcher("pm_interpolate_combine", dtype), index)
    return on_cpu, dtype.itemsize, tuple(0 in f[2] for f in facts), launch


def interpolate_combine(dst, a, b=None, dim=1):
    """dst_r += P(a_r - b_r), or dst_r = P(a_r) without b, for every row r
    (K19).

    a, b: (R, *coarse) views; dst: an (R, *fine) view; each state
    contiguous, rows at any stride.  dim 1: coarse (n,), fine (2n + 1,), P
    linear with zero ends; dim 2: coarse (P, Q), fine (2P - 1, 2Q - 1), P
    bilinear.  dst must not share memory with a or b.  Returns dst.
    """
    name = "interpolate_combine"
    if dim not in (1, 2):
        _require(False, name, "dim must be 1 or 2")
    ops = (dst, a) if b is None else (dst, a, b)
    on_cpu, es, empty, launch = _interp_checked(dim, tuple(map(fact, ops)))
    # storages told apart by their base pointers; an empty tensor shares
    # nothing
    ptrs = [t.data_ptr() for t in ops]
    base = ptrs[0] - dst.storage_offset() * es
    for k in range(1, len(ops)):
        if ptrs[k] - ops[k].storage_offset() * es == base and not (empty[0] or empty[k]):
            _require(False, name, f"dst shares memory with {'a' if k == 1 else 'b'}")
    if on_cpu:
        return interpolate_combine_plain(dst, a, b, dim)
    if launch is not None:
        _, addr, fn, index = launch
        _build.check(fn(addr, ptrs[0], ptrs[1], ptrs[-1], _build.stream(index)), name)
        interpolate_combine.launches += 1
    return dst


interpolate_combine.launches = 0


def interpolate_plan(R, Pf, Qf, sms):
    """(grid, dr, dp, dq) of one K19 launch on R rows of Pf x Qf fine points
    (Pf = 1 in 1D) on a card of sms SMs (``stride_plan``)."""
    return stride_plan(R, Pf, Qf, INTERP_THREADS, INTERP_UNROLL, sms * INTERP_BLOCKS_PER_SM)


def interpolate_pack(index, strides, R, Pc, Qc, Pf, Qf, dim, plan):
    """The launcher's int64 argument array (csrc/interpolate_combine.cu
    ``launch``): device, dst's, a's and b's row strides (b: a's without b),
    R, Pc, Qc, Pf, Qf, dim, whether b is given, then the plan: grid, dr, dp,
    dq.  strides: dst's, a's (and b's)."""
    return array.array("q", (index, strides[0], strides[1], strides[-1], R, Pc, Qc, Pf, Qf, dim,
                             int(len(strides) == 3), *plan))
