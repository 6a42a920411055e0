"""Kernels K18 ``restrict_combine`` and K19 ``interpolate_combine`` (Triton,
bodies in ``triton_kernels``) beside their plain PyTorch versions: the heat
grid transfers of pymgrit_tpu/models/grid_transfer_heat.py fused with the
solver phase around them.

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
``dst = P(a)`` (nested iteration, the batched ``interpolation``).  Both are passes of reads, stencil weights and sums,
bound by the bytes they move; the combination and the transfer never meet
device memory in between, where the unfused route writes the combined fine
rows, reads them back to restrict, and runs K4 after.  The weights (1/4,
1/2, 1) and the coefficients the solver passes (+-1) make every product
exact, so the kernels round as the plain versions do.

Dispatch as in ``heat_kernels``: CPU tensors go to the plain version, CUDA
tensors launch the Triton kernel or raise.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.ops import triton_kernels
from pymgrit_tpu_torch.ops.heat_kernels import _check_operands, _require

MAX_TERMS, MAX_ADDS = 3, 2
_WEIGHTS = {1: (0.25, 0.5, 0.25), 2: (1.0,)}


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
    inner = 1
    for n, st in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if n > 1 and st != inner:
            return False
        inner *= n
    return True


def contiguous_states(t):
    """t, or a copy of it where its states are not contiguous (rows may
    keep any stride)."""
    return t if _states_contiguous(t) else t.contiguous()


def _check_states(name, key, t, R, shape):
    _require(tuple(t.shape) == (R,) + tuple(shape), name,
             f"{key} has shape {tuple(t.shape)}, expected {(R,) + tuple(shape)}")
    _require(_states_contiguous(t), name, f"{key} must hold each state contiguously")


def _disjoint(name, out, key, t):
    """out may share memory with an input of its shape only as the same view
    or as rows interleaved with it; with an input of another shape not at
    all."""
    if out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr():
        return
    ok = out.shape == t.shape and not triton_kernels._overlaps_partially(
        out.view(out.shape[0], -1), t.view(t.shape[0], -1))
    _require(ok, name, f"out overlaps {key}")


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
    terms, adds = list(terms), list(adds)
    _require(dim in (1, 2), name, "dim must be 1 or 2")
    _require(1 <= len(terms) <= MAX_TERMS and len(coeffs) == len(terms), name,
             f"needs 1..{MAX_TERMS} terms with one coefficient each")
    _require(len(adds) <= MAX_ADDS and len(add_coeffs) == len(adds), name,
             f"takes 0..{MAX_ADDS} adds with one coefficient each")
    _check_operands(name, {"out": out, **{f"term{k}": t for k, t in enumerate(terms)},
                           **{f"add{k}": t for k, t in enumerate(adds)}})
    _require(out.dim() == dim + 1 and terms[0].dim() == dim + 1, name,
             f"out and the terms must be (R, ...) batches of {dim}D states")
    R, fine = terms[0].shape[0], tuple(terms[0].shape[1:])
    _require(dim == 1 or all(n % 2 == 1 for n in fine), name,
             f"2D fine states need odd sides, got {fine}")
    _require(all(n >= 3 for n in fine), name, f"fine states {fine} are too small")
    coarse = coarse_shape(fine, dim)
    for k, t in enumerate(terms):
        _check_states(name, f"term{k}", t, R, fine)
    for k, t in enumerate(adds):
        _check_states(name, f"add{k}", t, R, coarse)
    _check_states(name, "out", out, R, coarse)
    for k, t in enumerate(terms):
        _disjoint(name, out, f"term{k}", t)
    for k, t in enumerate(adds):
        _disjoint(name, out, f"add{k}", t)
    if out.device.type == "cpu":
        return restrict_combine_plain(out, terms, coeffs, adds, add_coeffs, dim)
    Nc = 1
    for n in coarse:
        Nc *= n
    if R and Nc:
        xs = terms + [out] * (MAX_TERMS - len(terms))
        ys = adds + [out] * (MAX_ADDS - len(adds))
        weights = _WEIGHTS[dim]
        c = triton_kernels._coefficients(
            tuple(coeffs) + (0.0,) * (MAX_TERMS - len(terms)) + tuple(add_coeffs)
            + (0.0,) * (MAX_ADDS - len(adds)) + weights, out.dtype, out.device)
        grid = (R, -(-Nc // triton_kernels._BLOCK))
        with torch.cuda.device(out.device):
            triton_kernels._jit()["restrict"][grid](
                out, *xs, *ys, c, out.stride(0), *(x.stride(0) for x in xs),
                *(y.stride(0) for y in ys), fine[-1], coarse[-1], Nc, DIM=dim, NT=len(terms),
                NA=len(adds), KP=len(weights), BLOCK=triton_kernels._BLOCK, num_warps=4)
        restrict_combine.launches += 1
    return out


restrict_combine.launches = 0


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


def interpolate_combine(dst, a, b=None, dim=1):
    """dst_r += P(a_r - b_r), or dst_r = P(a_r) without b, for every row r
    (K19).

    a, b: (R, *coarse) views; dst: an (R, *fine) view; each state
    contiguous, rows at any stride.  dim 1: coarse (n,), fine (2n + 1,), P
    linear with zero ends; dim 2: coarse (P, Q), fine (2P - 1, 2Q - 1), P
    bilinear.  dst must not overlap a or b.  Returns dst.
    """
    name = "interpolate_combine"
    _require(dim in (1, 2), name, "dim must be 1 or 2")
    ops = {"dst": dst, "a": a}
    if b is not None:
        ops["b"] = b
    _check_operands(name, ops)
    _require(a.dim() == dim + 1 and dst.dim() == dim + 1, name,
             f"dst and a must be (R, ...) batches of {dim}D states")
    R, coarse = a.shape[0], tuple(a.shape[1:])
    _require(all(n >= (1 if dim == 1 else 2) for n in coarse), name,
             f"coarse states {coarse} are too small")
    fine = fine_shape(coarse, dim)
    _check_states(name, "a", a, R, coarse)
    if b is not None:
        _check_states(name, "b", b, R, coarse)
    _check_states(name, "dst", dst, R, fine)
    for key in ("a", "b"):
        _require(key not in ops
                 or dst.untyped_storage().data_ptr() != ops[key].untyped_storage().data_ptr(),
                 name, f"dst shares memory with {key}")
    if dst.device.type == "cpu":
        return interpolate_combine_plain(dst, a, b, dim)
    Nf = 1
    for n in fine:
        Nf *= n
    if R:
        bb = b if b is not None else a
        grid = (R, -(-Nf // triton_kernels._BLOCK))
        with torch.cuda.device(dst.device):
            triton_kernels._jit()["interpolate"][grid](
                dst, a, bb, dst.stride(0), a.stride(0), bb.stride(0), coarse[0], coarse[-1],
                fine[-1], Nf, DIM=dim, HAS_B=b is not None, BLOCK=triton_kernels._BLOCK,
                num_warps=4)
        interpolate_combine.launches += 1
    return dst


interpolate_combine.launches = 0
