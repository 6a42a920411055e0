"""Port parity: spatial coarsening (``GridTransferHeat``, ``GridTransferHeat2D``)
and the transfer contract, against ``pymgrit_tpu``.

The transfers are held per state and through the plain versions of the
solver's fused hooks (K18 ``restrict_combine``, K19 ``interpolate_combine``)
against JAX's vmapped transfers on seeded numpy inputs (rtol 1e-15: the
same slice arithmetic in the same order).  Solver histories are held at
rtol 1e-12 with an atol at the float64 floor (8 + 4 sqrt(n)) eps ||u_C||_2
of the C-point values (a residual of 1e-10 is a difference of O(1) values,
so its last digits are rounding); the level-0 tubes at 1e-12 of their
largest entry.  A transfer written per state, as for the JAX package, runs
through ``torch.vmap``; the port's heat transfers take whole tube views
(``batched = True``) and fuse the FAS residual, the correction and nested
iteration into K18 / K19 (a subclass that overrides a transfer method
keeps its override: the hook of that method is not used).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.models.grid_transfer_heat import GridTransferHeat as JHeat
from pymgrit_tpu.models.grid_transfer_heat import GridTransferHeat2D as JHeat2D
from pymgrit_tpu_torch.models.grid_transfer_heat import GridTransferHeat, GridTransferHeat2D
from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts, transfer

torch.set_num_threads(1)

HIST_RTOL, TUBE_RTOL = 1e-12, 1e-12
EPS = np.finfo(np.float64).eps


def _cpu(mod):
    return {"device": "cpu"} if mod is P else {}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _history_close(mj, cj, mp, cp, n):
    """Histories at rtol 1e-12 with the float64 floor; tubes at 1e-12."""
    uj, up = np.asarray(mj.u[0]), mp.u[0].numpy()
    assert uj.shape == up.shape
    floor = (8 + 4 * np.sqrt(n)) * EPS * float(np.linalg.norm(uj[::mp.levels[0].m]))
    assert cp.shape == cj.shape, (cp, cj)
    np.testing.assert_allclose(cp, cj, rtol=HIST_RTOL, atol=floor)
    np.testing.assert_allclose(up, uj, rtol=0, atol=TUBE_RTOL * np.max(np.abs(uj)))


# ---------------------------------------------------------------------------
# the transfers against JAX's, per state and over a tube's rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [3, 7, 15, 33])
def test_heat_1d_transfers_match_jax(n):
    fine, coarse = _rand((5, n), 1), _rand((5, (n - 1) // 2), 2)
    tj, tp = JHeat(), GridTransferHeat()
    for method, x in (("restriction", fine), ("interpolation", coarse)):
        ref = np.asarray(jax.vmap(getattr(tj, method))(jnp.asarray(x)))
        np.testing.assert_array_equal(getattr(tp, method)(_t(x)).numpy(), ref)
        np.testing.assert_array_equal(getattr(tp, method)(_t(x[2])).numpy(), ref[2])


@pytest.mark.parametrize("shape", [(3, 3), (9, 9), (17, 5), (33, 65)])
def test_heat_2d_transfers_match_jax(shape):
    coarse_shape = tuple((s + 1) // 2 for s in shape)
    fine, coarse = _rand((4,) + shape, 3), _rand((4,) + coarse_shape, 4)
    tj, tp = JHeat2D(*shape), GridTransferHeat2D(*shape)
    for method, x in (("restriction", fine), ("interpolation", coarse)):
        ref = np.asarray(jax.vmap(getattr(tj, method))(jnp.asarray(x)))
        np.testing.assert_array_equal(getattr(tp, method)(_t(x)).numpy(), ref)
        np.testing.assert_array_equal(getattr(tp, method)(_t(x[1])).numpy(), ref[1])
        # a state that is not contiguous (a transposed view) is copied first
        ref_t = np.asarray(getattr(tj, method)(jnp.asarray(x[1].T))) if shape[0] == shape[1] \
            else None
        if ref_t is not None:
            np.testing.assert_array_equal(getattr(tp, method)(_t(x[1]).T).numpy(), ref_t)


@pytest.mark.parametrize("dim,fine_shape", [(1, (15,)), (1, (5,)), (2, (9, 11)), (2, (3, 5))])
def test_hooks_plain_versions_match_jax(dim, fine_shape):
    """K18's plain version: R(f - u) + (v - s) and R((g - u) + f) + (v - s);
    K19's: dst + P(a - b) and P(a); each against the JAX solver's
    expressions over vmapped transfers."""
    tj = JHeat() if dim == 1 else JHeat2D(*fine_shape)
    vr, vi = jax.vmap(tj.restriction), jax.vmap(tj.interpolation)
    coarse_shape = transfer.coarse_shape(fine_shape, dim)
    f, u, g = (_rand((6,) + fine_shape, s) for s in (5, 6, 7))
    v, s = (_rand((6,) + coarse_shape, s) for s in (8, 9))
    for terms, coeffs, inner in (([f, u], [1.0, -1.0], f - u),
                                 ([g, u, f], [1.0, -1.0, 1.0], (g - u) + f)):
        ref = np.asarray(vr(jnp.asarray(inner))) + (v - s)
        out = torch.empty((6,) + coarse_shape, dtype=torch.float64)
        transfer.restrict_combine_plain(out, [_t(x) for x in terms], coeffs, [_t(v), _t(s)],
                                        [1.0, -1.0], dim)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-15, atol=1e-15)
    out = torch.empty((6,) + coarse_shape, dtype=torch.float64)
    transfer.restrict_combine_plain(out, [_t(f)], [1.0], dim=dim)
    np.testing.assert_array_equal(out.numpy(), np.asarray(vr(jnp.asarray(f))))
    dst = _t(u.copy())
    transfer.interpolate_combine_plain(dst, _t(v), _t(s), dim)
    np.testing.assert_array_equal(dst.numpy(), u + np.asarray(vi(jnp.asarray(v - s))))
    transfer.interpolate_combine_plain(dst, _t(v), dim=dim)
    np.testing.assert_array_equal(dst.numpy(), np.asarray(vi(jnp.asarray(v))))


def test_hooks_dispatch_to_plain_on_the_cpu():
    """The DISPATCH wrappers take the plain version on CPU tensors (no
    launch counted), on strided rows of tubes, and equal it bitwise."""
    ft, ct = _t(_rand((12, 9, 11), 10)), _t(_rand((12, 5, 6), 11))
    reset_launch_counts()
    for ops in (DISPATCH, PLAIN):
        out = torch.zeros_like(ct)
        ops.restrict_combine(out[1::2], [ft[0::2], ft[1::2]], [1.0, -1.0], [ct[0::2]], [1.0], 2)
        dst = ft.clone()
        ops.interpolate_combine(dst[1::2], ct[0::2], ct[1::2], 2)
        if ops is DISPATCH:
            first = (out, dst)
    np.testing.assert_array_equal(first[0].numpy(), out.numpy())
    np.testing.assert_array_equal(first[1].numpy(), dst.numpy())
    assert launch_counts() == {k: 0 for k in launch_counts()}


@pytest.mark.parametrize("call,match", [
    (lambda: transfer.restrict_combine(torch.zeros(4, 7), [torch.zeros(4, 14)], [1.0]),
     "expected"),
    (lambda: transfer.restrict_combine(torch.zeros(4, 3, 3), [torch.zeros(4, 6, 5)], [1.0],
                                       dim=2), "odd sides"),
    (lambda: transfer.restrict_combine(torch.zeros(4, 7), [torch.zeros(4, 15)] * 4, [1.0] * 4),
     "1..3 terms"),
    (lambda: transfer.restrict_combine(torch.zeros(4, 7), [torch.zeros(4, 15)], [1.0],
                                       [torch.zeros(4, 7)] * 3, [1.0] * 3), "0..2 adds"),
    (lambda: transfer.restrict_combine(torch.zeros(4, 7, dtype=torch.float64),
                                       [torch.zeros(4, 15, dtype=torch.float32)], [1.0]), "dtype"),
    (lambda: transfer.restrict_combine(torch.zeros(4, 14)[:, ::2], [torch.zeros(4, 15)], [1.0]),
     "contiguous"),
    (lambda: transfer.interpolate_combine(torch.zeros(4, 15), torch.zeros(4, 8)), "expected"),
    (lambda: transfer.interpolate_combine(torch.zeros(4, 9, 9), torch.zeros(4, 5, 5),
                                          torch.zeros(3, 5, 5), dim=2), "expected"),
    (lambda: transfer.restrict_combine(torch.zeros(4, 7), [torch.zeros(4, 15)], [1.0], dim=3),
     "dim must be"),
])
def test_hooks_reject(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_hooks_reject_overlap():
    tube = torch.zeros(8, 15, dtype=torch.float64)
    with pytest.raises(ValueError, match="shares memory"):
        transfer.interpolate_combine(tube[:4], tube[4:, :7])
    with pytest.raises(ValueError, match="overlaps"):
        transfer.restrict_combine(tube[:4, :7], [tube[4:]], [1.0])


# ---------------------------------------------------------------------------
# the four unit tests of tests/models/test_grid_transfer_2d.py
# ---------------------------------------------------------------------------


def test_restriction_is_injection():
    tr = GridTransferHeat2D(nx_fine=5, ny_fine=7)
    u = torch.arange(35.0, dtype=torch.float64).reshape(5, 7)
    np.testing.assert_array_equal(tr.restriction(u).numpy(), u.numpy()[::2, ::2])


def test_interpolation_bilinear_stencil():
    tr = GridTransferHeat2D(nx_fine=5, ny_fine=5)
    u = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 9.0]], dtype=torch.float64)
    out = tr.interpolation(u).numpy()
    np.testing.assert_array_equal(out[::2, ::2], u.numpy())
    np.testing.assert_allclose(out[1, 0], (1.0 + 4.0) / 2)
    np.testing.assert_allclose(out[3, 2], (5.0 + 8.0) / 2)
    np.testing.assert_allclose(out[0, 1], (1.0 + 2.0) / 2)
    np.testing.assert_allclose(out[2, 3], (5.0 + 6.0) / 2)
    np.testing.assert_allclose(out[1, 1], (1.0 + 2.0 + 4.0 + 5.0) / 4)
    np.testing.assert_allclose(out[3, 3], (5.0 + 6.0 + 8.0 + 9.0) / 4)


def test_restrict_after_interpolate_is_identity():
    tr = GridTransferHeat2D(nx_fine=9, ny_fine=9)
    u = _t(np.random.default_rng(0).standard_normal((5, 5)))
    np.testing.assert_allclose(tr.restriction(tr.interpolation(u)).numpy(), u.numpy(), rtol=1e-14)


def test_even_fine_dims_rejected():
    with pytest.raises(Exception, match="odd fine dimensions"):
        GridTransferHeat2D(nx_fine=6, ny_fine=5)


# ---------------------------------------------------------------------------
# a transfer written per state runs through torch.vmap
# ---------------------------------------------------------------------------


class PerStateHeat(P.GridTransfer):
    """The 1D heat transfer written for one state, functionally, as a user
    of the JAX package would write it (no ``batched`` attribute)."""

    def restriction(self, u):
        return u[:-2:2] * 0.25 + u[1:-1:2] * 0.5 + u[2::2] * 0.25

    def interpolation(self, u):
        z = torch.zeros(1, dtype=u.dtype, device=u.device)
        even = torch.cat([0.5 * u, z]) + torch.cat([z, 0.5 * u])
        inner = torch.stack([even[:-1], u], dim=1).reshape(-1)
        return torch.cat([inner, even[-1:]])


def _heat1d_rhs(mod):
    xp = jnp if mod is J else np
    return lambda x, t: -xp.sin(xp.pi * x) * (xp.sin(t) - 1 * xp.pi ** 2 * xp.cos(t))


def _heat1d_levels(mod, **extra):
    """examples/example_spatial_coarsening.py: Heat1D 17/9/5/5 points,
    nt = 129 on [0, 2], coarsening 2/2/2."""
    kw = dict(x_start=0, x_end=2, a=1, rhs=_heat1d_rhs(mod), init_cond=lambda x: np.sin(np.pi * x),
              **_cpu(mod), **extra)
    h0 = mod.Heat1D(nx=2 ** 4 + 1, t_start=0, t_stop=2, nt=2 ** 7 + 1, **kw)
    h1 = mod.Heat1D(nx=2 ** 3 + 1, t_interval=h0.t[::2], **kw)
    h2 = mod.Heat1D(nx=2 ** 2 + 1, t_interval=h1.t[::2], **kw)
    h3 = mod.Heat1D(nx=2 ** 2 + 1, t_interval=h2.t[::2], **kw)
    return [h0, h1, h2, h3]


_JAX_RUNS = {}


def _jax_spatial_1d():
    if "1d" not in _JAX_RUNS:
        mj = J.Mgrit(problem=_heat1d_levels(J), transfer=[JHeat(), JHeat(), J.GridTransferCopy()],
                     logging_lvl=30)
        _JAX_RUNS["1d"] = (mj, mj.solve()["conv"])
    return _JAX_RUNS["1d"]


def test_per_state_user_transfer_gives_jax_history():
    mj, cj = _jax_spatial_1d()
    mp = P.Mgrit(problem=_heat1d_levels(P),
                 transfer=[PerStateHeat(), PerStateHeat(), P.GridTransferCopy()], logging_lvl=30)
    _history_close(mj, cj, mp, mp.solve()["conv"], 15)


def test_batched_transfer_gets_the_solvers_kernel_set():
    """A batched transfer method that takes ``ops`` is called with the
    solver's kernel set (the fine application's ``ops``), so a solve with
    ``ops=PLAIN`` runs the plain K18 / K19 on any device."""
    seen = []

    class Spy(GridTransferHeat):
        def restriction(self, u, ops=DISPATCH):
            seen.append(ops)
            return super().restriction(u, ops)

    mg = P.Mgrit(problem=_heat1d_levels(P, ops=PLAIN),
                 transfer=[Spy(), Spy(), P.GridTransferCopy()], max_iter=1, logging_lvl=30)
    mg.solve()
    assert seen and all(ops is PLAIN for ops in seen)
    assert mg._restrict_hooks[:2] == [None, None] and mg._interp_hooks[0] is not None


def test_spatial_coarsening():
    """tests/core/test_solver_goldens_2.py::test_spatial_coarsening in the
    port: against JAX, and against the reference golden at rtol 2e-3."""
    mj, cj = _jax_spatial_1d()
    mp = P.Mgrit(problem=_heat1d_levels(P),
                 transfer=[P.GridTransferHeat(), P.GridTransferHeat(), P.GridTransferCopy()],
                 logging_lvl=30)
    conv = mp.solve()["conv"]
    expected = np.array([3.3795e-2, 2.9794e-3, 3.2555e-4, 4.0429e-5, 4.9316e-6,
                         6.1785e-7, 7.7088e-8])
    assert len(conv) == 7
    assert np.allclose(conv, expected, rtol=2e-3)
    _history_close(mj, cj, mp, conv, 15)


# ---------------------------------------------------------------------------
# 2D hierarchies (physical Heat2D with its ring)
# ---------------------------------------------------------------------------


def _heat2d_rhs(mod):
    xp = jnp if mod is J else np
    return lambda x, y, t: xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * xp.ones_like(t * x * y)


def _heat2d_levels(mod, sizes, nts):
    return [mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=n, ny=n, a=1.0,
                       rhs=_heat2d_rhs(mod), init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                       t_start=0, t_stop=1, nt=nt, **_cpu(mod))
            for n, nt in zip(sizes, nts)]


def _transfers(mod, sizes):
    cls = JHeat2D if mod is J else GridTransferHeat2D
    copy = mod.GridTransferCopy
    return [cls(a, a) if a != b else copy() for a, b in zip(sizes[:-1], sizes[1:])]


def _solve_2d(sizes, nts, **kw):
    kw = dict(dict(tol=1e-9, max_iter=8, logging_lvl=30), **kw)
    mj = J.Mgrit(problem=_heat2d_levels(J, sizes, nts), transfer=_transfers(J, sizes), **kw)
    reset_launch_counts()
    mp = P.Mgrit(problem=_heat2d_levels(P, sizes, nts), transfer=_transfers(P, sizes), **kw)
    return mj, mj.solve()["conv"], mp, mp.solve()["conv"]


def test_grid_transfer_2d_hierarchy_matches_jax():
    """The hierarchy of tests/models/test_grid_transfer_2d.py (33/17/17,
    nt 65/17/5, tol 1e-9), the condensed carry on level 0."""
    mj, cj, mp, cp = _solve_2d((33, 17, 17), (65, 17, 5))
    assert mp._condensed0 and mj._condensed0
    _history_close(mj, cj, mp, cp, 31)


@pytest.mark.parametrize("cycle_type", ["V", "F"])
def test_four_level_spatial_hierarchy_matches_jax(cycle_type):
    """17^2 -> 9^2 -> 5^2 -> 3^2, nt = 257, coarsening 4/4/4, condensed
    level 0, nested iteration (the interpolation hook without b), V- and
    F-cycles."""
    mj, cj, mp, cp = _solve_2d((17, 9, 5, 3), (257, 65, 17, 5), cycle_type=cycle_type)
    assert mp._condensed0 and mj._condensed0
    assert launch_counts() == {k: 0 for k in launch_counts()}
    _history_close(mj, cj, mp, cp, 15)


def _vertex_interp(a):
    """Linear interpolation along axis 0 of one state, n -> 2n - 1, written
    functionally (torch.vmap takes no in-place writes)."""
    mid = 0.5 * (a[:-1] + a[1:])
    pairs = torch.stack([a[:-1], mid], dim=1).reshape((-1,) + tuple(a.shape[1:]))
    return torch.cat([pairs, a[-1:]])


class PerState2D(P.GridTransfer):
    """GridTransferHeat2D written for one state (vmapped by the solver)."""

    def restriction(self, u):
        return u[::2, ::2]

    def interpolation(self, u):
        return _vertex_interp(_vertex_interp(u).T).T


@pytest.mark.parametrize("condensed", [True, False])
def test_fused_hooks_equal_the_vmapped_transfers(condensed):
    """The solver with the heat transfers' hooks (K18, K19) and with the
    same transfers written per state (vmapped, the unfused route with K4):
    one history and one tube."""
    sizes, nts = (17, 9, 5), (129, 33, 9)
    hist = []
    for tr in ([GridTransferHeat2D(17, 17), GridTransferHeat2D(9, 9)], [PerState2D(), PerState2D()]):
        mg = P.Mgrit(problem=_heat2d_levels(P, sizes, nts), transfer=tr, tol=1e-9, max_iter=8,
                     condensed=condensed, logging_lvl=30)
        assert mg._condensed0 == condensed
        hist.append((mg.solve()["conv"], mg.u[0].numpy()))
    (h0, u0), (h1, u1) = hist
    floor = (8 + 4 * np.sqrt(15)) * EPS * float(np.linalg.norm(u0[::4]))
    np.testing.assert_allclose(h1, h0, rtol=HIST_RTOL, atol=floor)
    np.testing.assert_allclose(u1, u0, rtol=0, atol=TUBE_RTOL * np.max(np.abs(u0)))


def _row_weighting(xp, u):
    """Full weighting [1/4, 1/2, 1/4] along the rows of the interior and
    injection on the ring rows, on the trailing two axes: another
    restriction than injection, for one state or a batch."""
    inj = u[..., ::2, ::2]
    mid = 0.25 * u[..., 1:-2:2, ::2] + 0.5 * u[..., 2:-1:2, ::2] + 0.25 * u[..., 3::2, ::2]
    cat = xp.concatenate if xp is jnp else torch.cat
    return cat([inj[..., :1, :], mid, inj[..., -1:, :]], -2)


class JRowWeighted(JHeat2D):
    def restriction(self, u):
        return _row_weighting(jnp, u)


class RowWeighted(GridTransferHeat2D):
    """Overrides restriction alone: the inherited restrict_combine (K18's
    injection) must not replace it."""

    def restriction(self, u, ops=DISPATCH):
        return _row_weighting(torch, u)


@pytest.mark.parametrize("condensed", [True, False])
def test_overridden_restriction_is_not_bypassed_by_the_hook(condensed):
    """A subclass of GridTransferHeat2D that overrides restriction goes
    through its own restriction (and K4) in the FAS residual: the history is
    JAX's with the same override, not the injection's; the interpolation
    hook, whose method it keeps, stays in use."""
    sizes, nts = (17, 9, 5), (129, 33, 9)
    kw = dict(tol=1e-9, max_iter=8, condensed=condensed, logging_lvl=30)
    mj = J.Mgrit(problem=_heat2d_levels(J, sizes, nts),
                 transfer=[JRowWeighted(17, 17), JRowWeighted(9, 9)], **kw)
    cj = mj.solve()["conv"]
    mp = P.Mgrit(problem=_heat2d_levels(P, sizes, nts),
                 transfer=[RowWeighted(17, 17), RowWeighted(9, 9)], **kw)
    assert mp._restrict_hooks == [None, None]
    assert all(h is not None for h in mp._interp_hooks)
    cp = mp.solve()["conv"]
    _history_close(mj, cj, mp, cp, 15)
    mi = P.Mgrit(problem=_heat2d_levels(P, sizes, nts),
                 transfer=[GridTransferHeat2D(17, 17), GridTransferHeat2D(9, 9)], **kw)
    ci = mi.solve()["conv"]
    assert ci.shape != cp.shape or not np.allclose(ci, cp, rtol=1e-6)
