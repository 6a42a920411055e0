"""Port parity: the viscous Burgers equation, 1D (dense Newton, K16
``burgers1d_newton``) and 2D (Newton-BiCGStab with K15
``burgers2d_pointwise`` and K10 ``periodic_solve2d``), against
``pymgrit_tpu.models.burgers``.

Small sizes in float64.  Tolerances:

* single steps: rtol 1e-12 against the largest entry (1D: the same Newton
  iterates, solved by two LU implementations that round differently;
  2D: the Hartley against the FFT preconditioner);
* MGRIT histories: rtol 1e-9 with an atol at the float64 floor
  8 eps ||u_C||_2;
* Newton iterations per lane: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.models.burgers import Burgers1D as JBurgers1D, Burgers2D as JBurgers2D
from pymgrit_tpu_torch.ops import dense_newton, pointwise
from pymgrit_tpu_torch.ops.dense_newton import periodic_differences

torch.set_num_threads(1)

RTOL = 1e-12
H_RTOL, FLOOR_OPS = 1e-9, 8
CPU = dict(device="cpu")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(p, j, rtol=RTOL):
    p, j = _np(p), _np(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * np.max(np.abs(j)))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _floor(mgrit):
    u0 = _np(mgrit.u[0])
    info = mgrit.levels[0]
    return FLOOR_OPS * np.finfo(np.float64).eps * np.linalg.norm(u0[0:info.nt:info.m])


def _history(mod, cls_j, cls_p, nt, m, tol, max_iter=10, **kw):
    """A two-level solve; the history of every iteration (solve() drops an
    exact 0)."""
    cls, cpu = (cls_p, CPU) if mod is P else (cls_j, {})
    b0 = cls(t_start=0, nt=nt, **kw, **cpu)
    mg = mod.Mgrit(problem=[b0, cls(t_interval=b0.t[::m], **{k: v for k, v in kw.items()
                                                                if k != "t_stop"}, **cpu)],
                   tol=tol, max_iter=max_iter, logging_lvl=40)
    mg.solve()
    return mg, mg.conv[1:mg.solve_iter + 1].copy()


def _u1d(bj, seed):
    rng = np.random.default_rng(seed)
    u0 = np.asarray(bj.vector_t_start)
    return np.stack([u0, 0.5 * u0, u0 + 0.1 * rng.standard_normal(u0.shape)])


# ---------------------------------------------------------------------------
# Burgers1D
# ---------------------------------------------------------------------------


def _pair1d(nx=32, nu=0.05):
    kw = dict(nx=nx, nu=nu, t_start=0, t_stop=1, nt=11)
    return JBurgers1D(**kw), P.Burgers1D(**kw, **CPU)


def test_burgers1d_constructor_state():
    bj, bp = _pair1d()
    np.testing.assert_array_equal(bp.vector_t_start.numpy(), np.asarray(bj.vector_t_start))
    D1, D2 = periodic_differences(bp.nx, bp.dx)
    np.testing.assert_array_equal(D1, bj.D1)
    np.testing.assert_array_equal(D2, bj.D2)
    assert bp.dx == bj.dx and bp.vector_template.shape == (32,)


@pytest.mark.parametrize("nx", [16, 33])
def test_burgers1d_step_matches_jax(nx):
    bj, bp = _pair1d(nx)
    us = _u1d(bj, nx)
    for dt, u in zip((0.05, 0.02, 0.1), us):
        _close(bp.step(_t(u), 0.0, dt), bj.step(jnp.asarray(u), 0.0, dt))
    ref = jax.vmap(bj.step)(jnp.asarray(us), jnp.zeros(3), jnp.asarray([0.05, 0.02, 0.1]))
    _close(bp.step_batched(_t(us), [0.0] * 3, [0.05, 0.02, 0.1]), ref)


@pytest.mark.parametrize("with_g", [True, False])
def test_burgers1d_step_chain_matches_a_scan_of_steps(with_g):
    bj, bp = _pair1d()
    us = _u1d(bj, 3)
    t, m, L = bj.t, 3, 2
    tp = np.stack([t[j * m:j * m + L] for j in range(3)], 1)
    tc = np.stack([t[j * m + 1:j * m + L + 1] for j in range(3)], 1)
    g = np.random.default_rng(9).standard_normal((3, L, 32)) * 1e-3
    x, ref = jnp.asarray(us), []
    for k in range(L):
        x = jax.vmap(bj.step)(x, jnp.asarray(tp[k]), jnp.asarray(tc[k]))
        if with_g:
            x = jnp.asarray(g[:, k]) + x
        ref.append(x)
    tube = torch.zeros((3 * m + 1, 32), dtype=torch.float64)
    out = tube[1:].view(3, m, 32)[:, :L]
    bp.step_chain(_t(us), tp, tc, out, _t(g) if with_g else None)
    _close(out, np.stack(ref, 1))
    assert bp.steps == 3 * L


def _jax_newton_count(bj, u, dt, monkeypatch):
    """JAX's Newton iterations of one step, counted at jnp.linalg.solve."""
    calls = [0]
    solve = jnp.linalg.solve

    def counted(a, b):
        jax.debug.callback(lambda: calls.__setitem__(0, calls[0] + 1))
        return solve(a, b)

    monkeypatch.setattr(jnp.linalg, "solve", counted)
    out = np.asarray(bj.step(jnp.asarray(u), 0.0, dt))
    monkeypatch.undo()
    return out, calls[0]


def test_burgers1d_newton_counts_per_lane_match_jax(monkeypatch):
    bj, bp = _pair1d()
    us = _u1d(bj, 5)
    dts = np.array([0.05, 0.2, 0.01])
    iters = torch.zeros((1, 3), dtype=torch.int32)
    out = torch.empty((3, 1, 32), dtype=torch.float64)
    dense_newton.burgers1d_newton(_t(us), _t(dts)[None], out, nu=bp.nu, dx=float(bp.dx),
                                  tol=bp.newton_tol, maxiter=bp.newton_maxiter, iters=iters)
    counts = []
    for i in range(3):
        uj, nj = _jax_newton_count(bj, us[i], dts[i], monkeypatch)
        counts.append(nj)
        _close(out[i, 0], uj)
    assert iters[0].tolist() == counts and len(set(counts)) > 1     # lanes differ


def test_burgers1d_newton_stops_at_maxiter_and_on_nan():
    """A lane that cannot reach tol runs maxiter iterations; a lane with a
    NaN stops at once (max|g| >= tol is False on NaN, as in JAX)."""
    bp = P.Burgers1D(nx=16, nu=0.05, t_start=0, t_stop=1, nt=3, newton_tol=0.0,
                     newton_maxiter=3, **CPU)
    u = bp.vector_t_start.expand(2, 16).clone()
    u[1, 4] = float("nan")
    iters = torch.zeros((1, 2), dtype=torch.int32)
    out = torch.empty((2, 1, 16), dtype=torch.float64)
    dense_newton.burgers1d_newton(u, torch.full((1, 2), 0.05, dtype=torch.float64), out,
                                  nu=0.05, dx=float(bp.dx), tol=0.0, maxiter=3, iters=iters)
    assert iters[0].tolist() == [3, 0]
    assert bool(torch.isnan(out[1]).any()) and bool(torch.isfinite(out[0]).all())


def test_burgers1d_mgrit_history_matches_jax():
    """tests/models/test_gray_scott_burgers.py's Burgers1D case: nx = 64,
    nu = 0.05, 33 / 9 points, tol 1e-8."""
    (mj, hj), (mp, hp) = (_history(mod, JBurgers1D, P.Burgers1D, 33, 4, 1e-8, nx=64, nu=0.05,
                                   t_stop=1) for mod in (J, P))
    assert hj[-1] < 1e-8
    np.testing.assert_allclose(hp, hj, rtol=H_RTOL, atol=_floor(mp))
    np.testing.assert_allclose(_np(mp.u[0]), _np(mj.u[0]), rtol=0, atol=1e-12)
    assert int(mp.problem[0].newton_iters) > 0 and int(mp.problem[0].newton_max) >= 2


# ---------------------------------------------------------------------------
# Burgers2D
# ---------------------------------------------------------------------------


def _pair2d(nx=12, **kw):
    kw = dict(nx=nx, nu=0.05, t_start=0, t_stop=1, nt=11, **kw)
    return JBurgers2D(**kw), P.Burgers2D(**kw, **CPU)


def _s2d(bj, seed):
    rng = np.random.default_rng(seed)
    s0 = np.asarray(bj.vector_t_start)
    return np.stack([s0, 0.5 * s0, s0 + 0.05 * rng.standard_normal(s0.shape)])


def test_burgers2d_operators_match_jax():
    """K10 with coefficient nu on both components (plain) against
    _fft_visc_solve; K15's residual, its per-lane max and its Jacobian
    matvec (plain) against the expressions of JAX's step closures."""
    bj, bp = _pair2d()
    ss = _s2d(bj, 1)
    w = np.random.default_rng(2).standard_normal(ss.shape)
    dts = np.array([0.02, 0.05, 0.01])
    _close(bp._diffusion_solve(_t(dts), _t(w)),
           np.stack([bj._fft_visc_solve(d, jnp.asarray(x)) for d, x in zip(dts, w)]))
    g, gmax = bp.g_of(_t(ss), _t(w), _t(dts))
    gj = np.stack([s - s0 + d * (bj._conv(jnp.asarray(s)) - bj.nu * bj._lap(jnp.asarray(s)))
                   for s, s0, d in zip(ss, w, dts)])
    _close(g, gj)
    _close(gmax, np.max(np.abs(gj), axis=(1, 2, 3)))

    def jac(s, x, d):
        u, v, wu, wv = s[0], s[1], x[0], x[1]
        cu = u * bj._ddx(wu) + wu * bj._ddx(u) + v * bj._ddy(wu) + wv * bj._ddy(u)
        cv = u * bj._ddx(wv) + wu * bj._ddx(v) + v * bj._ddy(wv) + wv * bj._ddy(v)
        return x + d * (jnp.stack([cu, cv]) - bj.nu * bj._lap(jnp.asarray(x)))

    _close(bp.jac_mv(_t(ss), _t(w), _t(dts)),
           np.stack([jac(jnp.asarray(s), jnp.asarray(x), d) for s, x, d in zip(ss, w, dts)]))


def test_burgers2d_step_matches_jax():
    bj, bp = _pair2d()
    ss = _s2d(bj, 4)
    for dt, s in zip((0.02, 0.05, 0.01), ss):
        _close(bp.step(_t(s), 0.0, dt), bj.step(jnp.asarray(s), 0.0, dt))
    assert bp.stats["steps"] == 3 and bp.stats["newton_max"] >= 2 and bp.stats["bicgstab"] > 0


def test_burgers2d_residual_max_keeps_nan():
    """K15's per-lane max |g| (plain version here) as jnp.max(|g|)."""
    bj, bp = _pair2d(nx=8)
    s = _t(np.random.default_rng(6).uniform(-1, 1, (3, 2, 8, 8)))
    r = torch.zeros_like(s)
    r[1, 0, 2, 2], r[2, 1, 0, 0] = float("nan"), float("inf")
    _, gmax = pointwise.burgers2d_pointwise("residual", s, torch.empty_like(s), _t([0.01] * 3),
                                            0.05, 1.0 / 8, r=r)
    assert np.isfinite(float(gmax[0])) and np.isnan(float(gmax[1])) and float(gmax[2]) == np.inf


def test_burgers2d_mgrit_history_matches_jax():
    """tests/models/test_gray_scott_burgers.py's Burgers2D case: nx = 16,
    17 / 5 points; the second iteration ends at the float64 floor."""
    (mj, hj), (mp, hp) = (_history(mod, JBurgers2D, P.Burgers2D, 17, 4, 1e-12, nx=16, nu=0.05,
                                   t_stop=0.5) for mod in (J, P))
    assert hj.size == 2
    np.testing.assert_allclose(hp, hj, rtol=H_RTOL, atol=_floor(mp))
