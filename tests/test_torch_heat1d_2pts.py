"""Port parity: the BDF pair-state heat models (``Heat1DBDF1``,
``Heat1DBDF2``) and K20's BDF2 mode, against ``pymgrit_tpu``.

The port's pair is one (2, n) tensor (first, second); JAX's is the dict
{'first', 'second'}.  Steps with per-lane times are held against JAX's
vmapped steps at rtol 1e-12 of the largest entry (both packages take two
length-n products with the sine basis around a diagonal scale; XLA's and
PyTorch's products round differently); the initial pairs are equal bit for
bit where the rhs is a polynomial (both packages then evaluate it in numpy),
and at 1e-14 for a transcendental rhs (JAX evaluates it in jnp).  The
three-level BDF2/BDF1/BDF1 hierarchy of
tests/core/test_cross_validation_2.py is held at rtol 1e-9 with the float64
floor (8 + 4 sqrt(n)) eps ||u_C||_2 as atol, the level-0 tube at 1e-10 of its
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.ops.dirichlet_spectral import solve_helmholtz_1d as j_helmholtz
from pymgrit_tpu_torch.ops import DISPATCH, heat_kernels, launch_counts, reset_launch_counts
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis, solve_helmholtz_1d

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps


def _cpu(mod):
    return {"device": "cpu"} if mod is P else {}


def _rhs(mod):
    xp = jnp if mod is J else np
    return lambda x, t: -xp.sin(xp.pi * x) * (xp.sin(t) - xp.pi ** 2 * xp.cos(t))


def _poly_rhs(x, t):
    return x * (1 - x) * (1 + t * t)


def _ic(x):
    return np.sin(np.pi * x)


def _model(mod, cls, nx=33, nt=17, rhs=None, dtau=None):
    t = np.linspace(0, 2, nt)
    return getattr(mod, cls)(x_start=0, x_end=1, nx=nx, a=1, dtau=dtau or (t[1] - t[0]) / 2,
                             rhs=rhs or _rhs(mod), init_cond=_ic, t_interval=t, **_cpu(mod))


def _pair(p):
    return np.stack([np.asarray(p["first"]), np.asarray(p["second"])], axis=-2)


@pytest.mark.parametrize("cls", ["Heat1DBDF1", "Heat1DBDF2"])
def test_initial_pair_matches_jax(cls):
    for rhs in (None, _poly_rhs):
        mj, mp = _model(J, cls, rhs=rhs), _model(P, cls, rhs=rhs)
        ref, got = _pair(mj.vector_t_start), mp.vector_t_start.numpy()
        if rhs is _poly_rhs:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14 * np.abs(ref).max())
    assert tuple(mp.vector_template.shape) == (2, 31)


@pytest.mark.parametrize("cls", ["Heat1DBDF1", "Heat1DBDF2"])
def test_batched_steps_with_per_lane_times_match_jax(cls):
    """Lanes of different step sizes (a jittered coarse grid), through the
    model's step_batched (K20's plain BE / BDF2 mode) against JAX's vmapped
    step."""
    mj, mp = _model(J, cls), _model(P, cls)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((6, 2, 31))
    tp = mp.t[[0, 2, 3, 7, 9, 12]]
    tc = mp.t[[2, 3, 6, 8, 12, 16]]
    ref = jax.vmap(mj.step)(dict(first=jnp.asarray(u[:, 0]), second=jnp.asarray(u[:, 1])),
                           jnp.asarray(tp), jnp.asarray(tc))
    got = mp.step_batched(torch.as_tensor(u), tp, tc).numpy()
    ref = _pair(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    one = mp.step(torch.as_tensor(u[2]), tp[2], tc[2]).numpy()
    np.testing.assert_allclose(one, ref[2], rtol=0, atol=1e-12 * np.abs(ref).max())


def test_plain_bdf2_mode_matches_jax_helmholtz():
    """K20's BDF2 mode (plain version): ((r - c2 x) + c1 x2) through the
    Helmholtz solve, lane by lane against JAX's solve_helmholtz_1d."""
    n = 23
    S, lam = sine_eigenbasis(n, 576.0)
    rng = np.random.default_rng(8)
    x, x2, r = (rng.standard_normal((5, n)) for _ in range(3))
    c2, c1, coeff = (rng.uniform(1, 50, 5) for _ in range(3))
    t = lambda a: torch.as_tensor(a)
    out = torch.empty((5, n), dtype=torch.float64)
    heat_kernels.sine_solve1d(t(x), out, t(S), t(lam), rhs=t(r), second=t(x2), c2=t(c2),
                              c1=t(c1), coeff=t(coeff))
    for b in range(5):
        rhs = r[b] - c2[b] * x[b] + c1[b] * x2[b]
        ref = np.asarray(j_helmholtz(S, lam, coeff[b], jnp.asarray(rhs)))
        np.testing.assert_allclose(out[b].numpy(), ref, rtol=0, atol=1e-13 * np.abs(ref).max())
        np.testing.assert_allclose(solve_helmholtz_1d(t(S), t(lam), coeff[b], t(rhs)).numpy(),
                                   ref, rtol=0, atol=1e-13 * np.abs(ref).max())


def _hierarchy(mod, nx=65, **skw):
    """tests/core/test_cross_validation_2.py::test_bdf2_hierarchy_matches_reference
    (nt = 64, pair grid of 33 points, BDF2 / BDF1 / BDF1)."""
    nt = 64
    dtau = 2.0 / nt
    ti = np.linspace(0, 2, nt // 2 + 1)
    kw = dict(x_start=0, x_end=1, nx=nx, a=1, dtau=dtau, rhs=_rhs(mod), init_cond=_ic,
              **_cpu(mod))
    h0 = mod.Heat1DBDF2(t_interval=ti, **kw)
    h1 = mod.Heat1DBDF1(t_interval=h0.t[::2], **kw)
    h2 = mod.Heat1DBDF1(t_interval=h1.t[::2], **kw)
    return mod.Mgrit(problem=[h0, h1, h2], logging_lvl=30, **{"tol": 1e-9, "max_iter": 10, **skw})


def _history(mgrit):
    """The whole history (solve() drops a residual that is exactly 0)."""
    mgrit.solve()
    return mgrit.conv[1:mgrit.solve_iter + 1]


def _compare(mj, hj, mp, hp, n):
    uj = np.stack([np.asarray(mj.u[0]["first"]), np.asarray(mj.u[0]["second"])], axis=1)
    up = mp.u[0].numpy()
    floor = (8 + 4 * np.sqrt(n)) * EPS * float(np.linalg.norm(uj[mp.levels[0].cpts]))
    assert hp.shape == hj.shape, (hp, hj)
    np.testing.assert_allclose(hp, hj, rtol=1e-9, atol=floor)
    np.testing.assert_allclose(up, uj, rtol=0, atol=1e-10 * np.abs(uj).max())


@pytest.mark.parametrize("skw", [dict(), dict(cycle_type="F", nested_iteration=False)],
                         ids=["V-nested", "F"])
def test_bdf2_hierarchy_matches_jax(skw):
    mj, mp = _hierarchy(J, **skw), _hierarchy(P, **skw)
    reset_launch_counts()
    hj, hp = _history(mj), _history(mp)
    assert launch_counts()["sine_solve1d"] == 0          # CPU tensors: the plain version
    _compare(mj, hj, mp, hp, 63)


def test_second_solve_makes_no_device_table():
    """Step sizes, BDF2 coefficients and the rhs rows' gather index are made
    on the device once per distinct set of step times: a second solve of
    the same hierarchy reuses every one (no host-to-device copy) and gives
    the same history."""
    first = _hierarchy(P, nx=17)
    h1 = _history(first)
    tables = [dict(p._times._cache) for p in first.problem]
    assert all(any(k[0] == "rhs" for k in t) for t in tables)
    h2 = _history(P.Mgrit(problem=first.problem, logging_lvl=30, tol=1e-9, max_iter=10))
    np.testing.assert_array_equal(h2, h1)
    for p, before in zip(first.problem, tables):
        after = p._times._cache
        assert after.keys() == before.keys()
        assert all(after[k] is before[k] for k in before)


def test_bdf_on_a_jittered_pair_grid_matches_jax():
    """A ragged coarse pair grid: per-lane dt in both modes, the index route
    of non-uniform coarsening."""
    ti = np.linspace(0, 2, 33)
    idx = np.array([0, 2, 3, 6, 9, 10, 14, 18, 21, 22, 26, 30, 32])

    def build(mod):
        kw = dict(x_start=0, x_end=1, nx=33, a=1, dtau=1.0 / 32, rhs=_rhs(mod), init_cond=_ic,
                  **_cpu(mod))
        return mod.Mgrit(problem=[mod.Heat1DBDF2(t_interval=ti, **kw),
                                  mod.Heat1DBDF1(t_interval=ti[idx], **kw)],
                         tol=1e-300, max_iter=4, logging_lvl=30)

    mj, mp = build(J), build(P)
    _compare(mj, _history(mj), mp, _history(mp), 31)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    """Two iterations in JAX, saved (pair dicts: two leaves a tube), loaded
    into the port and continued: the remaining history is JAX's."""
    kw = dict(max_iter=2, tol=1e-300)
    mj = _hierarchy(J, **kw)
    mj.solve()
    path = str(tmp_path / "pairs.npz")
    mj.save_checkpoint(path)
    ref = _hierarchy(J, max_iter=4, tol=1e-300)
    href = ref.solve()["conv"]
    mp = _hierarchy(P, max_iter=2, tol=1e-300, nested_iteration=False)
    mp.load_checkpoint(path)
    assert tuple(mp.u[1].shape) == (17, 2, 63)
    hp = mp.solve()["conv"]
    uj = np.stack([np.asarray(ref.u[0]["first"]), np.asarray(ref.u[0]["second"])], axis=1)
    floor = (8 + 4 * np.sqrt(63)) * EPS * float(np.linalg.norm(uj[mp.levels[0].cpts]))
    np.testing.assert_allclose(hp, href[2:], rtol=1e-9, atol=floor)
    np.testing.assert_allclose(mp.u[0].numpy(), uj, rtol=0, atol=1e-10 * np.abs(uj).max())


def test_pair_state_and_interop_layout():
    first, second = np.arange(4.0), -np.arange(4.0)
    np.testing.assert_array_equal(P.PairState(torch.as_tensor(first),
                                              torch.as_tensor(second)).numpy(),
                                  np.stack([first, second]))
    mp = _hierarchy(P, max_iter=1)
    assert mp.u[0].shape[1:] == (2, 63) and mp.ops is DISPATCH
