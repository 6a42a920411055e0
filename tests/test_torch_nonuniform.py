"""Port parity: non-uniform coarsening (levels whose C-points are not evenly
strided), against ``pymgrit_tpu``.

Every problem is built in both packages and solved; the histories and the
level-0 tubes are compared, with the float64 floor (8 + 4 sqrt(n)) eps
||u_C||_2 of the C-point values as atol (a residual or a jump is a
difference of O(1) values, so its last digits are rounding).  Dahlquist
is held at rtol 1e-12; the heat models, advection and AT-MGRIT at rtol
1e-9 (JAX's XLA and PyTorch round the products of the sine basis
differently); the tubes at 1e-12 (Dahlquist) or 1e-10 (the rest) of their
largest entry.  The
reference's ``varying_coarsening`` and ``procs_without_points`` goldens are
held at the reference's rtol 2e-3.  The port runs the index route with the
plain version of kernel K21 ``indexed_combine`` here (CPU tensors), and the
ported ``vector`` helpers are held bit for bit against JAX's.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.core import vector as jvector
from pymgrit_tpu_torch.core import vector as pvector
from pymgrit_tpu_torch.ops import indexed

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps


def _cpu(mod):
    return {"device": "cpu"} if mod is P else {}


def _np_tube(u):
    return np.asarray(u) if not isinstance(u, torch.Tensor) else u.numpy()


def _compare(mj, hj, mp, hp, rtol, atol, tube_rtol):
    assert hp.shape == hj.shape, (hp, hj)
    np.testing.assert_allclose(hp, hj, rtol=rtol, atol=atol)
    uj, up = _np_tube(mj.u[0]), _np_tube(mp.u[0])
    assert uj.shape == up.shape
    np.testing.assert_allclose(up, uj, rtol=0, atol=tube_rtol * np.max(np.abs(uj)))


def _floor(mj, n):
    uj = _np_tube(mj.u[0])
    return (8 + 4 * np.sqrt(n)) * EPS * float(np.linalg.norm(uj[mj.levels[0].cpts]))


def _jittered(nt, stride, jitter, seed):
    """bench.py's ragged row: C-points at a stride, each moved by up to
    +-jitter, the first and last points kept."""
    rng = np.random.default_rng(seed)
    base = np.arange(0, nt, stride)
    jit = np.clip(base + rng.integers(-jitter, jitter + 1, size=base.size), 0, nt - 1)
    return np.unique(np.concatenate([[0, nt - 1], jit]))


# ---------------------------------------------------------------------------
# the reference's non-uniform goldens (tests/core/test_solver_goldens_2.py)
# ---------------------------------------------------------------------------


def _varying(mod, **skw):
    d0 = mod.Dahlquist(t_start=0, t_stop=5, nt=65, **_cpu(mod))
    d1 = mod.Dahlquist(t_interval=d0.t[[0, 3, 10, 12, 14, 17, 23, 27, 33, 34, 55, 57, 59, 61,
                                        63, 64]], **_cpu(mod))
    levels = [d0, d1]
    for _ in range(3):
        levels.append(mod.Dahlquist(t_interval=levels[-1].t[::2], **_cpu(mod)))
    return mod.Mgrit(problem=levels, tol=1e-10, nested_iteration=False, logging_lvl=30, **skw)


def _large(mod, **skw):
    d0 = mod.Dahlquist(t_start=0, t_stop=5, nt=129, **_cpu(mod))
    levels = [d0, mod.Dahlquist(t_interval=d0.t[::16], **_cpu(mod))]
    for _ in range(3):
        levels.append(mod.Dahlquist(t_interval=levels[-1].t[::2], **_cpu(mod)))
    return mod.Mgrit(problem=levels, tol=1e-10, logging_lvl=30, **skw)


_GOLDENS = {
    "varying_coarsening": (_varying, np.array([3.7312e-2, 3.1242e-3, 3.1292e-5, 1.8515e-7,
                                               4.9959e-10, 4.8216e-13])),
    "procs_without_points": (_large, np.array([7.6931e-3, 5.0699e-4, 1.2469e-5])),
}


@pytest.mark.parametrize("name", sorted(_GOLDENS))
def test_reference_goldens(name):
    build, golden = _GOLDENS[name]
    mj, mp = build(J), build(P)
    hj, hp = mj.solve()["conv"], mp.solve()["conv"]
    np.testing.assert_allclose(hp[:golden.size], golden, rtol=2e-3)
    if name == "procs_without_points":
        assert len(hp) == 4 and hp[3] < 1e-12
    else:
        assert len(hp) == golden.size
    _compare(mj, hj, mp, hp, 1e-12, _floor(mj, 1), 1e-12)


def test_varying_coarsening_weighted_runs_of_c_points():
    """Level 0 holds a run of adjacent C-points (33, 34): Gauss-Seidel
    inside the run, the u_old of the weighted update read before any
    write (weight 1 is the golden above)."""
    mj, mp = _varying(J, weight_c=0.5), _varying(P, weight_c=0.5)
    assert mp.levels[0].c_chains.rmax > 1
    _compare(mj, mj.solve()["conv"], mp, mp.solve()["conv"], 1e-12, _floor(mj, 1), 1e-12)


# ---------------------------------------------------------------------------
# simple_setup_problem(Dahlquist(nt=100), 3, 2): levels 100 / 50 / 25, the
# last point of levels 0 and 1 an F-point after the last C-point
# ---------------------------------------------------------------------------


_OPTIONS = [dict(), dict(cycle_type='F'), dict(cf_iter=0), dict(cf_iter=2, weight_c=0.7),
            dict(conv_crit=1), dict(conv_crit=2), dict(conv_crit=3, nested_iteration=False),
            dict(nested_iteration=False, cycle_type='F', weight_c=0.7),
            dict(random_init_guess=True, nested_iteration=False, rng_seed=3),
            dict(compiled=True), dict(compiled=True, conv_crit=1, cycle_type='F')]


def _nt100(mod, compiled=False, **skw):
    problem = mod.simple_setup_problem(mod.Dahlquist(t_start=0, t_stop=5, nt=100, **_cpu(mod)),
                                       3, 2)
    mgrit = mod.Mgrit(problem=problem, logging_lvl=30, **skw)
    return mgrit, (mgrit.solve_compiled() if compiled else mgrit.solve())["conv"]


@pytest.mark.parametrize("kw", _OPTIONS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items())
                         or "default")
def test_dahlquist_nt100_matches_jax(kw):
    (mj, hj), (mp, hp) = _nt100(J, **kw), _nt100(P, **kw)
    assert [li.uniform for li in mp.levels] == [False, False, False]
    assert mp.levels[0].chains.lengths[-1] == 1           # the trailing F-point
    _compare(mj, hj, mp, hp, 1e-12, _floor(mj, 1), 1e-12)


def test_solve_and_solve_compiled_agree():
    (_, h1), (_, h2) = _nt100(P), _nt100(P, compiled=True)
    np.testing.assert_array_equal(h1, h2)


def test_warning_and_decline_messages_match(caplog):
    """The JAX package's non-uniform warning, and the condensed carry's
    decline reason, are the same strings in both packages."""
    msgs = {}
    for mod in (J, P):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            d0 = mod.Dahlquist(t_start=0, t_stop=5, nt=65, **_cpu(mod))
            idx = [0, 3, 10, 12, 14, 17, 23, 27, 33, 34, 55, 57, 59, 61, 63, 64]
            mgrit = mod.Mgrit(problem=[d0, mod.Dahlquist(t_interval=d0.t[idx], **_cpu(mod))],
                              logging_lvl=20)
        msgs[mod] = ([r.getMessage() for r in caplog.records if r.levelno == logging.WARNING],
                     mgrit._cnd_decline_reason)
    assert msgs[J] == msgs[P]
    assert msgs[P][0] == ['Non-uniform coarsening between level 0 and 1. Poorly tested.']


# ---------------------------------------------------------------------------
# the heat models, advection and AT-MGRIT on jittered grids
# ---------------------------------------------------------------------------


def _rhs1(mod):
    xp = jnp if mod is J else np
    return lambda x, t: -xp.sin(xp.pi * x) * (xp.sin(t) - xp.pi ** 2 * xp.cos(t))


def _heat1d(mod, basis, **skw):
    t = np.linspace(0, 2, 65)
    idx1 = _jittered(65, 4, 1, 1)
    kw = dict(x_start=0, x_end=1, a=1, rhs=_rhs1(mod), init_cond=lambda x: np.sin(np.pi * x),
              basis=basis, **_cpu(mod))
    idx2 = _jittered(idx1.size, 3, 1, 5)
    problem = [mod.Heat1D(nx=17, t_interval=t, **kw), mod.Heat1D(nx=9, t_interval=t[idx1], **kw),
               mod.Heat1D(nx=5, t_interval=t[idx1][idx2], **kw)]
    transfer = [mod.GridTransferHeat(), mod.GridTransferHeat()]
    return mod.Mgrit(problem=problem, transfer=transfer, tol=1e-10, max_iter=10, logging_lvl=30,
                     **skw)


@pytest.mark.parametrize("basis,cycle", [("physical", "V"), ("spectral", "F")])
def test_heat1d_jittered_grid_with_spatial_coarsening(basis, cycle):
    """Two ragged levels with spatial coarsening on both pairs: the fused
    transfer hooks take gathered C-rows (level 1 with its g rows)."""
    mj, mp = _heat1d(J, basis, cycle_type=cycle), _heat1d(P, basis, cycle_type=cycle)
    assert not mp.levels[0].uniform and not mp.levels[1].uniform
    hj, hp = mj.solve()["conv"], mp.solve()["conv"]
    _compare(mj, hj, mp, hp, 1e-9, _floor(mj, 15), 1e-10)


def _rhs2(mod):
    xp = jnp if mod is J else np
    return lambda x, y, t: xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * (1 + t)


def _heat2d(mod, **skw):
    t = np.linspace(0, 0.25, 49)
    idx1 = _jittered(49, 4, 1, 2)
    problem = [mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=17, ny=17, a=1.0,
                          rhs=_rhs2(mod), init_cond=lambda x, y: 0 * x * y, t_interval=g,
                          **_cpu(mod))
               for g in (t, t[idx1], t[idx1][::4])]
    return mod.Mgrit(problem=problem, tol=1e-300, max_iter=3, logging_lvl=30, **skw)


def test_heat2d_physical_jittered_grid():
    """bench.py's ragged row in miniature (physical 17^2, three levels),
    with two weighted CF sweeps."""
    mj, mp = _heat2d(J, cf_iter=2, weight_c=0.8), _heat2d(P, cf_iter=2, weight_c=0.8)
    assert mp._cnd_decline_reason == mj._cnd_decline_reason
    hj, hp = mj.solve_compiled()["conv"], mp.solve_compiled()["conv"]
    _compare(mj, hj, mp, hp, 1e-9, _floor(mj, 15), 1e-10)


def _advection(mod):
    t = np.linspace(0, 2, 97)
    idx1 = _jittered(97, 3, 1, 3)
    problem = [mod.Advection1D(c=1, x_start=-1, x_end=1, nx=33, t_interval=g, **_cpu(mod))
               for g in (t, t[idx1])]
    return mod.Mgrit(problem=problem, cf_iter=1, nested_iteration=False, tol=1e-300,
                     max_iter=4, logging_lvl=30)


def test_advection_ragged_chains_through_step_chain():
    """The padded (Lmax, J) chains run through the model's step_chain (K17's
    plain version here), the padding dropped."""
    mj, mp = _advection(J), _advection(P)
    assert len(set(mp.levels[0].chains.lengths.tolist())) > 1
    hj, hp = mj.solve()["conv"], mp.solve()["conv"]
    _compare(mj, hj, mp, hp, 1e-9, _floor(mj, 32), 1e-10)


def _at(mod):
    t = np.linspace(0, 2, 65)
    idx1 = _jittered(65, 4, 1, 4)
    kw = dict(x_start=0, x_end=2, nx=5, a=1, rhs=_rhs1(mod),
              init_cond=lambda x: np.sin(np.pi * x), **_cpu(mod))
    problem = [mod.Heat1D(t_interval=g, **kw) for g in (t, t[idx1], t[idx1][::4])]
    return mod.AtMgrit(k=2, problem=problem, cf_iter=1, nested_iteration=False, max_iter=3,
                       tol=1e-300, logging_lvl=30)


def test_at_mgrit_on_a_non_uniform_hierarchy():
    mj, mp = _at(J), _at(P)
    hj, hp = mj.solve()["conv"], mp.solve()["conv"]
    _compare(mj, hj, mp, hp, 1e-9, _floor(mj, 3), 1e-10)


# ---------------------------------------------------------------------------
# the ported vector helpers and the plain K21
# ---------------------------------------------------------------------------


def test_vector_where_stack_dynamic_index():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((4, 3, 2)), rng.standard_normal((4, 3, 2))
    mask = np.array([True, False, False, True])
    np.testing.assert_array_equal(
        pvector.where(torch.as_tensor(mask), torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jvector.where(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b))))
    states = [rng.standard_normal(3) for _ in range(5)]
    np.testing.assert_array_equal(pvector.stack([torch.as_tensor(s) for s in states]).numpy(),
                                  np.asarray(jvector.stack([jnp.asarray(s) for s in states])))
    for i in (0, 2, 3, -1, -4, 7, -9):
        np.testing.assert_array_equal(
            pvector.dynamic_index(torch.as_tensor(a), torch.tensor(i)).numpy(),
            np.asarray(jvector.dynamic_index(jnp.asarray(a), i)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_vector_random_like_matches_jax(dtype):
    key = jax.random.PRNGKey(11)
    template = (np.zeros((3, 4), dtype), np.zeros(5, dtype))
    ref = jvector.random_like(tuple(jnp.asarray(x) for x in template), key)
    got = pvector.random_like(tuple(torch.as_tensor(x) for x in template), np.asarray(key))
    for g, r in zip(got, ref):
        assert g.dtype == torch.as_tensor(np.zeros(1, dtype)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


_K21 = {
    "gather": (lambda s: dict(terms=[s], coeffs=[1.0], idx=[[4, 0, 6]]), 3),
    "drop-scatter": (lambda s: dict(terms=[s[:4]], coeffs=[1.0], io=[2, 8, 5, 8]), 8),
    "weighted": (lambda s: dict(terms=[s[:3], None], coeffs=[0.7, 0.3], io=[1, 3, 6],
                                idx=[None, [1, 3, 6]]), 8),
    "fas": (lambda s: dict(terms=[s, s[:3], s[3:6]], coeffs=[1.0, -1.0, 1.0], idx=[[7, 2, 5]]),
            3),
}


@pytest.mark.parametrize("case", sorted(_K21))
def test_plain_indexed_combine_against_a_loop(case):
    """out[io[r]] = sum_k c_k term_k[i_k[r]] row by row, padded rows (index
    = the out tube's length) dropped; a None term is out itself."""
    make, rows = _K21[case]
    rng = np.random.default_rng(6)
    src = torch.as_tensor(rng.standard_normal((8, 5)))
    base = torch.as_tensor(rng.standard_normal((rows, 5)))
    kw = make(src)
    out = base.clone()
    terms = [out if t is None else t for t in kw["terms"]]
    io = kw.get("io")
    idx = [None if i is None else torch.as_tensor(i) for i in kw.get("idx", [])]
    indexed.indexed_combine_plain(out, terms, kw["coeffs"],
                                  None if io is None else torch.as_tensor(io), idx)
    ref = base.clone()
    idx = idx + [None] * (len(terms) - len(idx))
    for r in range(len(io) if io is not None else rows):
        dst = io[r] if io is not None else r
        if dst == rows:
            continue
        val = 0.0
        for c, t, i in zip(kw["coeffs"], kw["terms"], idx):
            t = base if t is None else t
            val = val + c * t[int(i[r]) if i is not None else r]
        ref[dst] = val
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
