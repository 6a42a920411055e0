"""Port parity: Heat1D (backward Euler) in the physical and the spectral
basis, against ``pymgrit_tpu.Heat1D``.

Small size (nx = 33, so 31 interior points; nt = 129) in float64.  The two
packages evaluate the same expressions; they differ in how the rhs was
sampled (the JAX physical step calls the callable at run time, the port
reads its one table) and in XLA's matmul order and constant folding, so
single steps and tables agree to rtol 1e-12 against the largest entry
(``_close``) and solver histories to rtol 1e-9 with atol 1e-13 (the
residual tails sit near the float64 floor).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


RTOL = 1e-12
HIST_RTOL, HIST_ATOL = 1e-9, 1e-13
NX, NT, M = 33, 129, 4
N = NX - 2


def _rhs(mod, time_dependent):
    xp = jnp if mod is J else np
    if time_dependent:
        return lambda x, t: -xp.sin(xp.pi * x) * (xp.sin(t) - xp.pi ** 2 * xp.cos(t))
    return lambda x, t: xp.sin(xp.pi * x / 2) * xp.ones_like(x * t)


def _ic(x):
    return np.sin(np.pi * x / 2) + 0.25 * x * (2 - x)


def _app(mod, basis="spectral", time_dependent=False, t=None):
    t = np.linspace(0, 1, NT) if t is None else t
    return mod.Heat1D(x_start=0, x_end=2, nx=NX, a=0.5, init_cond=_ic,
                      rhs=_rhs(mod, time_dependent), t_interval=t, basis=basis, **_cpu(mod))


def _pair(basis="spectral", time_dependent=False):
    return _app(J, basis, time_dependent), _app(P, basis, time_dependent)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(p, j, rtol=RTOL):
    p, j = _np(p), _np(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * np.max(np.abs(j)))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _blocks(t, m, rows, J_):
    tp = np.stack([t[j * m:j * m + rows] for j in range(J_)], 1)
    tc = np.stack([t[j * m + 1:j * m + rows + 1] for j in range(J_)], 1)
    return tp, tc


@pytest.mark.parametrize("basis", ["physical", "spectral"])
def test_constructor_state(basis):
    hj, hp = _pair(basis)
    _close(hp.vector_t_start, hj.vector_t_start)
    assert hp.vector_template.shape == (N,) and hp.vector_template.dtype == torch.float64
    np.testing.assert_array_equal(hp.x, hj.x)
    _close(hp.S, hj.S)
    _close(hp.lam, hj.lam)
    if basis == "spectral":
        _close(hp.to_physical(hp.vector_t_start), hj.to_physical(jnp.asarray(hj.vector_t_start)))


@pytest.mark.parametrize("basis", ["physical", "spectral"])
@pytest.mark.parametrize("time_dependent", [False, True])
def test_step(basis, time_dependent):
    hj, hp = _pair(basis, time_dependent)
    u, t = _rand(N), hj.t
    # on the grid, and off the grid (the rhs callable is evaluated)
    for t0, t1 in ((t[3], t[4]), (t[7] + 1e-3, t[8] - 2e-3)):
        _close(hp.step(_t(u), t0, t1), hj.step(jnp.asarray(u), t0, t1))
    us = _rand(5, N, seed=1)
    ref = hj.step_batched(jnp.asarray(us), jnp.asarray(t[2:7]), jnp.asarray(t[3:8]))
    _close(hp.step_batched(_t(us), t[2:7], t[3:8]), ref)


@pytest.mark.parametrize("basis", ["physical", "spectral"])
@pytest.mark.parametrize("with_g", [True, False])
def test_step_chain_matches_relaxation_scan(basis, with_g):
    """J chains of L steps plus g (spectral: K2 with a zero lift)."""
    hj, hp = _pair(basis, time_dependent=True)
    t, m = hj.t, 8
    J_ = (NT - 1) // m
    tp, tc = _blocks(t, m, m - 1, J_)
    x = _rand(J_, N, seed=7)
    g = _rand(m - 1, J_, N, seed=8) * 1e-2
    vstep = jax.vmap(hj.step)

    def body(carry, inp):
        a, b, gi = inp
        out = vstep(carry, a, b)
        out = gi + out if with_g else out
        return out, out

    _, ys = jax.lax.scan(body, jnp.asarray(x), (jnp.asarray(tp), jnp.asarray(tc), jnp.asarray(g)))
    out = torch.empty((J_, m - 1, N), dtype=torch.float64)
    hp.step_chain(_t(x), tp, tc, out, _t(np.moveaxis(g, 0, 1)) if with_g else None)
    _close(out, jnp.moveaxis(ys, 0, 1))


@pytest.mark.parametrize("basis", ["physical", "spectral"])
def test_interval_tables(basis):
    hj, hp = _pair(basis)
    dt = hj.t[1] - hj.t[0]
    for m1 in (M - 1, M):
        for a, b in zip(hp._interval_tables(dt, m1), hj._interval_tables(dt, m1)):
            _close(a, b)


@pytest.mark.parametrize("basis", ["physical", "spectral"])
@pytest.mark.parametrize("layout", ["row-major", "interval-major", "only_last"])
def test_relax_interval(basis, layout):
    hj, hp = _pair(basis)
    J_ = (NT - 1) // M
    rows = M if layout == "only_last" else M - 1
    tp, tc = _blocks(hj.t, M, rows, J_)
    seeds = _rand(J_, N, seed=2)
    kw = {"only_last": layout == "only_last", "interval_major": layout == "interval-major"}
    _close(hp.relax_interval(_t(seeds), tp, tc, **kw),
           hj.relax_interval(jnp.asarray(seeds), tp, tc, **kw))


@pytest.mark.parametrize("basis", ["physical", "spectral"])
def test_relax_interval_into_tube(basis):
    """out= and seed_out= write the F-rows and C-rows of a tube."""
    hj, hp = _pair(basis)
    J_ = (NT - 1) // M
    tp, tc = _blocks(hj.t, M, M - 1, J_)
    seeds = _rand(J_, N, seed=3)
    tube = torch.zeros((J_ * M, N), dtype=torch.float64)
    blocks = tube.view(J_, M, N)
    out = blocks[:, 1:]
    assert hp.relax_interval(_t(seeds), tp, tc, out=out, seed_out=blocks[:, 0]) is out
    ref = hj.relax_interval(jnp.asarray(seeds), tp, tc, interval_major=True)
    _close(blocks[:, 1:], ref)
    np.testing.assert_array_equal(blocks[:, 0].numpy(), seeds)


def test_relax_interval_declines_alike():
    """Time-dependent rhs, and a non-uniform dt: both hooks decline."""
    tp, tc = _blocks(np.linspace(0, 1, NT), M, M - 1, 4)
    seeds = _rand(4, N)
    for basis in ("physical", "spectral"):
        hj, hp = _pair(basis, time_dependent=True)
        assert hj.relax_interval(jnp.asarray(seeds), tp, tc) is None
        assert hp.relax_interval(_t(seeds), tp, tc) is None
        hj, hp = _pair(basis)
        tc2 = tc.copy()
        tc2[0, 0] += 1e-6
        assert hj.relax_interval(jnp.asarray(seeds), tp, tc2) is None
        assert hp.relax_interval(_t(seeds), tp, tc2) is None


def test_unported_and_invalid_options():
    msgs = []
    for mod in (J, P):
        with pytest.raises(Exception) as exc:
            mod.Heat1D(x_start=0, x_end=1, nx=9, a=1.0, basis="fourier", t_start=0, t_stop=1, nt=9,
                       **_cpu(mod))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def _build(mod, basis, time_dependent, nt=NT, ms=(M, M)):
    t = np.linspace(0, 1, nt)
    out, s = [], 1
    for lvl in range(len(ms) + 1):
        out.append(_app(mod, basis, time_dependent, t[::s]))
        if lvl < len(ms):
            s *= ms[lvl]
    return out


@pytest.mark.parametrize("basis", ["physical", "spectral"])
@pytest.mark.parametrize("time_dependent", [False, True])
@pytest.mark.parametrize("entry", ["solve", "solve_compiled"])
def test_solve_matches_jax(basis, time_dependent, entry):
    """Three levels, FCF V-cycles: the condensed level-0 carry where the rhs
    is time-independent, the full tube where it is not."""
    runs = []
    for mod in (J, P):
        mgrit = mod.Mgrit(problem=_build(mod, basis, time_dependent), tol=1e-300, max_iter=4,
                          logging_lvl=40)
        assert mgrit._condensed0 == (not time_dependent)
        runs.append((mgrit, getattr(mgrit, entry)()["conv"]))
    (mj, hj), (mp, hp) = runs
    assert len(hp) == len(hj) == 4
    np.testing.assert_allclose(hp, hj, rtol=HIST_RTOL, atol=HIST_ATOL)
    np.testing.assert_allclose(mp.u[0].numpy(), np.asarray(mj.u[0]), rtol=HIST_RTOL,
                               atol=HIST_ATOL)
    assert mp.u[0].shape == (NT, N)


def test_bases_walk_one_history():
    """The sine basis is orthonormal: both bases give one history."""
    hists = [P.Mgrit(problem=_build(P, basis, True), tol=1e-300, max_iter=4,
                     logging_lvl=40).solve()["conv"] for basis in ("physical", "spectral")]
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-9, atol=HIST_ATOL)
