"""Port parity: ``Application.state_norm``, against ``pymgrit_tpu``.

JAX's ``Mgrit`` takes ``getattr(problem[0], "state_norm", vector.norm)``
for its residual and jump norms, applied to each C-point's difference
state.  The same backward-Euler applications -- a 3-vector state, and a
dict of a (3,) and a (2,) leaf -- with ``state_norm = max |x|`` over all
leaves are built in both packages and solved, for ``conv_crit`` 0-3 on a
uniform two-level hierarchy (nt = 33, m = 4) and a three-level ragged one,
in ``solve()`` and ``solve_compiled()``.  The histories
``conv[1:solve_iter + 1]`` and the level-0 tubes are compared at rtol
1e-12 with the float64 floor (8 + 4 sqrt(n)) eps ||u_C||_2 of the C-point
values as atol.  Without the hook the port keeps K3's 2-norm route.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
RTOL = 1e-12
LAM, C = np.array([1.0, 2.5, 4.0]), np.array([0.2, -0.1, 0.4])


def _max_abs(mod):
    """max |x| over every leaf of a state (JAX: jnp; the port: torch)."""
    if mod is J:
        return lambda u: jnp.max(jnp.stack([jnp.max(jnp.abs(x)) for x in
                                            (u.values() if isinstance(u, dict) else [u])]))
    return lambda u: torch.max(torch.stack([torch.max(torch.abs(x)) for x in
                                            (u.values() if isinstance(u, dict) else [u])]))


def _host_max_abs(u):
    """max |x| read on the host (``.item()``): torch.vmap refuses it."""
    return torch.tensor(max(float(torch.max(torch.abs(x)).item()) for x in u.values()),
                        dtype=torch.float64)


def _app(mod, kind, norm, **grid):
    arr = ((lambda a: jnp.asarray(a, dtype=jnp.float64)) if mod is J
           else (lambda a: torch.tensor(a, dtype=torch.float64)))
    xp = jnp if mod is J else torch
    lam, c, mu = arr(LAM), arr(C), arr([0.5, 3.0])

    class Vec(mod.Application):
        def __init__(self, **kw):
            super().__init__(**kw)
            a0, b0 = arr([1.0, -0.5, 0.25]), arr([0.3, -1.0])
            self.vector_t_start = a0 if kind == "vector" else {"vel": b0, "pos": a0}
            self.vector_template = (0 * a0 if kind == "vector"
                                    else {"vel": 0 * b0, "pos": 0 * a0})
            if norm is not None:
                self.state_norm = norm

        def step(self, u, t_start, t_stop):
            dt = t_stop - t_start
            if kind == "vector":
                return (u + dt * t_stop * c) / (1 + dt * lam)
            a1 = (u["pos"] + dt * t_stop * c) / (1 + dt * lam)
            return {"pos": a1, "vel": (u["vel"] + dt * xp.sum(a1)) / (1 + dt * mu)}

    return Vec(**grid)


def _grids(hierarchy):
    if hierarchy == "uniform":
        t = np.linspace(0, 1, 33)
        return t, t[::4]
    t = np.linspace(0, 1, 65)
    idx1 = np.array([0, 3, 7, 8, 13, 17, 22, 24, 29, 33, 36, 41, 44, 45, 50, 55, 58, 64])
    return t, t[idx1], t[idx1][::2]


def _mgrit(mod, kind="vector", hierarchy="uniform", norm=True, **kw):
    fn = (_max_abs(mod) if norm is True else norm) if norm else None
    problem = [_app(mod, kind, fn, t_interval=g) for g in _grids(hierarchy)]
    return mod.Mgrit(problem=problem, logging_lvl=30, **{"tol": 1e-11, "max_iter": 8, **kw})


def _leaves(u):
    return [np.asarray(u[k]) for k in sorted(u)] if isinstance(u, dict) else [np.asarray(u)]


def _compare(mj, mp):
    assert mp.solve_iter == mj.solve_iter
    uj, up = _leaves(mj.u[0]), _leaves(mp.u[0])
    n = len(mj.levels[0].cpts)
    c_pts = np.concatenate([x[mj.levels[0].cpts].reshape(n, -1) for x in uj], axis=1)
    atol = (8 + 4 * np.sqrt(c_pts.shape[1])) * EPS * float(np.linalg.norm(c_pts))
    np.testing.assert_allclose(mp.conv[1:mp.solve_iter + 1], mj.conv[1:mj.solve_iter + 1],
                               rtol=RTOL, atol=atol)
    for x, y in zip(up, uj):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("entry", ["solve", "solve_compiled"])
@pytest.mark.parametrize("hierarchy", ["uniform", "ragged"])
@pytest.mark.parametrize("conv_crit", [0, 1, 2, 3])
def test_state_norm_matches_jax(conv_crit, hierarchy, entry):
    mj, mp = (_mgrit(mod, hierarchy=hierarchy, conv_crit=conv_crit) for mod in (J, P))
    getattr(mj, entry)()
    getattr(mp, entry)()
    _compare(mj, mp)
    # the hook is what was read: the 2-norm's history differs
    m2 = _mgrit(P, hierarchy=hierarchy, conv_crit=conv_crit, norm=False)
    getattr(m2, entry)()
    assert not np.allclose(m2.conv[1:3], mp.conv[1:3], rtol=1e-3)


@pytest.mark.parametrize("kw", [dict(t_norm=1), dict(t_norm=3), dict(cycle_type="F")],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_state_norm_with_t_norms_and_f_cycles(kw):
    mj, mp = (_mgrit(mod, **kw) for mod in (J, P))
    mj.solve()
    mp.solve_compiled()
    _compare(mj, mp)


@pytest.mark.parametrize("entry", ["solve", "solve_compiled"])
def test_state_norm_of_a_dict_state(entry):
    mj, mp = (_mgrit(mod, kind="dict", conv_crit=1) for mod in (J, P))
    getattr(mj, entry)()
    getattr(mp, entry)()
    _compare(mj, mp)


def test_a_hook_vmap_refuses_runs_one_call_a_row():
    mj = _mgrit(J, kind="dict", hierarchy="ragged")
    mp = _mgrit(P, kind="dict", hierarchy="ragged", norm=_host_max_abs)
    mj.solve()
    mp.solve()
    assert mp._norm_rows is True
    _compare(mj, mp)


def test_without_the_hook_the_2_norm_goes_through_k3(monkeypatch):
    mj, mp = (_mgrit(mod, norm=False) for mod in (J, P))
    assert mp.state_norm is None
    calls = []
    rows = mp.ops.residual_row_norms
    mp.ops = mp.ops._replace(residual_row_norms=lambda a, b: calls.append(1) or rows(a, b))
    mj.solve()
    mp.solve()
    assert len(calls) == mp.solve_iter
    _compare(mj, mp)
