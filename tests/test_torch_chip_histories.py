"""The JAX histories that ``chip_smoke.py`` holds the port against on the
card, recomputed with ``pymgrit_tpu`` on the CPU.

``chip_smoke.py`` imports nothing of JAX, so it carries the JAX package's
residual histories of its ``[ragged]``, ``[bdf]``, ``[diffusion]``,
``[pytree]`` and ``[dd]`` configurations as constants (``RAGGED_JAX``,
``BDF_JAX``, ``DIFFUSION_JAX``, ``PYTREE_JAX``, ``DD_TOMS_JAX``,
``DD65_JAX``).  Each case here builds
that configuration, at its full size, in the JAX package from the script's
own settings and grids and holds the history against the constant at the
repo's history floor: rtol 1e-9 with atol (8 + 4 sqrt(n)) eps ||u_C||_2,
n the state's size and u_C the C-point rows of this solve's own level-0
tube (``_floor``).  The constants were printed by such a run on another
host, and XLA compiles the CPU code for the host's processor: the ragged
history moved by 5.07e-15 (1.07e-9 relative) between the host that
printed it and an AVX-512 host, and by 2.26e-15 under
``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``, against its floor of 2.10e-12.  The two DD
rows take minutes here (dd_toms129 about 70 s, dd65 about 7 minutes: the
Ozaki products of the physical basis), so they are marked slow; regenerate
a constant with ``python -m pytest tests/test_torch_chip_histories.py -m
slow -k dd -s``, which prints each history.  A small DD configuration
(``test_dd_route_small``) runs the script's DD hierarchy through the port
and the JAX package on every run of the suite.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pymgrit_tpu as J

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RTOL = 1e-12                    # the slow DD rows, held as before
H_RTOL = 1e-9                   # the float64 histories, with the floor as atol
EPS = np.finfo(np.float64).eps


def _floor(mgrit):
    """(8 + 4 sqrt(n)) eps ||u_C||_2 of a JAX solve's level-0 tube: n the
    state's size over every leaf, u_C the rows of the level's C-points."""
    cpts = np.asarray(mgrit.levels[0].cpts)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(mgrit.u[0])]
    n = sum(x[0].size for x in leaves)
    norm = np.sqrt(sum(np.sum(np.square(x[cpts])) for x in leaves))
    return (8 + 4 * np.sqrt(n)) * EPS * norm


def _ragged():
    cfg = chip_smoke.RAGGED

    def rhs(x, y, t):
        return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.ones_like(t * x * y)

    problem = [J.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=cfg["nx"], ny=cfg["nx"],
                        a=1.0, rhs=rhs, init_cond=lambda x, y: 0 * x * y, t_interval=g.copy())
               for g in chip_smoke.ragged_grids()]
    mgrit = J.Mgrit(problem=problem, tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=40)
    return mgrit.solve_compiled()["conv"], chip_smoke.RAGGED_JAX, _floor(mgrit)


def _bdf():
    cfg = chip_smoke.BDF

    def rhs(x, t):
        return -jnp.sin(jnp.pi * x) * (jnp.sin(t) - 1 * jnp.pi ** 2 * jnp.cos(t))

    ti = np.linspace(0, cfg["t_stop"], cfg["nt"] // 2 + 1)
    kw = dict(x_start=0, x_end=1, nx=cfg["nx"], a=1, dtau=cfg["t_stop"] / cfg["nt"], rhs=rhs,
              init_cond=lambda x: np.sin(np.pi * x))
    problem = [J.Heat1DBDF2(t_interval=ti, **kw), J.Heat1DBDF1(t_interval=ti[::2], **kw),
               J.Heat1DBDF1(t_interval=ti[::4], **kw)]
    mgrit = J.Mgrit(problem=problem, tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=30)
    return mgrit.solve()["conv"], chip_smoke.BDF_JAX, _floor(mgrit)


def _diffusion():
    cfg = chip_smoke.DIFFUSION
    problem = [J.Diffusion2D(n=cfg["n"], length=10.0, kappa=0.1, t_start=0, t_stop=10, nt=nt)
               for nt in cfg["nts"]]
    mgrit = J.Mgrit(problem=problem, tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=30)
    return mgrit.solve()["conv"], chip_smoke.DIFFUSION_JAX, _floor(mgrit)


def _dd_problem(mod, cfg, basis, **kw):
    """chip_smoke.build_problem in DD, for either package (the JAX one
    takes a traceable rhs)."""
    def rhs(x, y, t):
        return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.ones_like(t * x * y)

    t = np.linspace(0, 1, cfg["nt"])
    problem, stride = [], 1
    for lvl in range(len(cfg["ms"]) + 1):
        problem.append(mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=cfg["nx"],
                                  ny=cfg["nx"], a=1.0,
                                  rhs=rhs if mod is J else chip_smoke.rhs,
                                  init_cond=chip_smoke.init_cond, t_interval=t[::stride],
                                  basis=basis, precision="dd", **kw))
        if lvl < len(cfg["ms"]):
            stride *= cfg["ms"][lvl]
    return problem


def _dd_row(cfg, basis, committed):
    def run():
        mgrit = J.Mgrit(problem=_dd_problem(J, cfg, basis), tol=cfg["tol"],
                        max_iter=cfg["max_iter"], logging_lvl=30)
        history = mgrit.solve()["conv"]
        print(basis, repr(np.asarray(history).tolist()))
        return history, committed, None
    return run


@pytest.mark.parametrize("run", [_ragged, _bdf, _diffusion], ids=["ragged", "bdf", "diffusion"])
def test_committed_jax_history_is_jax_history(run):
    """The history at rtol 1e-9 and the solve's floor (a DD row, with no
    floor: at rtol 1e-12)."""
    history, committed, floor = run()
    history = np.asarray(history)
    assert history.shape == committed.shape
    if floor is None:
        np.testing.assert_allclose(history, committed, rtol=RTOL, atol=0)
    else:
        np.testing.assert_allclose(history, committed, rtol=H_RTOL, atol=floor)


@pytest.mark.parametrize("case", sorted(chip_smoke.PYTREE_CASES))
def test_committed_pytree_history_is_jax_history(case):
    # the [pytree] applications in the JAX package (chip_smoke.pytree_app
    # with jax.numpy)
    mg, h = chip_smoke.pytree_run(J, jnp, case)
    assert h.shape == chip_smoke.PYTREE_JAX[case].shape
    np.testing.assert_allclose(h, chip_smoke.PYTREE_JAX[case], rtol=H_RTOL, atol=_floor(mg))


@pytest.mark.slow   # dd_toms129 about 70 s, dd65 about 7 minutes on the CPU
@pytest.mark.parametrize("row", ["dd_toms129", "dd65"])
def test_committed_jax_dd_history_is_jax_history(row):
    run = _dd_row(chip_smoke.DD_TOMS, "spectral", chip_smoke.DD_TOMS_JAX) if row == "dd_toms129" \
        else _dd_row(chip_smoke.DD65, "physical", chip_smoke.DD65_JAX)
    test_committed_jax_history_is_jax_history(run)


def test_dd_route_small():
    """dd_toms129's hierarchy at 17^2 (nt = 65, 4/4; spectral, condensed) in
    the port (on the CPU, the kernels' plain versions) against the JAX
    package: the same iteration count and the history at rtol 1e-5 (a
    float32 norm) down to 1e-9, above the DD floor.  (The physical basis
    in DD costs the JAX package minutes of Ozaki compilation even at this
    size: tests/test_torch_dd_models.py holds it against a committed JAX
    history.)"""
    basis = "spectral"
    import pymgrit_tpu_torch as P
    cfg = dict(nx=17, nt=65, ms=(4, 4), tol=1e-9, max_iter=8)
    hj = np.asarray(J.Mgrit(problem=_dd_problem(J, cfg, basis), tol=cfg["tol"],
                            max_iter=cfg["max_iter"], logging_lvl=30).solve()["conv"])
    mg = P.Mgrit(problem=_dd_problem(P, cfg, basis, device="cpu"), tol=cfg["tol"],
                 max_iter=cfg["max_iter"], logging_lvl=30)
    mg.solve()
    hp = mg.conv[1:mg.solve_iter + 1]
    assert hp.shape == hj.shape
    np.testing.assert_allclose(hp, hj, rtol=chip_smoke.DD_RTOL)
