"""The JAX histories that ``chip_smoke.py`` holds the port against on the
card, recomputed with ``pymgrit_tpu`` on the CPU.

``chip_smoke.py`` imports nothing of JAX, so it carries the JAX package's
residual histories of its ``[ragged]``, ``[bdf]`` and ``[diffusion]``
configurations as constants (``RAGGED_JAX``, ``BDF_JAX``, ``DIFFUSION_JAX``).
Each case here builds that configuration, at its full size, in the JAX
package from the script's own settings and grids and holds the history
against the constant at rtol 1e-12 (float64 on the CPU; the constants were
printed by such a run).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import pymgrit_tpu as J

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

RTOL = 1e-12


def _ragged():
    cfg = chip_smoke.RAGGED

    def rhs(x, y, t):
        return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.ones_like(t * x * y)

    problem = [J.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=cfg["nx"], ny=cfg["nx"],
                        a=1.0, rhs=rhs, init_cond=lambda x, y: 0 * x * y, t_interval=g.copy())
               for g in chip_smoke.ragged_grids()]
    mgrit = J.Mgrit(problem=problem, tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=40)
    return mgrit.solve_compiled()["conv"], chip_smoke.RAGGED_JAX


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
    return mgrit.solve()["conv"], chip_smoke.BDF_JAX


def _diffusion():
    cfg = chip_smoke.DIFFUSION
    problem = [J.Diffusion2D(n=cfg["n"], length=10.0, kappa=0.1, t_start=0, t_stop=10, nt=nt)
               for nt in cfg["nts"]]
    mgrit = J.Mgrit(problem=problem, tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=30)
    return mgrit.solve()["conv"], chip_smoke.DIFFUSION_JAX


@pytest.mark.parametrize("run", [_ragged, _bdf, _diffusion], ids=["ragged", "bdf", "diffusion"])
def test_committed_jax_history_is_jax_history(run):
    history, committed = run()
    history = np.asarray(history)
    assert history.shape == committed.shape
    np.testing.assert_allclose(history, committed, rtol=RTOL, atol=0)
