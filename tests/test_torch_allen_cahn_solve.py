"""Port parity: a whole MGRIT solve of the 2D Allen-Cahn equation with the
fully implicit Newton stepper (IMPL) against ``pymgrit_tpu``.  CN is in
``test_torch_allen_cahn_cn.py`` (the two are split to keep each file under
a minute).

nx = 16, t in [0, 0.032], nt = 65, three levels 65 / 17 / 5, tol 1e-10,
float64.  The JAX package takes 8 iterations to 2.93e-15 here.  Histories are held at rtol 1e-9 with an atol at the
float64 floor 8 eps ||u_C||_2 (the IMPL tail ends at that floor), the
level-0 tubes at 1e-12 absolute (|u| <= 1).
"""

import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


H_RTOL, FLOOR_OPS, TUBE_ATOL = 1e-9, 8, 1e-12


def _build(mod, method, nx=16):
    a0 = mod.AllenCahn(nx=nx, method=method, t_start=0, t_stop=0.032, nt=65, **_cpu(mod))
    return [a0] + [mod.AllenCahn(nx=nx, method=method, t_interval=a0.t[::s], **_cpu(mod))
                   for s in (4, 16)]


@pytest.mark.parametrize("method,iterations", [("IMPL", 8)])
def test_newton_solve_history_matches_jax(method, iterations):
    runs = []
    for mod in (J, P):
        mg = mod.Mgrit(problem=_build(mod, method), tol=1e-10, max_iter=10, logging_lvl=40)
        runs.append((mg, mg.solve()["conv"]))
    (mj, hj), (mp, hp) = runs
    assert hj.size == hp.size == iterations and hp[-1] < 1e-10
    u_c = mp.u[0][::4].numpy()
    floor = FLOOR_OPS * np.finfo(np.float64).eps * np.linalg.norm(u_c)
    np.testing.assert_allclose(hp, hj, rtol=H_RTOL, atol=floor)
    np.testing.assert_allclose(mp.u[0].numpy(), np.asarray(mj.u[0]), rtol=0, atol=TUBE_ATOL)
    # every level ran Newton-CG steps, and each took at least one iteration
    for p in mp.problem:
        assert p.stats["steps"] > 0 and p.stats["newton"] >= p.stats["steps"]
        assert p.stats["cg"] >= p.stats["newton"]
