"""Port parity: applications without a space axis on a ('time', 'space')
mesh.  JAX's ``ShardedMgrit`` leaves such a state unsharded over 'space'
(``_put_spec``), so every space rank runs it whole; the port does the same
(``ShardedMgrit._space_route``: no ``space_comm``, the norms, slabs and
gathers of n_space = 1, only the time group communicating).

The cases, each at (2, 2) against JAX's ``ShardedMgrit`` / ``ShardedAtMgrit``
on its (2, 2) mesh (every one of them runs there, the BDF pair models and
the two-leaf state included) and against the port's serial solver
(``torch_shard_jax.check``: histories at rtol 1e-9 with the float64 floor
(8 + 4 sqrt(n)) eps ||u_C||_2, the tube within 1e-12 of its largest
entry), and bit for bit with the port's own (2, 1) run: Dahlquist, Heat1D
(and with ``GridTransferHeat`` 33 -> 17 between its first levels), the BDF
pair models (Heat1DBDF2 over Heat1DBDF1), Advection1D, Burgers1D,
Diffusion2D, ArenstorfOrbit, Brusselator, a two-leaf (dict) state,
``ShardedAtMgrit(4)`` on Dahlquist and a ragged Dahlquist grid (the
general path).  One gloo world of four CPU processes runs them
(``torch_shard_workers``).
"""

import numpy as np
import pytest

import torch_shard_jax as S

T_ORBIT = 17.06521656015796
T65 = np.linspace(0, 5, 65)
VARY = T65[[0, 3, 10, 12, 14, 17, 23, 27, 33, 34, 55, 57, 59, 61, 63, 64]]
HEAT1D = dict(grids=[np.linspace(0, 2, 65), np.linspace(0, 2, 17)])

REPLICATED = {
    "dahlquist": dict(build="dahlquist", build_kw=dict(nts=(65, 17)), solver_kw=dict(tol=1e-9)),
    "heat1d": dict(build="heat1d", build_kw=dict(nxs=[33, 33], **HEAT1D),
                   solver_kw=dict(tol=1e-9)),
    "heat1d_spatial": dict(build="heat1d", build_kw=dict(nxs=[33, 17], spatial=True, **HEAT1D),
                           solver_kw=dict(tol=1e-9)),
    "bdf": dict(build="bdf", build_kw=dict(nts=(33, 9)), pair=True, solver_kw=dict(tol=1e-9)),
    "advection": dict(build="zoo", build_kw=dict(model="Advection1D", nts=(33, 9), t_stop=2.0,
                                                 c=1.0, x_start=-1, x_end=1, nx=33),
                      solver_kw=dict(tol=1e-9)),
    "burgers1d": dict(build="zoo", build_kw=dict(model="Burgers1D", module="burgers",
                                                 nts=(17, 5), t_stop=0.5, nx=32, nu=0.05),
                      solver_kw=dict(tol=1e-9)),
    "diffusion": dict(build="zoo", build_kw=dict(model="Diffusion2D", nts=(17, 9), t_stop=10.0,
                                                 n=8, length=10.0, kappa=0.1),
                      solver_kw=dict(tol=1e-9)),
    "arenstorf": dict(build="zoo", build_kw=dict(model="ArenstorfOrbit", nts=(41, 11),
                                                 t_stop=T_ORBIT / 16),
                      solver_kw=dict(tol=1e-13, max_iter=3)),
    "brusselator": dict(build="zoo", build_kw=dict(model="Brusselator", nts=(33, 9),
                                                   t_stop=1.0), solver_kw=dict(tol=1e-11)),
    "two_leaf": dict(build="two_leaf", build_kw=dict(kind="dict"),
                     solver_kw=dict(tol=1e-13, max_iter=8)),
    "at_dahlquist": dict(solver="ShardedAtMgrit", k=4, build="dahlquist",
                         build_kw=dict(nts=(65, 17)), solver_kw=dict(tol=1e-9)),
    "ragged_dahlquist": dict(build="dahlquist_grid", build_kw=dict(grids=[T65, VARY]),
                             solver_kw=dict(tol=1e-10, nested_iteration=False)),
}
CASES = [dict(case, name=f"{label}_{S_}", P=2, S=S_)
         for label, case in REPLICATED.items() for S_ in (2, 1)]
BY_NAME = {c["name"]: c for c in CASES}

world = S.world_fixture(CASES, join_s=300)


@pytest.mark.parametrize("label", list(REPLICATED))
def test_replicated_matches_jax_serial_and_time_only(world, label):
    """(2, 2) against JAX's (2, 2) and the port's serial solve; every rank
    bit for bit its time shard's (2, 1) rank (history, iterations, fine
    tube); no space group (its counts are absent: no collective ran
    there), and the time group's collectives those of the (2, 1) run."""
    case = BY_NAME[f"{label}_2"]
    ranks, _ = S.check(world, case)
    time_only = world.result(f"{label}_1")
    for rank, r in enumerate(ranks):
        t = time_only[rank // 2]
        assert r["solve_iter"] == t["solve_iter"]
        assert np.array_equal(r["conv"], t["conv"])
        for a, b in zip(r["tube"], t["tube"]):
            assert np.array_equal(a, b)
        assert "space_comm" not in r
        assert r["comm"] == t["comm"]
    assert ranks[0]["general"] == (label == "ragged_dahlquist")
