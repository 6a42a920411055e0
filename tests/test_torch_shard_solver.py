"""Port parity: the time-sharded executor (``pymgrit_tpu_torch.parallel``)
against the JAX package's ``ShardedMgrit`` / ``ShardedAtMgrit``, on the
cases of ``tests/parallel/test_shard_smoke.py``, ``test_shard_solver.py``
and ``test_mesh_invariance.py``'s time-only cases.

The port runs in one gloo world of four CPU processes for the whole file
(``torch_shard_workers``: a P = 2 case runs on ranks 0-1), started when the
first test asks for it; JAX runs each case in this process on P of the
conftest's virtual CPU devices.  Each case holds every rank's history and
fine tube equal to rank 0's bit for bit, and rank 0's against JAX's and
against the port's serial solver (``torch_shard_jax.check``: rtol 1e-9
with the float64 floor, the tube within 1e-12).
"""

import numpy as np
import pytest

import torch_shard_jax as S


def _case(name, P, nts, entry="solve", **kw):
    return dict(name=name, P=P, build="dahlquist", build_kw=dict(nts=nts), entry=entry,
                solver_kw=dict(tol=1e-10, **kw))


HEAT1D_GRIDS = [np.linspace(0, 2, 65)[::s] for s in (1, 2, 4)]
FCYCLE_GRIDS = [np.linspace(0, 2, nt) for nt in (65, 33, 17, 9, 5)]
GEOM = np.geomspace(1, 6, 65) - 1.0

CASES = [
    # test_shard_smoke: Dahlquist nt=101, three levels, m = 2, the compiled loop
    _case("smoke", 4, (101, 51, 26), entry="solve_compiled"),
    _case("two_level", 2, (129, 65)),
    _case("three_level_fcycle", 4, (257, 65, 17), cycle_type="F"),
    dict(name="heat2d", P=2, build="heat2d_serial", solver_kw=dict(tol=1e-11, max_iter=6)),
    _case("weight_c", 4, (129, 33), weight_c=1.3),
    _case("t_norm1", 2, (129, 33), t_norm=1),
    _case("t_norm3", 4, (129, 33), t_norm=3),
    _case("cf_iter2", 2, (129, 33), cf_iter=2),
    _case("padded", 4, (101, 51)),
    _case("padded_fcycle_weighted", 4, (81, 41, 21), cycle_type="F", cf_iter=2, weight_c=1.3),
    # ranks 2 and 3 own phantom intervals only, on every level
    _case("phantom_ranks", 4, (17, 5, 3)),
    dict(name="at_phantom_ranks", P=4, solver="ShardedAtMgrit", k=2, build="dahlquist",
         build_kw=dict(nts=(17, 5)), solver_kw=dict(tol=1e-10)),
    dict(name="at_masked_phantom_ranks", P=4, solver="ShardedAtMgrit", k=3, build="heat1d",
         build_kw=dict(grids=[np.linspace(0, 2, 17), np.linspace(0, 2, 17)[::4]], nxs=(9, 9)),
         solver_kw=dict(tol=1e-10)),
    dict(name="spatial", P=4, build="heat1d",
         build_kw=dict(grids=HEAT1D_GRIDS, nxs=(17, 9, 9), spatial=True),
         solver_kw=dict(tol=1e-9)),
    _case("compiled", 2, (129, 65), entry="solve_compiled"),
    dict(name="at_scalar", P=4, solver="ShardedAtMgrit", k=4, build="dahlquist",
         build_kw=dict(nts=(129, 33)), solver_kw=dict(tol=1e-9, max_iter=12)),
    dict(name="at_vector", P=2, solver="ShardedAtMgrit", k=4, build="heat1d",
         build_kw=dict(grids=[np.linspace(0, 2, 129), np.linspace(0, 2, 129)[::4]],
                       nxs=(33, 33)),
         solver_kw=dict(tol=1e-9, max_iter=12)),
    dict(name="at_padded", P=4, solver="ShardedAtMgrit", k=5, build="dahlquist",
         build_kw=dict(nts=(101, 26)), solver_kw=dict(tol=1e-9, max_iter=15)),
    # conv_crit 0 runs in every other case of both entry points
    *[dict(name=f"crit{c}_{e}", P=4 if c % 2 else 2, build="dahlquist",
           build_kw=dict(nts=(101, 51) if e == "solve_compiled" else (129, 33)), entry=e,
           solver_kw=dict(tol=1e-8, conv_crit=c))
      for c in (1, 2, 3) for e in ("solve", "solve_compiled")],
    dict(name="nonuniform_dt", P=4, build="dahlquist_grid",
         build_kw=dict(grids=[GEOM, GEOM[::2], GEOM[::4]]), solver_kw=dict(tol=1e-10)),
    # test_mesh_invariance.py's time-only cases (the five-level F-cycle at
    # nx = 33 where JAX's has 129: the same hierarchy, a quarter of JAX's
    # compile time here)
    dict(name="heat1d_fcycle", P=4, build="heat1d",
         build_kw=dict(grids=FCYCLE_GRIDS, nxs=(33,) * 5, x_end=1.0),
         solver_kw=dict(tol=1e-8, cf_iter=1, cycle_type="F", nested_iteration=False,
                        max_iter=10)),
]
BY_NAME = {c["name"]: c for c in CASES}

world = S.world_fixture(CASES)


@pytest.mark.parametrize("name", list(BY_NAME))
def test_sharded_matches_jax_and_serial(world, name):
    ranks, jx = S.check(world, BY_NAME[name])
    assert ranks[0]["returned"].size == np.count_nonzero(ranks[0]["conv"])


def test_padding_doubles_no_real_work(world):
    """The padded hierarchy: J = 50 intervals over 4 shards pad to 52, and
    the phantom intervals stay out of the history (checked against JAX
    and the serial solver above); the ranks moved only halos, broadcasts,
    reductions and the coarsest all_gather."""
    ranks = world.result("padded")
    comm = [r["comm"] for r in ranks]
    assert all(c["staged"] == 0 for c in comm)
    assert all(c["ops"] == comm[0]["ops"] for c in comm)
    assert all(c["bytes"] > 0 for c in comm)
