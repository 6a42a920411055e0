"""Port parity: non-uniform coarsening on the sharded executor (the JAX
package's general path: ragged blocks, Gauss-Seidel passes over adjacent
C-points, trailing F-points, all_gather level transitions), on the cases of
``tests/parallel/test_shard_nonuniform.py`` and
``test_shard_solver.py::test_non_uniform_runs_and_matches_serial``.

Golden anchor: the reference's distributed varying-coarsening history
(6 iterations, 3.73e-2 ... 4.82e-13), here at 2 and 4 shards.  One gloo
world of four CPU processes runs the file's cases; JAX runs each in this
process (``torch_shard_jax.check``).
"""

import numpy as np
import pytest

import torch_shard_jax as S

GOLDEN = [0.037311841611405, 0.003124171062320715, 3.129166834664884e-05,
          1.8514542798812671e-07, 4.995916285724713e-10, 4.82164655680165e-13]

T65 = np.linspace(0, 5, 65)
VARY_IDX = [0, 3, 10, 12, 14, 17, 23, 27, 33, 34, 55, 57, 59, 61, 63, 64]
T1 = T65[VARY_IDX]
VARYING = [T65, T1, T1[::2], T1[::2][::2], T1[::2][::2][::2]]
T101 = np.linspace(0, 5, 101)
TRAILING = [np.linspace(0, 2, 32)[::s] for s in (1, 2, 4)]


def _vary(name, P, entry="solve", grids=VARYING, **kw):
    return dict(name=name, P=P, build="dahlquist_grid", build_kw=dict(grids=grids),
                entry=entry, solver_kw={"tol": 1e-10, "nested_iteration": False, **kw})


CASES = [
    *[_vary(f"golden_p{n}", n) for n in (2, 4)],
    _vary("golden_compiled", 4, entry="solve_compiled"),
    _vary("nested", 4, nested_iteration=True),
    _vary("nested_fcycle", 4, nested_iteration=True, cycle_type="F"),
    _vary("cf2_weighted", 4, cf_iter=2, weight_c=1.3),
    _vary("adjacent_jump", 4, grids=VARYING[:2], conv_crit=1),
    dict(name="trailing_f", P=4, build="heat1d",
         build_kw=dict(grids=TRAILING, nxs=(17, 17, 17), x_end=1.0),
         solver_kw=dict(tol=1e-9, max_iter=10)),
    dict(name="dd", P=4, dd=True, build="dahlquist_grid",
         build_kw=dict(grids=[T65, T1, T1[::2]], precision="dd"),
         solver_kw=dict(tol=1e-10, max_iter=6, nested_iteration=False)),
    dict(name="at_k3", P=4, solver="ShardedAtMgrit", k=3, build="dahlquist_grid",
         build_kw=dict(grids=[T65, T1]),
         solver_kw=dict(tol=1e-10, max_iter=6, nested_iteration=False)),
    dict(name="sparse_cpoints", P=4, build="dahlquist_grid",
         build_kw=dict(grids=[T101, T101[[0, 1, 3, 7, 30, 60, 100]]]),
         solver_kw=dict(tol=1e-10, max_iter=8)),
    # two ragged blocks over four shards: ranks 2 and 3 hold phantoms only
    dict(name="phantom_ranks", P=4, build="dahlquist_grid",
         build_kw=dict(grids=[T65, T65[[0, 3, 64]]]), solver_kw=dict(tol=1e-10, max_iter=8)),
]
BY_NAME = {c["name"]: c for c in CASES}

world = S.world_fixture(CASES)


@pytest.mark.parametrize("name", list(BY_NAME))
def test_general_path_matches_jax_and_serial(world, name):
    ranks, jx = S.check(world, BY_NAME[name])
    assert ranks[0]["general"]
    # rows move by index through K21's wrapper, as on the serial solver's
    # ragged levels
    assert all(r["calls_by_op"]["indexed_combine"] > 0 for r in ranks), \
        [r["calls_by_op"] for r in ranks]
    if name.startswith("golden"):
        np.testing.assert_allclose(ranks[0]["returned"], GOLDEN, rtol=1e-6, atol=1e-15)
