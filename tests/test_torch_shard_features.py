"""Port parity: the sharded executor's features against the JAX package's
(``tests/parallel/test_shard_features.py`` without its 2-D mesh cases):
``output_fcn`` at each output level, ``random_init_guess``, an overridden
``convergence_criterion``, a compiled criterion with a per-rank aux, the
windowed AT-MGRIT exchange (one and three hops), double-double states in
both solves, a multi-leaf (dict / tuple) state and a ``state_norm`` hook;
the mesh factory's refusals and the communication layer's operations.

One gloo world of four CPU processes runs the file's cases
(``torch_shard_workers``); JAX runs each in this process
(``torch_shard_jax.check``: every rank equal to rank 0 bit for bit, rank 0
against JAX's sharded run and the port's serial solver).
"""

import numpy as np
import pytest

import torch_shard_jax as S


def _d(nts, precision=None):
    return dict(build="dahlquist", build_kw=dict(nts=nts) if precision is None else
                dict(nts=nts, precision=precision))


CASES = [
    *[dict(name=f"output{lvl}", P=2, output_lvl=lvl, **_d((129, 33)), solver_kw=dict(tol=1e-8))
      for lvl in (0, 1, 2)],
    dict(name="random_init", P=4, **_d((65, 17)),
         solver_kw=dict(tol=1e-9, random_init_guess=True, rng_seed=7, nested_iteration=False)),
    dict(name="rel_jump", P=4, solver=("ShardedMgrit", "rel_jump"), **_d((129, 33)),
         solver_kw=dict(tol=1e-4)),
    dict(name="max_jump", P=2, solver=("ShardedMgrit", "max_jump"), entry="solve_compiled",
         aux=True, **_d((101, 51)), solver_kw=dict(tol=1e-9)),
    *[dict(name=f"at_k{k}", P=4, solver="ShardedAtMgrit", k=k, **_d((129, 65)),
           solver_kw=dict(tol=1e-9)) for k in (2, 6, 40)],
    dict(name="dd", P=4, dd=True, **_d((129, 65), "dd"), solver_kw=dict(tol=1e-10)),
    dict(name="dd_at", P=4, dd=True, solver="ShardedAtMgrit", k=6, **_d((129, 65), "dd"),
         solver_kw=dict(tol=1e-9)),
    dict(name="dd_heat2d", P=4, dd=True, build="heat2d",
         build_kw=dict(nts=(33, 9), basis="spectral", precision="dd"), entry="solve_compiled",
         solver_kw=dict(tol=1e-10, max_iter=10)),
    dict(name="dict_state", P=2, build="two_leaf", build_kw=dict(kind="dict"),
         solver_kw=dict(tol=1e-13, max_iter=8)),
    dict(name="tuple_state", P=4, build="two_leaf", build_kw=dict(kind="tuple"),
         entry="solve_compiled", solver_kw=dict(tol=1e-13, max_iter=8)),
    dict(name="state_norm", P=2, build="two_leaf", build_kw=dict(kind="dict", norm=True),
         solver_kw=dict(tol=1e-13, max_iter=8)),
    dict(name="mesh_errors", P=4, probe="mesh_errors"),
    dict(name="comm4", P=4, probe="comm_ops"),
    dict(name="comm2", P=2, probe="comm_ops"),
]
BY_NAME = {c["name"]: c for c in CASES if "probe" not in c}

world = S.world_fixture(CASES)


@pytest.mark.parametrize("name", [n for n in BY_NAME if not n.startswith("output")])
def test_sharded_matches_jax_and_serial(world, name):
    case = BY_NAME[name]
    ranks, jx = S.check(world, case, serial=name != "max_jump")
    if name == "rel_jump":
        # the scaled criterion stops early; the raw residuals are kept
        assert ranks[0]["solve_iter"] < 10
        np.testing.assert_allclose(ranks[0]["history"] * 1e4, ranks[0]["returned"], rtol=1e-15)
        np.testing.assert_allclose(ranks[0]["history"], jx["history"], rtol=1e-9)
    if name == "max_jump":
        # the per-rank aux slabs are gathered back into the global C-points
        np.testing.assert_allclose(ranks[0]["aux"][0], jx["aux"][0], rtol=1e-12, atol=1e-15)
        assert ranks[0]["aux"][0].shape == jx["aux"][0].shape
    if name.startswith("dd"):
        assert ranks[0]["returned"][-1] < BY_NAME[name]["solver_kw"]["tol"]


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_output_fcn_levels(world, lvl):
    """output_lvl 2 calls the hook after setup and after each iteration,
    1 once at the end, 0 never; the hook sees the full fine tube (nt =
    129) on every rank, as in JAX."""
    ranks, jx = S.check(world, BY_NAME[f"output{lvl}"])
    iters = ranks[0]["solve_iter"]
    for r in ranks:
        assert r["calls"] == jx["calls"]
        assert r["setup_calls"] == jx["setup_calls"]
        assert all(n == t == 129 for _, n, t in r["calls"])
    assert len(jx["calls"]) == {0: 0, 1: 1, 2: 1 + iters}[lvl]


def test_mesh_refusals(world):
    """A mesh larger than the world raises with JAX's message; a (2, 2)
    mesh has JAX's shape, and on it the solver refuses a width that
    n_space does not divide (naming the shape and n_space), and, naming
    ROADMAP A7c, an application without a space route, double-double
    states, Heat2D FE and spatial coarsening."""
    for r in world.result("mesh_errors"):
        kind, msg = r["too_big"]
        assert msg == "Mesh 64x4 needs more than the 4 available devices"
        assert r["space"] == {"time": 2, "space": 2}
        kind, msg = r["indivisible"]
        assert kind == "ValueError" and "(9, 12)" in msg and "n_space = 2" in msg
        for key, name in (("no_route", "Dahlquist"), ("dd", "precision='dd'"), ("fe", "FE"),
                          ("spatial", "spatial coarsening")):
            kind, msg = r[key]
            assert kind == "NotImplementedError" and "A7c" in msg and name in msg, (key, msg)
        assert r["shape"] == {"time": 4, "space": 1}


@pytest.mark.parametrize("name,size", [("comm4", 4), ("comm2", 2)])
def test_comm_operations(world, name, size):
    """shift (rank 0 receives zeros), broadcast from the last rank, sum and
    max, all_gather in rank order; gloo on CPU tensors stages nothing."""
    ranks = world.result(name)
    for r, out in enumerate(ranks):
        assert out["backend"] == "gloo" and not out["staged"]
        assert np.array_equal(out["shift"], np.full((3, 2), max(r - 1, 0.0)))
        assert np.array_equal(out["broadcast"], np.full(2, size - 1.0))
        assert out["sum"] == size * (size + 1) / 2 and out["max"] == size - 1
        assert np.array_equal(out["gather"], np.repeat(np.arange(size, dtype=float), 2)
                              .reshape(size, 2))
        # bytes: the (3, 2) float64 shift sent and received, the (2,)
        # float32 broadcast, two float64 scalars, the gathered (size, 2)
        sent = 48 * ((r + 1 < size) + (r > 0))
        assert out["counts"] == {"ops": 5, "staged": 0,
                                 "bytes": sent + 8 + 8 + 8 + 16 * size}
