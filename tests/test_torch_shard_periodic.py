"""Port parity: Allen-Cahn on a ('time', 'space') mesh, the state's x axis
split into row slabs (the periodic models' space route: the Hartley pencil
on K20, K11's halo and prologue modes, the CG loops' reductions over the
space group), against the JAX package and the port's serial solver;
beside them the space group's periodic row halo and NaN-keeping max, and
the three models' slab steps and pencil solve against their whole states.

The JAX reference: IMEX against JAX's ``ShardedMgrit`` on the same mesh
(JAX's GSPMD splits the same axis; Allen-Cahn's dense DFT products let XLA
partition it).  IMPL and CN against JAX's serial ``Mgrit``: JAX's sharded
run of them stops on the CPU backend, because the Newton and CG
``while_loop``s run a different trip count on each time shard while the
collective permutes GSPMD puts inside them wait for all four devices (XLA's
``rendezvous.cc:127``: "Termination timeout for `collective permute` ...
Expected 4 threads to join the rendezvous, but only 2 of them arrived", the
two time shards held at two different permutes).  It stops so for IMPL and
CN at (2, 2), nx = 16, nts (33, 9), tol 1e-9, max_iter 6, over t in
[0, 0.024] (the Allen-Cahn example's horizon) and in [0, 0.004], with 8
virtual CPU devices and (IMPL) with 4.

One gloo world of four CPU processes runs the cases (``torch_shard_workers``):
IMEX, IMPL and CN at (2, 2) and (2, 1), nx = 16, nts (33, 9) over t in
[0, 0.004] (steps short enough that a CG solve takes tens of iterations,
not hundreds: each iteration is five collectives).  The checks
(``torch_shard_jax.check``): every rank equal to rank 0 bit for bit,
histories at rtol 1e-9 with the (8 + 4 sqrt(n)) eps ||u_C||_2 floor, the
tube within 1e-12 of its largest entry; the Newton and CG totals of each
(2, 2) rank equal to those of its time shard at (2, 1).
"""

import numpy as np
import pytest

import torch_shard_jax as S

METHODS = ("IMEX", "IMPL", "CN")


def _ac(method, P, S_):
    return dict(name=f"ac_{method}_{P}x{S_}", P=P, S=S_, build="periodic",
                build_kw=dict(model="AllenCahn", nts=(33, 9), method=method, t_stop=0.004),
                solver_kw=dict(tol=1e-9, max_iter=6))


CASES = [
    *[_ac(m, P, S_) for m in METHODS for P, S_ in ((2, 2), (2, 1))],
    dict(name="halo_2", P=2, S=2, probe="periodic_halo"),
    dict(name="halo_4", P=1, S=4, probe="periodic_halo"),
    dict(name="nan_max_2", P=2, S=2, probe="nan_max"),
    dict(name="nan_max_4", P=1, S=4, probe="nan_max"),
    dict(name="slab_2", P=1, S=2, probe="periodic_slab"),
    dict(name="slab_4", P=1, S=4, probe="periodic_slab"),
    dict(name="periodic_errors", P=2, S=2, probe="periodic_errors"),
]
BY_NAME = {c["name"]: c for c in CASES if "probe" not in c}

# the Newton-Krylov cases make tens of thousands of small gloo collectives (about 45 s on an
# 8-core CPU host with nothing else running);
# beside the other test files' worlds they take longer
world = S.world_fixture(CASES, join_s=360)


def check_stats(world, case, time_only):
    """Each (P, S) rank's Newton and Krylov totals, level by level, equal
    those of its time shard in the (P, 1) run."""
    ranks, ref = world.result(case["name"]), world.result(time_only["name"])
    for rank, r in enumerate(ranks):
        assert r["stats"] == ref[rank // case["S"]]["stats"], rank


@pytest.mark.parametrize("method", METHODS)
def test_allen_cahn_space_mesh_matches_jax_and_serial(world, method):
    case = BY_NAME[f"ac_{method}_2x2"]
    ranks, _ = S.check(world, case, jax_serial=method != "IMEX")
    assert ranks[0]["tube"][0].shape == (33, 16, 16)
    time_only = BY_NAME[f"ac_{method}_2x1"]
    S.agree(ranks[0], world.result(time_only["name"])[0], case, "(2, 2) vs (2, 1)")
    check_stats(world, case, time_only)
    if method != "IMEX":
        assert sum(lvl["newton"] for lvl in ranks[0]["stats"]) > 0
    # the CG loops reduce over the space group; IMEX's pencil moves its
    # solves' values (all_to_all) and no more
    assert ranks[0]["space_comm"]["ops"] > 0


@pytest.mark.parametrize("name,n", [("halo_2", 2), ("halo_4", 4)])
def test_periodic_row_halo(world, name, n):
    """Rank s receives rank s - 1's last row above and rank s + 1's first
    below, around the ring; at n = 2 both come from the one other rank
    and do not swap.  The non-periodic halo keeps zeros at the ends."""
    for out in world.result(name):
        s = out["s"]
        assert out["n"] == n
        np.testing.assert_array_equal(out["above"], np.full((2, 3), 100.5 + (s - 1) % n))
        np.testing.assert_array_equal(out["below"], np.full((2, 3), 100.0 + (s + 1) % n))
        above, below = out["ends"]
        np.testing.assert_array_equal(above, np.full((2, 3), 100.5 + s - 1 if s else 0.0))
        np.testing.assert_array_equal(below, np.full((2, 3), 100.0 + s + 1 if s < n - 1 else 0.0))
        assert out["counts"]["ops"] == 1 and out["counts"]["bytes"] == 4 * 48


@pytest.mark.parametrize("name,n", [("nan_max_2", 2), ("nan_max_4", 4)])
def test_nan_keeping_max(world, name, n):
    """A NaN on one rank's lane gives NaN on every rank (float64 and
    float32); the other lanes take the largest |value| (-inf's inf).
    Newton with the reduction stops the lane whose residual holds a NaN
    on space rank 1 at once on every rank; without it the other ranks
    would iterate that lane."""
    for out in world.result(name):
        for key in ("f64", "f32"):
            v = out[key]
            assert v[0] == n - 0.5 and np.isnan(v[1]) and v[2] == np.inf, key
        assert out["reduced"][1] == 0
        assert out["reduced"][0] == out["reduced"][2] > 0
    for out in world.result(name):
        assert (out["alone"][1] == 0) == (out["s"] == 1)


@pytest.mark.parametrize("name", ["slab_2", "slab_4"])
def test_slab_steps_and_pencil_match_whole_states(world, name):
    """On each rank: two chained steps with g of every method of the three
    models on the slab (halo modes, IMEX's prologue and Hartley pencil, the
    Newton-Krylov loops reduced over the space group) against the whole
    state's rows, and the pencil solve against K10's plain version, within
    1e-12 of the largest entry (the products sum in another order; a
    Newton-Krylov step converges to its tolerances)."""
    for out in world.result(name):
        assert len(out) == 9
        for what, (got, want) in out.items():
            assert got.shape == want.shape, what
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max(),
                                       err_msg=what)


def test_periodic_refusals(world):
    """On a (2, 2) mesh: a width that n_space does not divide raises naming
    the state's shape; Burgers1D (no space axis) runs replicated; spatial
    coarsening raises naming why no split fits it; a slab's radius (a
    count over the whole state) raises."""
    for r in world.result("periodic_errors"):
        kind, msg = r["indivisible"]
        assert kind == "ValueError" and "(2, 9, 9)" in msg and "n_space = 2" in msg, msg
        assert r["replicated"] is None, r["replicated"]
        kind, msg = r["spatial"]
        assert kind == "NotImplementedError" and "spatial coarsening" in msg \
            and "common divisor" in msg, msg
        kind, msg = r["radius"]
        assert kind == "NotImplementedError" and "slab" in msg
