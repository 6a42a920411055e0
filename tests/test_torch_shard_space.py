"""Port parity: the sharded executor on a ('time', 'space') mesh against the
JAX package's ``ShardedMgrit`` on the same mesh (JAX's GSPMD splits the
state's x axis; the port splits it into slabs and communicates itself).

The cases: JAX's two gate cases of ``tests/parallel/test_shard_features.py``
at (2, 2) (physical Heat2D 10 x 12, ``solve`` on nts (65, 17, 5) and
``solve_compiled`` on (33, 9, 3)), the spectral basis at (2, 2), CN in the
physical basis at (1, 2) (against JAX's (2, 2) run: XLA refuses JAX's
(1, 2) mesh), spectral ``ShardedAtMgrit(6)`` at (2, 2),
``random_init_guess`` at (2, 2) against the port's own (4, 1) run and
``output_fcn`` at (2, 2) (on the ``solve`` gate case).  One gloo world of four CPU processes runs them
(``torch_shard_workers``); JAX runs each in this process
(``torch_shard_jax.check``: every rank equal to rank 0 bit for bit, rank 0
against JAX's sharded run and the port's serial solver, histories at rtol
1e-9 with the (8 + 4 sqrt(n)) eps ||u_C||_2 floor, the tube within 1e-12
of its largest entry).  Beside them: the space group's two operations, the
distributed physical step and closed form against the whole-state step at
(1, 2), and the plain versions of K3's squares mode and K20's lam table.
"""

import numpy as np
import pytest
import torch

import torch_shard_jax as S
from pymgrit_tpu_torch.ops import heat_kernels, row_norms
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis


def _h(nts, **kw):
    return dict(build="heat2d", build_kw=dict(nts=nts, **kw))


CASES = [
    # with output_lvl 2: the hook after setup and after each iteration
    dict(name="gate_solve", P=2, S=2, output_lvl=2, **_h((65, 17, 5)), solver_kw=dict(tol=1e-9)),
    dict(name="gate_compiled", P=2, S=2, entry="solve_compiled", **_h((33, 9, 3)),
         solver_kw=dict(tol=1e-9)),
    dict(name="spectral", P=2, S=2, entry="solve_compiled", **_h((33, 9, 3), basis="spectral"),
         solver_kw=dict(tol=1e-9)),
    # JAX's SPMD partitioner refuses a (1, 2) mesh (a RET_CHECK on its
    # cross-partition all-reduce): held against JAX's (2, 2) run
    dict(name="cn_physical", P=1, S=2, jax_mesh=(2, 2), **_h((33, 9), method="CN"),
         solver_kw=dict(tol=1e-9)),
    dict(name="at_spectral", P=2, S=2, solver="ShardedAtMgrit", k=6,
         **_h((33, 9), basis="spectral"), solver_kw=dict(tol=1e-9)),
    *[dict(name=f"random_init_{P}x{S_}", P=P, S=S_, entry="solve_compiled",
           **_h((33, 9), method="CN"),
           solver_kw=dict(tol=1e-9, random_init_guess=True, rng_seed=7, nested_iteration=False))
      for P, S_ in ((2, 2), (4, 1))],
    dict(name="space_comm", P=2, S=2, probe="space_comm_ops"),
    dict(name="pencil", P=1, S=2, probe="pencil"),
]
BY_NAME = {c["name"]: c for c in CASES if "probe" not in c}

world = S.world_fixture(CASES)


@pytest.mark.parametrize("name", ["gate_solve", "gate_compiled", "spectral", "cn_physical",
                                  "at_spectral"])
def test_space_mesh_matches_jax_and_serial(world, name):
    ranks, _ = S.check(world, BY_NAME[name])
    assert ranks[0]["tube"][0].shape[1:] == ((8, 10) if "spectral" in name else (10, 12))


def test_random_init_guess_does_not_depend_on_n_space(world):
    """The (2, 2) run draws the whole states and keeps its slabs: its
    history and tube are the (4, 1) run's (and JAX's at (2, 2)).  Not the
    serial solver's: JAX's serial and sharded executors differ here too."""
    case = BY_NAME["random_init_2x2"]
    ranks, _ = S.check(world, case, serial=False)
    t4 = world.result("random_init_4x1")[0]
    S.agree(ranks[0], t4, case, "(2, 2) vs (4, 1)")


def test_output_fcn_sees_whole_states(world):
    """output_lvl 2 (the ``solve`` gate case): the hook after setup and
    after each iteration, each time with the whole (nt, nx, ny) tube on
    every rank, as JAX's."""
    ranks, jx = S.check(world, BY_NAME["gate_solve"], serial=False)
    for r in ranks:
        assert r["calls"] == jx["calls"] and r["setup_calls"] == jx["setup_calls"] == 1
        assert all(shape == (65, 10, 12) for shape in r["shapes"])
    assert len(jx["calls"]) == 1 + ranks[0]["solve_iter"]


def test_space_comm_operations(world):
    """all_to_all with uneven splits (rank s sends q + 1 values to rank q)
    and the row halo (zeros at the ends), and their counts."""
    ranks = world.result("space_comm")
    for rank, out in enumerate(ranks):
        s = rank % 2
        assert out["time"] == 2
        np.testing.assert_array_equal(out["a2a"], np.repeat([s, 10.0 + s], s + 1))
        np.testing.assert_array_equal(out["above"], np.full((2, 3), 100.5 if s else 0.0))
        np.testing.assert_array_equal(out["below"], np.full((2, 3), 0.0 if s else 101.0))
        # bytes: all_to_all's values to and from the other rank (2 - s
        # sent, s + 1 received), and one (2, 3) row each way
        assert out["counts"]["ops"] == 2 and out["counts"]["staged"] == 0
        assert out["counts"]["bytes"] == 8 * ((2 - s) + (s + 1)) + 2 * 48


@pytest.mark.parametrize("method", ["BE", "CN"])
@pytest.mark.parametrize("what", ["step", "relax"])
def test_distributed_physical_step_matches_whole_state(world, method, what):
    """The pencil step (K7 on the widened slab, K20's three passes, the ring
    and g) and the pencil closed form, on a (1, 2) mesh, against the
    whole-state plain step and closed form (K5-K7 plain): each rank's rows,
    within 1e-13 of the largest entry (the products sum in another order)."""
    for out in world.result("pencil"):
        got, want = out[method][what]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * np.abs(want).max())


def test_k3_squares_mode_plain():
    """K3's squares mode is the norms mode's sum before its root (on the
    CPU, the plain version), and the wrapper counts no launch there."""
    rng = np.random.default_rng(3)
    s, u = (torch.as_tensor(rng.uniform(-1, 1, (7, 33))) for _ in range(2))
    sq = row_norms.residual_row_norms(s, u, squares=True)
    assert torch.equal(sq, torch.sum(torch.square(s - u), dim=1))
    norms = row_norms.residual_row_norms(s, u)
    assert torch.equal(norms, row_norms.residual_row_norms_plain(s, u))
    np.testing.assert_allclose(np.sqrt(sq.numpy()), norms.numpy(), rtol=1e-15)
    assert row_norms._checked((heat_kernels.fact(s), heat_kernels.fact(u)), True) == (True, None)


@pytest.mark.parametrize("D", [1, 3, 6])
def test_k20_lam_table_plain(D):
    """K20's BE solve with a (D, n) lam table: row b divided by 1 + dt_b
    lam[b % D], as a solve of that row alone with that row's lam vector
    (to rounding: one product of B rows and one of a row may sum apart)."""
    rng = np.random.default_rng(4)
    B, n = 6, 9
    S_np, lam_np = sine_eigenbasis(n, 81.0)
    S = torch.as_tensor(S_np)
    table = torch.as_tensor(lam_np[None] + rng.uniform(0, 50, (D, 1)))
    x = torch.as_tensor(rng.uniform(-1, 1, (B, n)))
    dt = torch.as_tensor(rng.uniform(0.01, 0.1, B))
    out = heat_kernels.sine_solve1d(x, torch.empty_like(x), S, table, dt)
    for b in range(B):
        want = heat_kernels.sine_solve1d_plain(x[b:b + 1], torch.empty_like(x[:1]), S,
                                              table[b % D].contiguous(), dt[b:b + 1])
        np.testing.assert_allclose(out[b].numpy(), want[0].numpy(), rtol=1e-14, atol=1e-15)


def test_k20_lam_table_checks():
    """A table whose rows do not divide the lanes raises."""
    S_np, lam_np = sine_eigenbasis(9, 81.0)
    x = torch.zeros(6, 9, dtype=torch.float64)
    with pytest.raises(ValueError, match="lam has shape"):
        heat_kernels.sine_solve1d(x, torch.empty_like(x), torch.as_tensor(S_np),
                                  torch.zeros(4, 9, dtype=torch.float64),
                                  torch.ones(6, dtype=torch.float64))
