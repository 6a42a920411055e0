"""Port parity: Heat2D FE (the physical basis, K7's halo mode on row slabs)
and spectral ``precision='dd'`` (K23 / K24 on the slabs' DD tables, K3's
squares mode on K25's float32 resid rows) on a ('time', 'space') mesh.

* FE: nx 16, ny 17, nts (65, 17) on [0, 0.02] (dt 3.1e-4, under FE's
  bound dx^2 / (4 a) = 1.1e-3) at (2, 2), against JAX's ``ShardedMgrit`` on
  its (2, 2) mesh and the port's serial solver (histories at rtol 1e-9
  with the float64 floor, the tube within 1e-12 of its largest entry).
* DD spectral: 16^2 at nts (33, 9), against JAX's ``ShardedMgrit`` on a
  (2, 1) mesh (its (2, 2) run gave the same history to the printed digits
  but takes minutes to compile) and the port's serial DD solver (rtol 1e-5
  plus a quarter of the DD floor).

Each is also run at (2, 1) on the port: a slab's arithmetic is the whole
state's (K7's halo mode and the DD tables' rows take the same operations),
so the (2, 2) fine tube equals the (2, 1) one bit for bit, and the history
agrees within the tolerance above (only the norms' sums are split over the
space group).  ``random_init_guess`` in DD is held alike against the
(2, 1) run.  One gloo world of four CPU processes runs the cases
(``torch_shard_workers``).
"""

import numpy as np
import pytest

import torch_shard_jax as S

FE = dict(build="heat2d", build_kw=dict(nts=(65, 17), nx=16, ny=17, method="FE", t_stop=0.02),
          solver_kw=dict(tol=1e-9))
DD = dict(build="heat2d", build_kw=dict(nts=(33, 9), nx=16, ny=16, basis="spectral",
                                        precision="dd"),
          dd=True, jax_mesh=(2, 1), entry="solve_compiled", solver_kw=dict(tol=1e-10, max_iter=10))
RANDOM = dict(DD, solver_kw=dict(tol=1e-10, max_iter=10, random_init_guess=True, rng_seed=7,
                                  nested_iteration=False))
CASES = [dict(FE, name="fe_2", P=2, S=2), dict(FE, name="fe_1", P=2, S=1),
         dict(DD, name="dd_2", P=2, S=2), dict(DD, name="dd_1", P=2, S=1),
         dict(RANDOM, name="dd_random_2", P=2, S=2), dict(RANDOM, name="dd_random_1", P=2, S=1)]
BY_NAME = {c["name"]: c for c in CASES}

world = S.world_fixture(CASES)


@pytest.mark.parametrize("label,shape", [("fe", (16, 17)), ("dd", (14, 14))])
def test_space_mesh_matches_jax_serial_and_time_only(world, label, shape):
    case = BY_NAME[f"{label}_2"]
    ranks, _ = S.check(world, case)
    assert ranks[0]["tube"][0].shape[1:] == shape
    time_only = world.result(f"{label}_1")
    S.agree(ranks[0], time_only[0], case, "(2, 2) vs (2, 1)")
    for a, b in zip(ranks[0]["tube"], time_only[0]["tube"]):
        assert np.array_equal(a, b)
    assert all(r["space_comm"]["ops"] > 0 for r in ranks)


def test_dd_random_init_guess_does_not_depend_on_n_space(world):
    """``random_init_guess`` in DD draws the whole states and keeps the
    slab (the pair axis before the space axis): the (2, 2) run is the
    (2, 1) run, its tube bit for bit, its history within the DD
    tolerance."""
    case = BY_NAME["dd_random_2"]
    ranks, time_only = world.result("dd_random_2"), world.result("dd_random_1")
    S.agree(ranks[0], time_only[0], case, "(2, 2) vs (2, 1)")
    for r in ranks:
        for a, b in zip(r["tube"], time_only[0]["tube"]):
            assert np.array_equal(a, b)
