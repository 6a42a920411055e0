"""Port parity: the two-species periodic models, Gray-Scott 2D (IMEX, IMPL,
EXPL, and ``ShardedAtMgrit`` on IMEX, the AT demo's stepper) and Burgers 2D,
on a ('time', 'space') mesh with the state's x axis (axis 1 of the (2, nx,
nx) pair) split into row slabs: the Hartley pencil on K20 with per-species
steps, K14's halo and prologue modes, K15's halo mode, the BiCGStab loops'
reductions over the space group.

The reference is the JAX package's serial ``Mgrit`` / ``AtMgrit`` and the
port's own (2, 1) run, not JAX's ``ShardedMgrit``: on a space axis XLA's CPU
FFT thunk refuses the layouts the partitioner gives these models' FFT
solves (``RET_CHECK failure (xla/backends/cpu/runtime/fft_thunk.cc:167)
LayoutUtil::IsMonotonicWithDim0Major``; Allen-Cahn avoids it with dense DFT
products).

One gloo world of four CPU processes runs the cases (``torch_shard_workers``)
at nx = 16, nts (33, 9) (EXPL (65, 17): its explicit steps need the finer
grid; Burgers 2D over t in [0, 0.1]): each at (2, 2) and (2, 1), Burgers 2D also at (1, 2) (one process is
both neighbours of each slab), and ``random_init_guess`` on Gray-Scott IMEX
at (2, 2) against (4, 1).  Checks as ``test_torch_shard_periodic.py``'s:
every rank equal to rank 0 bit for bit, histories at rtol 1e-9 with the
(8 + 4 sqrt(n)) eps ||u_C||_2 floor, the tube within 1e-12 of its largest
entry, the Newton and BiCGStab totals equal to the (2, 1) run's.
"""

import pytest

import torch_shard_jax as S
from test_torch_shard_periodic import check_stats


def _case(label, P, S_, model, nts=(33, 9), solver_kw=None, **kw):
    case = dict(name=f"{label}_{P}x{S_}", P=P, S=S_, build="periodic",
                build_kw=dict(model=model, nts=nts, **kw),
                solver_kw=solver_kw or dict(tol=1e-9, max_iter=6))
    return case


def _pair(label, model, **kw):
    return [_case(label, P, S_, model, **kw) for P, S_ in ((2, 2), (2, 1))]


AT = dict(solver="ShardedAtMgrit", k=4)
CASES = [
    *_pair("gs_IMEX", "GrayScott2D", method="IMEX"),
    *_pair("gs_IMPL", "GrayScott2D", method="IMPL"),
    *_pair("gs_EXPL", "GrayScott2D", method="EXPL", nts=(65, 17)),
    *[dict(c, **AT) for c in _pair("gs_AT", "GrayScott2D", method="IMEX")],
    *_pair("b2", "Burgers2D", t_stop=0.1),
    _case("b2", 1, 2, "Burgers2D", t_stop=0.1),
    *[_case("gs_random", P, S_, "GrayScott2D", method="IMEX",
            solver_kw=dict(tol=1e-9, max_iter=6, random_init_guess=True, rng_seed=7,
                           nested_iteration=False))
      for P, S_ in ((2, 2), (4, 1))],
]
BY_NAME = {c["name"]: c for c in CASES}

# the Newton-Krylov cases make tens of thousands of small gloo collectives (about 60-90 s on an
# 8-core CPU host with nothing else running);
# beside the other test files' worlds they take longer
world = S.world_fixture(CASES, join_s=360)


@pytest.mark.parametrize("label", ["gs_IMEX", "gs_IMPL", "gs_EXPL", "gs_AT", "b2"])
def test_pair_models_space_mesh_match_jax_serial_and_time_only(world, label):
    case = BY_NAME[f"{label}_2x2"]
    ranks, _ = S.check(world, case, jax_serial=True)
    assert ranks[0]["tube"][0].shape[1:] == (2, 16, 16)
    time_only = BY_NAME[f"{label}_2x1"]
    S.agree(ranks[0], world.result(time_only["name"])[0], case, "(2, 2) vs (2, 1)")
    check_stats(world, case, time_only)
    assert ranks[0]["space_comm"]["ops"] > 0


def test_one_time_shard_two_space_shards(world):
    """At (1, 2) the previous and the next shard of each slab are one
    process: Burgers 2D against JAX's serial run and the port's."""
    case = BY_NAME["b2_1x2"]
    ranks, _ = S.check(world, case, jax_serial=True)
    assert ranks[0]["stats"][0]["newton"] > 0


def test_random_init_guess_on_a_species_first_state(world):
    """``random_init_guess`` draws the whole (2, nx, nx) states and keeps
    each rank's slab of axis 1: the (2, 2) run's history and tube are the
    (4, 1) run's."""
    case = BY_NAME["gs_random_2x2"]
    ranks = world.result(case["name"])
    for r in ranks[1:]:
        assert (r["conv"] == ranks[0]["conv"]).all()
    S.agree(ranks[0], world.result("gs_random_4x1")[0], case, "(2, 2) vs (4, 1)")
