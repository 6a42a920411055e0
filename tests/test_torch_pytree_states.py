"""Port parity: multi-leaf (pytree) states, against ``pymgrit_tpu``.

JAX states are pytrees; the port's solver stores a multi-leaf state as one
float64 row of its leaves (in JAX's leaf order: a dict's keys sorted) and
hands the application and the transfers views of those rows in their own
structure.  The same two-leaf backward-Euler application -- a (3,) leaf
``a`` decaying at rates 1..3, and a (2,) leaf ``b`` forced by the sum of
``a`` and by t -- is built in both packages, as a tuple ``(a, b)`` and as a
dict ``{"vel": b, "pos": a}`` (inserted out of key order), and solved.  The
histories ``conv[1:solve_iter + 1]`` and the level-0 tubes, leaf by leaf,
are compared at rtol 1e-12 with the float64 floor (8 + 4 sqrt(n)) eps
||u_C||_2 of the C-point values as atol (a residual is a difference of
O(1) values; both packages take the same float64 operations, but XLA may
fold a division by a constant into a product with its reciprocal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.core import vector as jvector
from pymgrit_tpu_torch.core import vector as pvector

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
RTOL = 1e-12
KINDS = ("tuple", "dict")
ENTRIES = ("solve", "solve_compiled")


def _arr(mod, a):
    return jnp.asarray(a, dtype=jnp.float64) if mod is J else torch.tensor(a, dtype=torch.float64)


def _pack(kind, a, b):
    return (a, b) if kind == "tuple" else {"vel": b, "pos": a}


def _unpack(kind, u):
    return u if kind == "tuple" else (u["pos"], u["vel"])


def _app(mod, kind, na=3, **grid):
    """The two-leaf BE application of kind "tuple" or "dict", with an
    ``a`` leaf of na points (the transfer test changes it between levels)."""
    xp = jnp if mod is J else torch
    lam, mu = _arr(mod, np.linspace(1.0, 3.0, na)), _arr(mod, [0.5, 4.0])
    a0, b0 = np.linspace(1.0, -0.25, na), np.array([0.3, -1.0])

    class TwoLeaf(mod.Application):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.vector_template = _pack(kind, _arr(mod, 0 * a0), _arr(mod, 0 * b0))
            self.vector_t_start = _pack(kind, _arr(mod, a0), _arr(mod, b0))

        def step(self, u, t_start, t_stop):
            a, b = _unpack(kind, u)
            dt = t_stop - t_start
            a1 = a / (1 + dt * lam)
            b1 = (b + dt * (0.5 * xp.sum(a1) + t_stop)) / (1 + dt * mu)
            return _pack(kind, a1, b1)

    return TwoLeaf(**grid)


def _leaves(tube):
    """A structured tube's leaves as numpy, in JAX's order."""
    if isinstance(tube, dict):
        return [np.asarray(tube[k]) for k in sorted(tube)]
    return [np.asarray(x) for x in tube]


def _compare(mj, mp, hj, hp):
    cj, cp = mj.conv[1:mj.solve_iter + 1], mp.conv[1:mp.solve_iter + 1]
    # (a solve that ends at an exact 0 drops it from the returned history)
    assert mp.solve_iter == mj.solve_iter
    uj, up = _leaves(mj.u[0]), _leaves(mp.u[0])
    assert type(mp.u[0]) is type(mj.u[0])
    c_pts = np.concatenate([x[mj.levels[0].cpts].reshape(len(mj.levels[0].cpts), -1)
                            for x in uj], axis=1)
    atol = (8 + 4 * np.sqrt(c_pts.shape[1])) * EPS * float(np.linalg.norm(c_pts))
    np.testing.assert_allclose(cp, cj, rtol=RTOL, atol=atol)
    for x, y in zip(up, uj):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=atol)


def _uniform(mod, kind, levels=2, m=4, nt=33, **skw):
    problem = mod.simple_setup_problem(_app(mod, kind, t_start=0, t_stop=1, nt=nt), levels, m)
    return mod.Mgrit(problem=problem, tol=1e-13, logging_lvl=30, **skw)


def _ragged_grids():
    t = np.linspace(0, 1, 65)
    idx1 = np.array([0, 3, 7, 8, 13, 17, 22, 24, 29, 33, 36, 41, 44, 45, 50, 55, 58, 64])
    return t, t[idx1], t[idx1][::2]


def _ragged(mod, kind, **skw):
    problem = [_app(mod, kind, t_interval=g) for g in _ragged_grids()]
    return mod.Mgrit(problem=problem, tol=1e-13, max_iter=8, logging_lvl=30, **skw)


def _run(build, *args, entry="solve", **kw):
    mj, mp = build(J, *args, **kw), build(P, *args, **kw)
    hj, hp = getattr(mj, entry)()["conv"], getattr(mp, entry)()["conv"]
    _compare(mj, mp, hj, hp)
    return mj, mp, hp


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("kind", KINDS)
def test_two_levels_m4_matches_jax(kind, entry):
    mj, mp, hp = _run(_uniform, kind, entry=entry)
    assert mp.solve_iter >= 3 and hp[0] > 1e-4


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("kind", KINDS)
def test_three_level_ragged_hierarchy_matches_jax(kind, entry):
    mj, mp, _ = _run(_ragged, kind, entry=entry)
    assert not mp.levels[0].uniform and mp._ragged[0] is not None


@pytest.mark.parametrize("kw", [dict(cycle_type="F"), dict(weight_c=0.7, cf_iter=2),
                                dict(nested_iteration=False, conv_crit=1),
                                dict(conv_crit=3, entry="solve_compiled")],
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("kind", KINDS)
def test_three_levels_solver_options(kind, kw):
    _run(_uniform, kind, levels=3, m=2, **kw)


def _at(mod, kind):
    problem = mod.simple_setup_problem(_app(mod, kind, t_start=0, t_stop=1, nt=65), 3, 4)
    return mod.AtMgrit(k=2, problem=problem, tol=1e-13, max_iter=6, logging_lvl=30)


@pytest.mark.parametrize("kind", KINDS)
def test_at_mgrit_matches_jax(kind):
    _run(_at, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_random_init_guess_draws_jax_tube(kind):
    build = lambda mod: _uniform(mod, kind, random_init_guess=True, nested_iteration=False,
                                 rng_seed=7)
    mj, mp = build(J), build(P)
    for x, y in zip(_leaves(mp.u[0]), _leaves(mj.u[0])):
        np.testing.assert_array_equal(x, y)
    _compare(mj, mp, mj.solve()["conv"], mp.solve()["conv"])


def _transfer(mod):
    """Level 0's ``a`` has 6 points, level 1's 3: restriction keeps every
    other point, interpolation repeats each; ``b`` is copied."""
    xp = jnp if mod is J else torch

    class Halve(mod.GridTransfer):
        def restriction(self, u):
            return {"pos": u["pos"][::2], "vel": u["vel"]}

        def interpolation(self, u):
            rep = jnp.repeat(u["pos"], 2) if xp is jnp else torch.repeat_interleave(u["pos"], 2)
            return {"pos": rep, "vel": u["vel"]}

    return Halve()


def _leaf_sizes(mod):
    t = np.linspace(0, 1, 33)
    problem = [_app(mod, "dict", na=6, t_interval=t), _app(mod, "dict", na=3, t_interval=t[::4])]
    return mod.Mgrit(problem=problem, transfer=[_transfer(mod)], tol=1e-13, logging_lvl=30)


@pytest.mark.parametrize("entry", ENTRIES)
def test_transfer_changes_a_leaf_size(entry):
    mj, mp, _ = _run(_leaf_sizes, entry=entry)
    assert [lay.numel for lay in mp._layouts] == [8, 5]
    assert mp.u[1]["pos"].shape == (9, 3) and mp.u[0]["pos"].shape == (33, 6)


def test_public_tubes_are_structured_views():
    mp = _uniform(P, "dict", levels=3, m=2)
    mp.solve()
    assert list(mp.u[0]) == ["pos", "vel"]
    assert mp.u[0]["pos"].shape == (33, 3) and mp.u[0]["vel"].shape == (33, 2)
    assert mp.v[0] is None and mp.g[1]["vel"].shape == (17, 2)
    assert mp.u[1]["pos"].data_ptr() == mp._u[1].data_ptr()


def test_checkpoints_carry_multi_leaf_tubes_both_ways(tmp_path):
    mj, mp = (_uniform(mod, "dict", levels=3, m=2, max_iter=2) for mod in (J, P))
    mj.solve()
    path, back = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    mj.save_checkpoint(path)
    mp.load_checkpoint(path)
    for tubes in ("u", "v", "g"):
        for tj, tp in zip(getattr(mj, tubes), getattr(mp, tubes)):
            assert (tj is None) == (tp is None)
            for x, y in zip(_leaves(tp or {}), _leaves(tj or {})):
                np.testing.assert_array_equal(x, y)
    mp.save_checkpoint(back)
    with np.load(path) as a, np.load(back) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])


def test_single_tensor_states_take_the_unpacked_path():
    problem = P.simple_setup_problem(P.Dahlquist(t_start=0, t_stop=5, nt=33, device="cpu"), 2, 4)
    mp = P.Mgrit(problem=problem, logging_lvl=30)
    assert mp._layouts == [None, None] and not mp._multi
    assert mp.u is mp._u and mp.g is mp._g


def test_dd_leaf_in_a_multi_leaf_state_raises():
    from pymgrit_tpu_torch.ops import dd
    x = dd.from_f64(np.zeros(3), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        pvector.layout((x, torch.zeros(2, dtype=torch.float64)))


@pytest.mark.parametrize("kind", ["dict", "nested"])
def test_vector_helpers_on_dicts_match_jax(kind):
    rng = np.random.default_rng(3)
    shapes = {"b": (2, 3), "a": (4,)} if kind == "dict" else {"z": ((2,), {"y": (3,), "x": ()})}

    def tree(sh, f):
        if isinstance(sh, dict):
            return {k: tree(v, f) for k, v in sh.items()}
        if isinstance(sh, tuple) and sh and isinstance(sh[0], (tuple, dict)):
            return tuple(tree(v, f) for v in sh)
        return f(sh)

    a_np, b_np = (tree(shapes, lambda s: rng.standard_normal(s)) for _ in range(2))
    ja = jax.tree_util.tree_map(jnp.asarray, a_np)
    jb = jax.tree_util.tree_map(jnp.asarray, b_np)
    pa = pvector._pytree.tree_map(lambda x: torch.tensor(x), a_np)
    pb = pvector._pytree.tree_map(lambda x: torch.tensor(x), b_np)

    def same(j, p):
        lj, lp = jax.tree_util.tree_leaves(j), pvector.leaves(p)
        assert len(lj) == len(lp)
        for x, y in zip(lj, lp):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-15, atol=0)

    same(jvector.add(ja, jb), pvector.add(pa, pb))
    same(jvector.axpy(ja, 0.3, jb), pvector.axpy(pa, 0.3, pb))
    np.testing.assert_allclose(float(pvector.norm(pa)), float(jvector.norm(ja)), rtol=1e-15)
    key = np.array([0, 11], dtype=np.uint32)
    same(jvector.random_like(ja, jnp.asarray(key)), pvector.random_like(pa, key))
    tj, tp = jvector.tube_of(ja, 4), pvector.tube_of(pa, 4)
    same(jvector.set_at(tj, jnp.array([2]), jax.tree_util.tree_map(lambda x: x[None], ja)),
         pvector.set_at(tp, [2], pvector._map(lambda x: x[None], pa)))
    np.testing.assert_allclose(pvector.batched_norm(pvector.stack([pa, pb])).numpy(),
                               np.asarray(jvector.batched_norm(jvector.stack([ja, jb]))),
                               rtol=1e-15)
