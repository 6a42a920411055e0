"""Port parity: ``random_init_guess`` draws the JAX package's initial tube.

``pymgrit_tpu_torch/core/prng.py`` repeats JAX's threefry2x32 key split
and its float64 uniform draw in numpy and draws the tube in torch on the
template's device (no jax import); the same
``rng_seed`` must give the same level-0 tube as ``pymgrit_tpu.Mgrit`` --
bit for bit, it is a draw -- for the condensed carry (the C-rows only) and
the full tube, and then the same residual history (rtol 1e-12, atol at the
float64 floor of the C-point values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.core import vector as jvector
from pymgrit_tpu_torch.core import prng

torch.set_num_threads(1)

HIST_RTOL = 1e-12


def _cpu(mod):
    return {"device": "cpu"} if mod is P else {}


@pytest.mark.parametrize("seed", [0, 7, 123456789, -3, 2 ** 40 + 5])
def test_key_split_and_uniform_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key(seed), np.asarray(key))
    np.testing.assert_array_equal(prng.split(prng.key(seed), 3), np.asarray(jax.random.split(key, 3)))
    np.testing.assert_array_equal(prng.uniform_f64(prng.key(seed), (4, 5)),
                                  np.asarray(jax.random.uniform(key, (4, 5), dtype=jnp.float64)))


@pytest.mark.parametrize("shape", [(), (3,), (5, 7)])
def test_random_tube_matches_jax_draw(shape):
    key, sub = jax.random.split(jax.random.PRNGKey(11))
    ref = jax.vmap(lambda k: jvector.random_like(np.zeros(shape), k))(jax.random.split(sub, 6))
    np.testing.assert_array_equal(prng.random_tube_numpy(11, 6, shape), np.asarray(ref))
    np.testing.assert_array_equal(prng.random_tube(11, 6, shape, "cpu").numpy(), np.asarray(ref))


def test_random_tube_in_torch_equals_numpy_in_chunks(monkeypatch):
    """The torch draw, a few rows at a time, against the numpy reference
    (bit for bit), with seeds whose keys use all 32 bits of both words."""
    monkeypatch.setattr(prng, "_CHUNK", 40)
    for seed in (3, -1, 2 ** 63 - 7):
        tube = prng.random_tube(seed, 9, (4, 5), "cpu")
        assert tube.dtype == torch.float64 and tuple(tube.shape) == (9, 4, 5)
        np.testing.assert_array_equal(tube.numpy(), prng.random_tube_numpy(seed, 9, (4, 5)))


@pytest.mark.parametrize("kind", ["leaves", "dd"])
def test_rows_draws_the_rows_of_the_whole_tube(kind):
    """``rows=`` (a time shard's rows, in any order, repeats allowed) draws
    exactly those rows of the whole tube's draw."""
    rows = np.array([7, 0, 3, 3, 12])
    if kind == "dd":
        whole = prng.random_dd_tube(5, 13, (2, 3), "cpu")
        part = prng.random_dd_tube(5, 13, (2, 3), "cpu", rows=rows)
    else:
        whole = torch.cat(prng.random_leaves(5, 13, [(3,), (2,)], "cpu"), dim=1)
        part = torch.cat(prng.random_leaves(5, 13, [(3,), (2,)], "cpu", rows=rows), dim=1)
    assert torch.equal(part, whole[torch.as_tensor(rows)])


def _rhs(mod):
    xp = jnp if mod is J else np
    return lambda x, y, t: xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * xp.ones_like(t * x * y)


def _build(mod):
    t = np.linspace(0, 0.5, 65)
    return [mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=9, ny=9, a=1.0, rhs=_rhs(mod),
                       init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                       t_interval=t[::s], **_cpu(mod)) for s in (1, 4, 16)]


@pytest.mark.parametrize("condensed", [True, False])
@pytest.mark.parametrize("seed", [0, 20240917])
def test_random_init_guess_tube_and_history_match_jax(seed, condensed):
    kw = dict(random_init_guess=True, rng_seed=seed, condensed=condensed, nested_iteration=False,
              tol=1e-10, max_iter=8, logging_lvl=30)
    mj, mp = J.Mgrit(problem=_build(J), **kw), P.Mgrit(problem=_build(P), **kw)
    assert mj._condensed0 == mp._condensed0 == condensed
    uj = np.asarray(mj.u[0])
    assert uj.shape == tuple(mp.u[0].shape) == ((17 if condensed else 65), 9, 9)
    np.testing.assert_array_equal(mp.u[0].numpy(), uj)
    assert np.ptp(uj[1:]) > 0.5              # a draw, not the zero tube
    cj, cp = mj.solve()["conv"], mp.solve()["conv"]
    u_c = mp.u[0].numpy()[::mp.levels[0].m]
    floor = 16 * np.finfo(np.float64).eps * float(np.linalg.norm(u_c))
    assert cp.shape == cj.shape
    np.testing.assert_allclose(cp, cj, rtol=HIST_RTOL, atol=floor)
