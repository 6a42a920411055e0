"""Port parity: the state algebra of ``pymgrit_tpu_torch.core.vector``
against ``pymgrit_tpu.core.vector`` on the same numpy inputs.

Both sides compute each entry with the same few float64 operations, so
they agree to rounding: rtol 1e-15 (a few ulp; a norm's sum may be taken in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymgrit_tpu.core import vector as jv
from pymgrit_tpu_torch.core import vector as pv

torch.set_num_threads(1)

RTOL = 1e-15
NT = 6


def _arrays(kind, rng, lead=()):
    if kind == "scalar":
        return rng.standard_normal(lead)
    if kind == "arr1d":
        return rng.standard_normal(lead + (11,))
    if kind == "arr2d":
        return rng.standard_normal(lead + (5, 7))
    return (rng.standard_normal(lead + (9,)), rng.standard_normal(lead + (4, 3)))


def _both(a):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(a, tuple):
        pairs = [_both(x) for x in a]
        return tuple(p[0] for p in pairs), tuple(p[1] for p in pairs)
    return jnp.asarray(a), torch.tensor(np.asarray(a), dtype=torch.float64)


def _flat(a):
    if isinstance(a, tuple):
        return np.concatenate([_flat(x) for x in a])
    if isinstance(a, torch.Tensor):
        return np.atleast_1d(a.numpy()).ravel()
    return np.atleast_1d(np.asarray(a)).ravel()


def _same(j, p, rtol=RTOL):
    assert type(j) is tuple if isinstance(p, tuple) else not isinstance(j, tuple)
    if isinstance(p, tuple):
        for x, y in zip(j, p):
            assert tuple(np.shape(x)) == tuple(y.shape)
    else:
        assert tuple(np.shape(j)) == tuple(p.shape) and p.dtype == torch.float64
    np.testing.assert_allclose(_flat(p), _flat(j), rtol=rtol, atol=0)


KINDS = ["scalar", "arr1d", "arr2d", "pair"]


@pytest.fixture(params=KINDS)
def states(request):
    rng = np.random.default_rng(11)
    return [_both(_arrays(request.param, rng)) for _ in range(2)]


@pytest.fixture(params=KINDS)
def tubes(request):
    rng = np.random.default_rng(12)
    return _both(_arrays(request.param, rng, (NT,))), _both(_arrays(request.param, rng, (3,)))


def test_add_sub(states):
    (ja, pa), (jb, pb) = states
    _same(jv.add(ja, jb), pv.add(pa, pb))
    _same(jv.sub(ja, jb), pv.sub(pa, pb))


def test_scale_axpy(states):
    (ja, pa), (jb, pb) = states
    _same(jv.scale(ja, -1.7), pv.scale(pa, -1.7))
    _same(jv.axpy(ja, 0.3, jb), pv.axpy(pa, 0.3, pb))


def test_norm_zeros_like(states):
    (ja, pa), _ = states
    n = pv.norm(pa)
    assert n.dim() == 0
    np.testing.assert_allclose(n.item(), float(jv.norm(ja)), rtol=RTOL)
    _same(jv.zeros_like(ja), pv.zeros_like(pa))


def test_as_f64(states):
    (ja, pa), _ = states
    p32 = tuple(x.to(torch.float32) for x in pa) if isinstance(pa, tuple) else pa.to(torch.float32)
    out = pv.as_f64(p32)
    assert all(x.dtype == torch.float64 for x in pv.leaves(out))
    j32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), ja)
    _same(jv.as_f64(j32), out)


def test_take_set_add_at(tubes):
    (jt, pt), (jvals, pvals) = tubes
    idx = np.array([0, 2, 5])
    _same(jv.take(jt, idx), pv.take(pt, idx))
    _same(jv.set_at(jt, idx, jvals), pv.set_at(pt, idx, pvals))
    _same(jv.add_at(jt, idx, jvals), pv.add_at(pt, idx, pvals))
    # pure: the argument tube is unchanged
    _same(jt, pt)


def test_concat_length_batched_norm(tubes):
    (jt, pt), (jvals, pvals) = tubes
    _same(jv.concat([jt, jvals]), pv.concat([pt, pvals]))
    assert pv.length(pt) == jv.length(jt) == NT
    _same(jv.batched_norm(jt), pv.batched_norm(pt))


def test_tube_of(states):
    (ja, pa), _ = states
    _same(jv.tube_of(ja, 4), pv.tube_of(pa, 4))
