"""Port parity: double-double arithmetic (``pymgrit_tpu_torch/ops/dd.py``,
the plain versions of K25 ``dd_arith``) and the DD product
(``ops/dd_matmul.py``, the plain version of K26 ``dd_matmul``), against
``pymgrit_tpu/ops/dd.py`` and ``ozaki.py``.

The cases of tests/ops/test_dd.py, each run through both packages on the
same numpy inputs and held to float64 ground truth as there.  The
elementwise DD operations are also held to the JAX package's bit for bit,
run op by op (eagerly): both round every float32 operation once, in the
same order (the port's plain ops never use a fused operation).  Under
``jax.jit`` XLA's CPU compiler contracts DD mul's multiply-adds into FMAs,
so jitted JAX differs from both in the last bits of lo
(``test_elementwise_ops`` holds that difference to the DD bound).  The
products are not bitwise equal either: K26 forms
hi + lo in float64 and accumulates in float64 (about k 2^-53 relative), the
JAX package slices the operands for its Ozaki scheme (about 2^-48), so the
two are held to each other within the DD bound 2^-47 |A| |B|.  The JAX
package's Ozaki product is slow to compile on the CPU, so the long
contraction is compared at a smaller width than the port alone checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pymgrit_tpu.ops import dd as jdd
from pymgrit_tpu.ops.ozaki import matmul_dd as j_matmul
from pymgrit_tpu_torch.ops import PLAIN, dd, dd_matmul
from pymgrit_tpu_torch.ops.dd import DD
from pymgrit_tpu_torch.ops.dd_matmul import matmul_dd

torch.set_num_threads(1)

DD_EPS = 2.0 ** -47  # one bit of headroom over the 2^-48 design point


def _rng(seed=42):
    return np.random.default_rng(seed)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float64)


def _relerr(got, want_f64):
    denom = np.maximum(np.abs(want_f64), 1e-30)
    return np.max(np.abs(got.to_float64() - want_f64) / denom)


def _same_bits(p, j):
    """The port's DD equals the JAX package's in hi and lo, bit for bit."""
    for a, b in ((p.hi, j.hi), (p.lo, j.lo)):
        np.testing.assert_array_equal(a.numpy().view(np.int32), np.asarray(b).view(np.int32))


def test_from_f64_split():
    """hi is the float32 rounding of a, lo the remainder: within 2^-47 of a,
    and the split is the JAX package's."""
    a = _rand(_rng(), (64,))
    x = dd.from_f64(a)
    np.testing.assert_allclose(x.to_float64(), a, rtol=DD_EPS, atol=0)
    assert np.all(np.abs(x.lo.numpy()) <= np.spacing(np.abs(x.hi.numpy())))
    _same_bits(x, jdd.from_f64(a))


def test_two_sum_error_free():
    s, e = dd.two_sum(torch.tensor(1.0), torch.tensor(2.0 ** -30))
    assert float(s) == 1.0 and float(e) == 2.0 ** -30
    js, je = jdd.two_sum(jnp.float32(1.0), jnp.float32(2.0 ** -30))
    assert (float(js), float(je)) == (float(s), float(e))


def test_two_prod_error_free():
    """Dekker's error term is exact: p + e == a b in float64, so it equals
    fl(a b - p) by a fused multiply-add bit for bit (what K25 could use in
    place of Dekker's split), on random float32 pairs of every sign and
    magnitude that neither overflows nor underflows."""
    a, b = torch.tensor(1.0 + 2.0 ** -12), torch.tensor(1.0 + 2.0 ** -13)
    p, e = dd.two_prod(a, b)
    assert float(p) + float(e) == (1.0 + 2.0 ** -12) * (1.0 + 2.0 ** -13)
    jp, je = jdd.two_prod(jnp.float32(1.0 + 2.0 ** -12), jnp.float32(1.0 + 2.0 ** -13))
    assert (float(jp), float(je)) == (float(p), float(e))
    rng = _rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-15, 15, 4096)).astype(np.float32)
    y = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-15, 15, 4096)).astype(np.float32)
    p, e = dd.two_prod(torch.as_tensor(x), torch.as_tensor(y))
    exact = x.astype(np.float64) * y.astype(np.float64)     # 48 bits: exact in float64
    fma = (exact - p.numpy().astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(e.numpy().view(np.int32), fma.view(np.int32))
    np.testing.assert_array_equal(p.numpy().astype(np.float64) + e.numpy(), exact)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_elementwise_ops(op):
    rng = _rng()
    a64, b64 = _rand(rng, (256,)), _rand(rng, (256,)) + 3.0
    x, y = dd.from_f64(a64), dd.from_f64(b64)
    a, b = x.to_float64(), y.to_float64()
    got = getattr(dd, op)(x, y)
    want = {"add": a + b, "sub": a - b, "mul": a * b, "div": a / b}[op]
    assert _relerr(got, want) < 4 * DD_EPS
    _same_bits(got, getattr(jdd, op)(jdd.from_f64(a64), jdd.from_f64(b64)))
    jitted = jax.jit(getattr(jdd, op))(jdd.from_f64(a64), jdd.from_f64(b64))
    assert np.max(np.abs(got.to_float64() - jitted.to_float64()) / np.abs(want)) < 2 * DD_EPS


def test_operator_overloads_mixed_types():
    a = _rand(_rng(), (32,))
    got = (dd.from_f64(a) * 1.3 + 0.25) / (1.0 - dd.from_f64(a) * dd.from_f64(a)) - dd.from_f64(a)
    want = (a * 1.3 + 0.25) / (1.0 - a * a) - a
    assert np.max(np.abs(got.to_float64() - want) / np.abs(want)) < 1e-12
    xj = jdd.from_f64(a)
    _same_bits(got, (xj * 1.3 + 0.25) / (1.0 - xj * xj) - xj)
    # a float32 tensor is taken at face value (lo = 0), as a jax array is
    f = torch.as_tensor(a.astype(np.float32))
    _same_bits(dd.from_f64(a) + f, jdd.from_f64(a) + jnp.asarray(a.astype(np.float32)))


def test_cancellation_keeps_low_bits():
    """(1 + tiny) - 1 == tiny to the float32 accuracy of tiny itself, and
    the JAX package's bits, for a scalar and for a row of such values."""
    a = np.float64(1.0) + 3.975e-12
    r = dd.from_f64(a) - 1.0
    assert abs(float(r.to_float64()) - float(a - 1.0)) < 1e-18
    _same_bits(r, jdd.from_f64(a) - 1.0)
    row = 1.0 + 3.975e-12 * _rng(5).uniform(0.5, 1.5, 64)
    r = dd.from_f64(row) - 1.0
    np.testing.assert_allclose(r.to_float64(), row - 1.0, rtol=1e-6)
    _same_bits(r, jdd.from_f64(row) - 1.0)


def test_sqrt():
    a = np.abs(_rand(_rng(), (128,))) + 0.01
    got = dd.sqrt(dd.from_f64(a))
    assert _relerr(got, np.sqrt(a)) < DD_EPS
    _same_bits(got, jdd.sqrt(jdd.from_f64(a)))


def test_sqrt_zero_safe():
    got = dd.sqrt(dd.from_f64(np.array([0.0, 4.0, -1.0])))
    np.testing.assert_allclose(got.to_float64(), [0.0, 2.0, 0.0], rtol=1e-14)
    _same_bits(got, jdd.sqrt(jdd.from_f64(np.array([0.0, 4.0, -1.0]))))


def test_at_set_add():
    a = _rand(_rng(), (16,))
    y = dd.from_f64(a).at[3:7].add(dd.from_f64(np.float64(1e-9)))
    want = a.copy()
    want[3:7] += 1e-9
    np.testing.assert_allclose(y.to_float64(), want, rtol=1e-14, atol=0)
    _same_bits(y, jdd.from_f64(a).at[3:7].add(jdd.from_f64(np.float64(1e-9))))
    z = dd.from_f64(a).at[2].set(0.1)
    _same_bits(z, jdd.from_f64(a).at[2].set(0.1))
    np.testing.assert_array_equal(dd.from_f64(a).to_float64(), jdd.from_f64(a).to_float64())


def test_pytree_registration_vmap_and_scan():
    """DD flattens to (hi, lo) as a torch pytree; torch.vmap maps over both
    (the transfer contract), and a Python scan sums rows like lax.scan."""
    from torch.utils import _pytree
    a = _rand(_rng(), (8, 16))
    x = dd.from_f64(a)
    leaves, spec = _pytree.tree_flatten(x)
    assert len(leaves) == 2 and leaves[0] is x.hi and leaves[1] is x.lo
    assert isinstance(_pytree.tree_unflatten(leaves, spec), DD)
    got = torch.vmap(lambda v: v * 2.0 + 1.0)(x)
    np.testing.assert_allclose(got.to_float64(), a * 2.0 + 1.0, rtol=1e-13, atol=1e-14)
    _same_bits(got, jax.vmap(lambda v: v * 2.0 + 1.0)(jdd.from_f64(a)))
    carry = dd.zeros_like(x[0])
    for i in range(a.shape[0]):
        carry = carry + x[i]
    np.testing.assert_allclose(carry.to_float64(), a.sum(axis=0), rtol=1e-12, atol=1e-13)
    jcarry = jdd.zeros_like(jdd.from_f64(a)[0])
    for i in range(a.shape[0]):
        jcarry = jcarry + jdd.from_f64(a)[i]
    _same_bits(carry, jcarry)
    jscan, _ = jax.lax.scan(lambda c, xi: (c + xi, None), jdd.zeros_like(jdd.from_f64(a)[0]),
                            jdd.from_f64(a))
    _same_bits(carry, jscan)


def test_k25_modes_against_the_dd_ops():
    """K25's combine and resid modes (plain) are the left-to-right DD sums
    of the DD ops: +-1 exact, other coefficients split from float64."""
    rng = _rng(11)
    xs = [dd.from_f64(_rand(rng, (4, 9))) for _ in range(3)]
    got = PLAIN.dd_arith("combine", *xs, coeffs=[1.0, -1.0, 1.3])
    _same_bits(got, jdd.add(jdd.add(jdd.DD(xs[0].hi.numpy(), xs[0].lo.numpy()),
                                    jdd.neg(jdd.DD(xs[1].hi.numpy(), xs[1].lo.numpy()))),
                            jdd.mul(jdd.DD(xs[2].hi.numpy(), xs[2].lo.numpy()),
                                    jdd.from_f64(1.3))))
    r = PLAIN.dd_arith("resid", xs[0], xs[1])
    np.testing.assert_array_equal(r.numpy(), dd.sub(xs[0], xs[1]).to_float().numpy())
    out = dd.zeros_like(xs[0])
    assert PLAIN.dd_arith("add", xs[0], xs[1], out=out) is out
    _same_bits(out, dd.add(xs[0], xs[1]))


# ---------------------------------------------------------------------------
# DD products: K26's plain version against float64 and the Ozaki product
# ---------------------------------------------------------------------------


def _bound(a, b):
    return DD_EPS * (np.abs(a) @ np.abs(b)) + 1e-30


@pytest.mark.parametrize("m,k,n", [(5, 7, 3), (64, 64, 64), (129, 127, 65),
                                   (1, 999, 1), (33, 1024, 17)])
def test_matmul_accuracy(m, k, n):
    rng = _rng()
    a, b = _rand(rng, (m, k)), _rand(rng, (k, n))
    got = matmul_dd(dd.from_f64(a), dd.from_f64(b)).to_float64()
    assert np.max(np.abs(got - a @ b) / _bound(a, b)) < 8.0
    jgot = jax.jit(j_matmul)(jdd.from_f64(a), jdd.from_f64(b)).to_float64()
    assert np.max(np.abs(got - jgot) / _bound(a, b)) < 8.0


def test_matmul_chunked_long_contraction():
    """Past the Ozaki chunk (1024) the port still takes one product."""
    rng = _rng()
    a, b = _rand(rng, (4, 3000), 0.1), _rand(rng, (3000, 4), 0.1)
    got = matmul_dd(dd.from_f64(a), dd.from_f64(b)).to_float64()
    assert np.max(np.abs(got - a @ b) / _bound(a, b)) < 16.0
    a2, b2 = a[:, :1100], b[:1100]
    got2 = matmul_dd(dd.from_f64(a2), dd.from_f64(b2)).to_float64()
    jgot = j_matmul(jdd.from_f64(a2), jdd.from_f64(b2)).to_float64()
    assert np.max(np.abs(got2 - jgot) / _bound(a2, b2)) < 16.0


def test_matmul_wild_scales():
    rng = _rng()
    a = _rand(rng, (16, 32)) * np.logspace(-8, 8, 16)[:, None]
    b = _rand(rng, (32, 16)) * np.logspace(8, -8, 16)[None, :]
    got = matmul_dd(dd.from_f64(a), dd.from_f64(b)).to_float64()
    assert np.max(np.abs(got - a @ b) / _bound(a, b)) < 8.0
    jgot = j_matmul(jdd.from_f64(a), jdd.from_f64(b)).to_float64()
    assert np.max(np.abs(got - jgot) / _bound(a, b)) < 8.0


def test_matmul_vector_cases():
    rng = _rng()
    a, v = _rand(rng, (24, 24)), _rand(rng, (24,))
    mv = matmul_dd(dd.from_f64(a), dd.from_f64(v))
    vm = matmul_dd(dd.from_f64(v), dd.from_f64(a))
    assert mv.shape == (24,) and vm.shape == (24,)
    np.testing.assert_allclose(mv.to_float64(), a @ v, rtol=1e-12)
    np.testing.assert_allclose(vm.to_float64(), v @ a, rtol=1e-12)
    np.testing.assert_allclose(mv.to_float64(), j_matmul(jdd.from_f64(a), jdd.from_f64(v))
                               .to_float64(), rtol=1e-12)


def test_matmul_under_vmap_and_batches():
    rng = _rng()
    a, s = _rand(rng, (6, 12, 12)), _rand(rng, (12, 12))
    sd = dd.from_f64(s)
    got = torch.vmap(lambda x: matmul_dd(sd, x))(dd.from_f64(a))
    want = np.einsum('ij,bjk->bik', s, a)
    np.testing.assert_allclose(got.to_float64(), want, rtol=1e-11)
    np.testing.assert_allclose(matmul_dd(sd, dd.from_f64(a)).to_float64(), want, rtol=1e-11)
    jgot = jax.vmap(lambda x: j_matmul(jdd.from_f64(s), x))(jdd.from_f64(a))
    np.testing.assert_allclose(got.to_float64(), jgot.to_float64(), rtol=1e-11)


def test_matmul_operator():
    rng = _rng()
    a, b = _rand(rng, (8, 8)), _rand(rng, (8, 8))
    got = dd.from_f64(a) @ dd.from_f64(b)
    np.testing.assert_allclose(got.to_float64(), a @ b, rtol=1e-12)
    np.testing.assert_allclose((dd.from_f64(a) @ b).to_float64(), a @ b, rtol=1e-12)
    np.testing.assert_allclose(got.to_float64(), (jdd.from_f64(a) @ jdd.from_f64(b))
                               .to_float64(), rtol=1e-12)


def test_spectral_solve_roundtrip_dd():
    """Sine-basis shifted solve in DD within 1e-12 of the float64 solve,
    as the JAX package's."""
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis
    n = 127
    S, lam = sine_eigenbasis(n, 100.0)
    bvec = np.random.default_rng(7).standard_normal(n)
    shift = 1e-3
    want = np.linalg.solve(np.eye(n) + shift * (S @ np.diag(lam) @ S), bvec)

    def solve(m, ops):
        Sd = m.from_f64(S)
        xh = (Sd @ m.from_f64(bvec)) / (1.0 + m.from_f64(np.float64(shift)) * m.from_f64(lam))
        return (Sd @ xh).to_float64()

    got = solve(dd, None)
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-12
    jgot = solve(jdd, None)
    assert np.max(np.abs(got - jgot)) / np.max(np.abs(want)) < 1e-12


def test_dd_matmul_wrapper_checks():
    """The K26 wrapper's plain route on CPU tensors and its refusals."""
    a, b = dd.from_f64(np.ones((2, 3, 4))), dd.from_f64(np.ones((2, 4, 5)))
    out = dd.zeros_like(dd.from_f64(np.zeros((2, 3, 5))))
    assert dd_matmul.dd_matmul(a, b, out=out) is out
    np.testing.assert_array_equal(out.to_float64(), np.full((2, 3, 5), 4.0))
    with pytest.raises(ValueError, match="do not chain"):
        dd_matmul.dd_matmul(a, dd.from_f64(np.ones((2, 3, 5))))
    with pytest.raises(ValueError, match="3-D"):
        dd_matmul.dd_matmul(a[0], b[0])


def test_vector_helpers_on_dd_states():
    """core/vector.py with DD leaves against the JAX package's: the algebra
    treats a DD pair as one leaf (a Python coefficient split exactly), the
    norm reads hi + lo in float32, random_like draws hi with lo = 0, add_at
    renormalizes, and the structural helpers map hi and lo alike."""
    from pymgrit_tpu.core import vector as jv
    from pymgrit_tpu_torch.core import vector as pv
    rng = _rng(21)
    a, b = _rand(rng, (6, 5)), _rand(rng, (6, 5))
    xp, yp, xj, yj = dd.from_f64(a), dd.from_f64(b), jdd.from_f64(a), jdd.from_f64(b)
    assert pv.contains_dd((xp, torch.zeros(3))) and not pv.contains_dd(torch.zeros(3))
    for fp, fj in ((lambda v, w: pv.add(v, w), lambda v, w: jv.add(v, w)),
                   (lambda v, w: pv.sub(v, w), lambda v, w: jv.sub(v, w)),
                   (lambda v, w: pv.scale(v, 1.3), lambda v, w: jv.scale(v, 1.3)),
                   (lambda v, w: pv.axpy(v, 0.7, w), lambda v, w: jv.axpy(v, 0.7, w)),
                   (lambda v, w: pv.add_at(v, np.array([1, 4]), w[:2]),
                    lambda v, w: jv.add_at(v, jnp.array([1, 4]), w[:2]))):
        _same_bits(fp(xp, yp), fj(xj, yj))
    np.testing.assert_allclose(float(pv.norm(xp)), float(jv.norm(xj)), rtol=1e-6)
    np.testing.assert_allclose(pv.batched_norm(xp).numpy(), np.asarray(jv.batched_norm(xj)),
                               rtol=1e-6)
    key = np.array([0, 42], dtype=np.uint32)
    rp, rj = pv.random_like(xp, key), jv.random_like(xj, jnp.asarray(key))
    _same_bits(rp, rj)
    assert float(rp.lo.abs().max()) == 0.0
    _same_bits(pv.take(xp, np.array([0, 3])), jv.take(xj, jnp.array([0, 3])))
    _same_bits(pv.set_at(xp, np.array([2]), yp[:1]), jv.set_at(xj, jnp.array([2]), yj[:1]))
    mask = np.array([True, False, True, False, True, False])[:, None]
    _same_bits(pv.where(torch.as_tensor(mask), xp, yp), jv.where(jnp.asarray(mask), xj, yj))
    _same_bits(pv.stack([xp, yp]), jv.stack([xj, yj]))
    _same_bits(pv.concat([xp, yp]), jv.concat([xj, yj]))
    assert pv.as_f64(xp) is xp and tuple(pv.tube_of(xp[0], 4).shape) == (4, 5)
