"""Port parity: the lane-masked BiCGStab of ``ops/cg.py`` against
``jax.vmap(jax.scipy.sparse.linalg.bicgstab)``.

Lanes of 8 x 8 nonsymmetric systems in float64 with a diagonal
preconditioner per lane: well-conditioned lanes, a lane with b = 0 (no
iteration, x = 0), an ill-conditioned lane that stops at ``maxiter``, and a
lane that breaks down (omega = 0 in its first iteration: A = [[2, -1],
[-2, 0]] on b = (-1, 0), padded with an identity block, which the
iteration leaves exactly at zero).  Tolerance: x per lane at rtol 1e-10
against the lane's largest entry (the two packages sum their inner products
in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu  # noqa: F401  (turns on float64 in JAX, as for every parity test)
from pymgrit_tpu_torch.ops.cg import bicgstab

torch.set_num_threads(1)

N = 8
RTOL = 1e-10


def _lanes():
    rng = np.random.default_rng(7)
    eye = np.eye(N)
    well = [4 * eye + 0.1 * rng.standard_normal((N, N)) for _ in range(2)]
    hard = np.diag(np.logspace(0, 2, N)) + rng.standard_normal((N, N))
    breakdown = np.eye(N)
    breakdown[:2, :2] = [[2.0, -1.0], [-2.0, 0.0]]
    A = np.stack([well[0], well[1], hard, breakdown, well[0]])
    b = rng.standard_normal((5, N))
    b[3] = 0.0
    b[3, 0] = -1.0
    b[4] = 0.0
    d = rng.uniform(0.5, 2.0, (5, N))
    d[3] = 1.0
    d[:2] = 1.0 / np.diagonal(A[:2], axis1=1, axis2=2)
    return A, b, d


def _jax(A, b, d, tol, maxiter):
    def one(Ai, bi, di):
        return jax.scipy.sparse.linalg.bicgstab(lambda x: Ai @ x, bi, M=lambda x: di * x,
                                                tol=tol, maxiter=maxiter)[0]
    return np.asarray(jax.vmap(one)(*(jnp.asarray(a) for a in (A, b, d))))


def _torch(A, b, d, tol, maxiter):
    At, bt, dt = (torch.tensor(a, dtype=torch.float64) for a in (A, b, d))
    return bicgstab(lambda x: torch.einsum("bij,bj->bi", At, x), bt, lambda x: dt * x, tol,
                    maxiter)


@pytest.mark.parametrize("maxiter", [3, 6])
def test_bicgstab_lanes_match_jax(maxiter):
    A, b, d = _lanes()
    tol = 1e-12
    x, its = _torch(A, b, d, tol, maxiter)
    xj = _jax(A, b, d, tol, maxiter)
    for lane in range(5):
        scale = max(np.abs(xj[lane]).max(), 1e-300)
        np.testing.assert_allclose(x[lane].numpy(), xj[lane], rtol=RTOL, atol=RTOL * scale)
    assert int(its[4]) == 0 and not bool(x[4].any())               # b = 0
    assert int(its[3]) == 1                                         # breakdown
    assert int(its[2]) == maxiter                                   # stops at maxiter
    if maxiter == 6:
        for lane in (0, 1):
            r = b[lane] - A[lane] @ x[lane].numpy()
            assert r @ r <= tol ** 2 * (b[lane] @ b[lane]) and 1 < int(its[lane]) < maxiter


def test_bicgstab_breakdown_lane_keeps_its_update():
    """The breakdown lane ends after its first update (omega = 0: x + alpha
    M(p), r = s), and no NaN from the finished lane's divisions reaches it
    or its neighbours."""
    A, b, d = _lanes()
    x, its = _torch(A, b, d, 1e-12, 60)
    assert bool(torch.isfinite(x).all())
    # first iteration by hand: p = r = b, alpha = <b, b> / <b, A b>
    alpha = (b[3] @ b[3]) / (b[3] @ (A[3] @ b[3]))
    np.testing.assert_array_equal(x[3].numpy(), alpha * b[3])
