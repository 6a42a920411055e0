"""Port parity: ``Diffusion2D`` (P1-DG SIPG, backward Euler in the
generalized eigenbasis) and the plain version of K22 ``eig_step``, against
``pymgrit_tpu``.

The host tables (M, K, V, W, lam) come from the same numpy assembly and
``scipy.linalg.eigh`` call in both packages, so they are equal bit for bit.
The step is two dense products around a diagonal scale: held against JAX's
(vmapped) step at 1e-12 of the largest entry (XLA's and PyTorch's products
round differently).  The two-level history is held at rtol 1e-9 with the
float64 floor (8 + 4 sqrt(N)) eps ||u_C||_2 as atol.  The invariants of
tests/models/test_diffusion_2d.py are held on the port's model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.models.diffusion_2d import _assemble_p1dg_sipg as j_assemble
from pymgrit_tpu_torch.models.diffusion_2d import _assemble_p1dg_sipg as p_assemble
from pymgrit_tpu_torch.ops import eig_step

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps


def _cpu(mod):
    return {"device": "cpu"} if mod is P else {}


@pytest.mark.parametrize("kappa", ["constant", "inhomogeneous"])
def test_tables_equal_jax_bit_for_bit(kappa):
    k = 0.1 if kappa == "constant" else (lambda x, y: 0.05 + 0.1 * (x > 5.0))
    for a, b in zip(j_assemble(8, 10.0, k, 5.0), p_assemble(8, 10.0, k, 5.0)):
        np.testing.assert_array_equal(a, b)
    dj = J.Diffusion2D(n=8, kappa=k, t_start=0, t_stop=1, nt=3)
    dp = P.Diffusion2D(n=8, kappa=k, t_start=0, t_stop=1, nt=3, device="cpu")
    for name in ("lam", "V", "W", "mass", "xy"):
        np.testing.assert_array_equal(getattr(dp, name), getattr(dj, name), err_msg=name)
    np.testing.assert_array_equal(dp.vector_t_start.numpy(), np.asarray(dj.vector_t_start))
    assert tuple(dp.vector_template.shape) == (6 * 8 * 8,)


def test_dd_raises_with_its_roadmap_label():
    with pytest.raises(NotImplementedError, match="A3"):
        P.Diffusion2D(n=4, precision="dd", t_start=0, t_stop=1, nt=3, device="cpu")


def test_batched_step_matches_jax():
    """Lanes of different dt through step_batched (the plain K22) against
    JAX's vmapped step."""
    dj = J.Diffusion2D(n=6, t_start=0, t_stop=1, nt=5)
    dp = P.Diffusion2D(n=6, t_start=0, t_stop=1, nt=5, device="cpu")
    rng = np.random.default_rng(9)
    u = rng.standard_normal((5, 216))
    tp, tc = np.array([0.0, 0.25, 0.5, 0.0, 0.75]), np.array([0.25, 0.5, 1.0, 1.0, 1.0])
    ref = np.asarray(jax.vmap(dj.step)(jnp.asarray(u), jnp.asarray(tp), jnp.asarray(tc)))
    got = dp.step_batched(torch.as_tensor(u), tp, tc).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    one = dp.step(torch.as_tensor(u[1]), tp[1], tc[1]).numpy()
    np.testing.assert_allclose(one, ref[1], rtol=0, atol=1e-12 * np.abs(ref).max())


def test_plain_eig_step_is_the_row_form():
    rng = np.random.default_rng(10)
    N, B = 24, 7
    W, V = rng.standard_normal((N, N)), rng.standard_normal((N, N))
    lam, dt = rng.uniform(0, 3, N), rng.uniform(0.1, 1, B)
    x = rng.standard_normal((2 * B, N))
    out = torch.zeros((B, N + 2), dtype=torch.float64)
    t = lambda a: torch.as_tensor(a)
    eig_step.eig_step(t(x)[::2], out[:, 1:N + 1], t(W), t(V), t(lam), t(dt))
    ref = np.stack([V @ ((W @ x[2 * b]) / (1.0 + dt[b] * lam)) for b in range(B)])
    np.testing.assert_allclose(out[:, 1:N + 1].numpy(), ref, rtol=0,
                               atol=1e-13 * np.abs(ref).max())
    assert not out[:, 0].any() and not out[:, -1].any()


def test_step_mass_conservation_and_decay():
    """tests/models/test_diffusion_2d.py's invariant on the port: BE steps
    conserve int u dx (periodic); after a long step only the mean is left."""
    d = P.Diffusion2D(n=12, length=10.0, kappa=0.1, t_start=0, t_stop=1, nt=3, device="cpu")
    u = d.vector_t_start
    m0 = float(d.total_mass(u))
    v = d.step(d.step(u, 0.0, 0.25), 0.25, 0.5)
    assert abs(float(d.total_mass(v)) - m0) < 1e-8 * abs(m0)
    vlong = d.step(u, 0.0, 1e6)
    assert float((vlong - m0 / 100.0).abs().max()) < 1e-4


def test_spectrum_matches_periodic_laplacian():
    import scipy.linalg
    M, K, _ = p_assemble(12, 10.0, 0.1, 5.0)
    lam = scipy.linalg.eigh(K, M, eigvals_only=True)
    base = 0.1 * (2 * np.pi / 10.0) ** 2
    assert abs(lam[0]) < 1e-12
    np.testing.assert_allclose(lam[1:5], base, rtol=0.03)
    np.testing.assert_allclose(lam[5], 2 * base, rtol=0.03)


def _two_level(mod, n=10, **skw):
    problem = [mod.Diffusion2D(n=n, length=10.0, kappa=0.1, t_start=0, t_stop=10, nt=nt,
                               **_cpu(mod)) for nt in (17, 9)]
    return mod.Mgrit(problem=problem, logging_lvl=30, **{"tol": 1e-9, **skw})


@pytest.mark.parametrize("n,skw", [(10, dict()), (6, dict(cycle_type="F", cf_iter=0))],
                         ids=["V-n10", "F-cf0-n6"])
def test_two_level_history_matches_jax(n, skw):
    """examples/example_diffusion_2d.py at n = 10 (and a cheaper n = 6)."""
    mj, mp = _two_level(J, n, **skw), _two_level(P, n, **skw)
    mj.solve()
    mp.solve()
    hj, hp = mj.conv[1:mj.solve_iter + 1], mp.conv[1:mp.solve_iter + 1]
    uj, up = np.asarray(mj.u[0]), mp.u[0].numpy()
    floor = (8 + 4 * np.sqrt(6 * n * n)) * EPS * float(np.linalg.norm(uj[::2]))
    np.testing.assert_allclose(hp, hj, rtol=1e-9, atol=floor)
    np.testing.assert_allclose(up, uj, rtol=0, atol=1e-10 * np.abs(uj).max())


def test_mgrit_matches_sequential():
    """tests/models/test_diffusion_2d.py::test_mgrit_matches_sequential on
    the port: the MGRIT tube's last row is the sequential march's."""
    mgrit = _two_level(P)
    info = mgrit.solve()
    assert info["conv"][-1] < 1e-9 and len(info["conv"]) <= 8
    d = mgrit.problem[0]
    u = d.vector_t_start
    for i in range(1, 17):
        u = d.step(u, d.t[i - 1], d.t[i])
    np.testing.assert_allclose(mgrit.u[0][-1].numpy(), u.numpy(), atol=1e-8)
    m0 = float(d.total_mass(mgrit.u[0][0]))
    assert abs(float(d.total_mass(mgrit.u[0][-1])) - m0) <= 1e-10 * abs(m0)
