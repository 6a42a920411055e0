"""Port parity: 1D upwind advection (backward Euler, periodic) against
``pymgrit_tpu.Advection1D``, K17 ``circulant_solve1d``'s plain version
(the Fourier route) and the closed form of the circulant inverse that the
kernel uses.

Float64.  Tolerances: steps rtol 1e-13 against the largest entry (two FFT
implementations); the closed form against the Fourier route rtol 1e-12
(n pow calls and an n-term sum against two transforms); MGRIT histories
rtol 1e-9 with an atol at the float64 floor 8 eps ||u_C||_2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu_torch.ops import periodic

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(p, j, rtol=1e-13):
    p, j = _np(p), _np(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * np.max(np.abs(j)))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _pair(c=1.0, nx=33):
    kw = dict(c=c, x_start=-1, x_end=1, nx=nx, t_start=0, t_stop=2, nt=33)
    return J.Advection1D(**kw), P.Advection1D(**kw, **CPU)


def _column(c, n):
    """The first column of ((1 + c) I - c P)^-1 in the kernel's closed form."""
    m = np.arange(n)
    if abs(c) <= abs(1 + c):
        r = c / (1 + c)
        return r ** m / ((1 + c) * (1 - r ** n))
    q = (1 + c) / c
    return q ** (n - 1 - m) / (c * (q ** n - 1))


def test_constructor_state():
    aj, ap = _pair()
    np.testing.assert_array_equal(ap.vector_t_start.numpy(), np.asarray(aj.vector_t_start))
    assert (ap.nx, ap.dx, ap.fac) == (aj.nx, aj.dx, aj.fac)


@pytest.mark.parametrize("c", [1.0, 0.3, -0.2, -3.0])
def test_step_matches_jax(c):
    """Both signs of the speed, both branches of the closed form (|c dt/dx|
    on either side of 1/2)."""
    aj, ap = _pair(c)
    u0 = np.asarray(aj.vector_t_start) * (1 + np.linspace(0, 1, aj.nx))
    for dt in (0.0625, 0.01, 0.2):
        _close(ap.step(_t(u0), 0.0, dt), aj.step(jnp.asarray(u0), 0.0, dt))
    us = np.stack([u0, 2 * u0, u0[::-1].copy()])
    ref = jax.vmap(aj.step)(jnp.asarray(us), jnp.zeros(3), jnp.asarray([0.01, 0.1, 0.5]))
    _close(ap.step_batched(_t(us), [0.0] * 3, [0.01, 0.1, 0.5]), ref)


@pytest.mark.parametrize("c", [0.5, 2.0, 1e-3, 0.0, -0.25, -0.75, -1.0, -4.0, -0.5])
@pytest.mark.parametrize("n", [31, 32])
def test_closed_form_column_matches_the_fourier_route(c, n):
    """K17's circular convolution with the closed-form column solves the
    same system as the Fourier route, for c of either sign.  c = -1/2 with
    even n makes the matrix singular: the closed form divides by 0 there,
    and the Fourier route by the rounding error of e^(-i pi)."""
    b = np.random.default_rng(n).standard_normal(n)
    with np.errstate(divide="ignore"):
        w = _column(c, n)
    if c == -0.5 and n % 2 == 0:
        assert not np.all(np.isfinite(w))
        return
    assert np.all(np.isfinite(w))
    conv = np.array([sum(w[m] * b[(i - m) % n] for m in range(n)) for i in range(n)])
    out = torch.empty((1, 1, n), dtype=torch.float64)
    periodic.circulant_solve1d_plain(_t(b[None]), _t([[1.0]]), out, fac=c)
    fourier = out[0, 0].numpy()
    np.testing.assert_allclose(conv, fourier, rtol=1e-12, atol=1e-12 * np.abs(fourier).max())
    np.testing.assert_allclose((1 + c) * conv - c * np.roll(conv, 1), b, atol=1e-12)


@pytest.mark.parametrize("with_g", [True, False])
def test_step_chain_matches_a_scan_of_steps(with_g):
    aj, ap = _pair()
    u0 = np.asarray(aj.vector_t_start)
    us = np.stack([u0, 0.5 * u0, np.roll(u0, 5)])
    t, m, L = aj.t, 4, 3
    tp = np.stack([t[j * m:j * m + L] for j in range(3)], 1)
    tc = np.stack([t[j * m + 1:j * m + L + 1] for j in range(3)], 1)
    g = np.random.default_rng(9).standard_normal((3, L, 32)) * 1e-3
    x, ref = jnp.asarray(us), []
    for k in range(L):
        x = jax.vmap(aj.step)(x, jnp.asarray(tp[k]), jnp.asarray(tc[k]))
        if with_g:
            x = jnp.asarray(g[:, k]) + x
        ref.append(x)
    tube = torch.zeros((3 * m + 1, 32), dtype=torch.float64)
    out = tube[1:].view(3, m, 32)[:, :L]
    ap.step_chain(_t(us), tp, tc, out, _t(g) if with_g else None)
    _close(out, np.stack(ref, 1))


def test_example_history_matches_jax():
    """examples/example_advection.py: nx = 129, nt 129 / 65, FCF, no nested
    iteration."""
    runs = []
    for mod in (J, P):
        cpu = CPU if mod is P else {}
        problem = [mod.Advection1D(c=1, x_start=-1, x_end=1, nx=129, t_start=0, t_stop=2, nt=nt,
                                   **cpu) for nt in (129, 65)]
        mg = mod.Mgrit(problem=problem, cf_iter=1, nested_iteration=False, logging_lvl=40)
        runs.append((mg, mg.solve()["conv"]))
    (mj, hj), (mp, hp) = runs
    u0 = _np(mp.u[0])
    floor = 8 * np.finfo(np.float64).eps * np.linalg.norm(u0[0::2])
    assert hp.shape == hj.shape and hj[-1] < 1e-7
    np.testing.assert_allclose(hp, hj, rtol=1e-9, atol=floor)
