"""Port parity: the Runge-Kutta integrators and the ODE models (Arenstorf
orbit with adaptive DOPRI5(4), Brusselator with RK4) against
``pymgrit_tpu``, with the plain versions of K12 ``dopri45_arenstorf`` and
K13 ``rk4_brusselator``.

Inputs from a numpy seed, float64.  Tolerances:

* RK4 steps and short adaptive steps: rtol 1e-12 against the largest entry
  (the same expressions; XLA's and PyTorch's pow and reduction order differ
  by an ulp, and the controller's decisions coincide);
* adaptive integrations over up to 3 time units: rtol 1e-10.  Dozens of
  accepted steps through a close approach to the moon amplify those ulps
  (measured 4e-12);
* Brusselator histories: rtol 1e-10 with an atol at the floor of a chain of
  m RK4 steps, 8 m eps ||u_C||_2 (the tails of both packages end there);
  against the reference golden at its own rtol 5e-3;
* Arenstorf histories: the orbit is chaotic, so sub-ulp differences grow
  along it (tests/models/test_arenstorf_parity.py).  Iteration 1 at rtol
  1e-8, the whole history at rtol 1e-5, the tube at 1e-9 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.ops import runge_kutta as jrk
from pymgrit_tpu_torch.ops import runge_kutta as prk

torch.set_num_threads(1)

RTOL = 1e-12
T_ORBIT = 17.06521656015796
GOLDEN_BRUSSELATOR = np.array([0.0142, 8.20e-5, 1.13e-7, 3.36e-10])
GOLDEN_CRITERION_ITER1 = 14439.989448185017


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(p, j, rtol=RTOL):
    p, j = _np(p), _np(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * np.max(np.abs(j)))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _orbit_states(n, seed):
    """n states on the Arenstorf orbit (from a JAX reference march),
    slightly perturbed, with their times."""
    aj = J.ArenstorfOrbit(t_start=0, t_stop=T_ORBIT, nt=n + 1)
    ys = [np.asarray(aj.vector_t_start)]
    for k in range(n - 1):
        ys.append(np.asarray(aj.step(jnp.asarray(ys[-1]), aj.t[k], aj.t[k + 1])))
    rng = np.random.default_rng(seed)
    return np.stack(ys) * (1 + 1e-3 * rng.standard_normal((n, 4))), aj.t[:n]


def test_rk4_step_matches_jax():
    bj = J.Brusselator(t_start=0, t_stop=1, nt=2)
    rng = np.random.default_rng(0)
    y = rng.uniform(0, 3, (7, 2))
    t0 = rng.uniform(0, 5, 7)
    t1 = t0 + rng.uniform(0.01, 0.5, 7)
    ref = jax.vmap(lambda a, b, c: jrk.rk4_step(bj._f, a, b, c))(
        jnp.asarray(y), jnp.asarray(t0), jnp.asarray(t1))
    f = prk.brusselator_f(1.0, 3.0)
    _close(prk.rk4_step(f, _t(y), _t(t0), _t(t1)), ref)


def test_dopri45_integrate_matches_jax_with_rejections():
    """Random lanes on the orbit over intervals of 0.05 to 3 time units:
    long intervals through the close approach make the controller reject
    attempts; every lane ends as JAX's vmap-ed while_loop ends it."""
    y, t0 = _orbit_states(12, 1)
    t1 = t0 + np.random.default_rng(2).uniform(0.05, 3.0, t0.shape)
    aj = J.ArenstorfOrbit(t_start=0, t_stop=1, nt=2)
    ref = jax.vmap(lambda a, b, c: jrk.dopri45_integrate(aj._f, a, b, c))(
        jnp.asarray(y), jnp.asarray(t0), jnp.asarray(t1))
    got, attempts, rejections = prk.dopri45_integrate(prk.arenstorf_f(), _t(y), _t(t0), _t(t1))
    _close(got, ref, rtol=1e-10)
    assert int(rejections.max()) > 0 and int(rejections.min()) == 0
    assert bool((attempts > rejections).all())


def test_dopri45_max_steps_caps_attempts():
    y, t0 = _orbit_states(3, 3)
    _, attempts, _ = prk.dopri45_integrate(prk.arenstorf_f(), _t(y), _t(t0), _t(t0 + 5.0),
                                           max_steps=4)
    assert attempts.tolist() == [4, 4, 4]


@pytest.mark.parametrize("model", ["ArenstorfOrbit", "Brusselator"])
@pytest.mark.parametrize("with_g", [True, False])
def test_step_chain_matches_a_scan_of_steps(model, with_g):
    """J chains of L steps plus g into strided views of a tube, and the
    single and batched steps, against vmap-ed JAX steps."""
    t = np.linspace(0, 2.0, 41)
    mj, mp = getattr(J, model)(t_interval=t), getattr(P, model)(t_interval=t, device="cpu")
    d = mp.vector_template.shape[0]
    rng = np.random.default_rng(4)
    x0 = np.asarray(mj.vector_t_start) * (1 + 1e-6 * rng.standard_normal((3, d)))
    m, L = 8, 7
    tp = np.stack([t[j * m:j * m + L] for j in range(3)], 1)
    tc = np.stack([t[j * m + 1:j * m + L + 1] for j in range(3)], 1)
    g = rng.standard_normal((3, L, d)) * 1e-3
    vstep = jax.jit(jax.vmap(mj.step))
    x, ref = jnp.asarray(x0), []
    for k in range(L):
        x = vstep(x, jnp.asarray(tp[k]), jnp.asarray(tc[k]))
        if with_g:
            x = jnp.asarray(g[:, k]) + x
        ref.append(x)
    tube = torch.zeros((3 * m + 1, d), dtype=torch.float64)
    out = tube[1:].view(3, m, d)[:, :L]
    mp.step_chain(_t(x0), tp, tc, out, _t(g) if with_g else None)
    _close(out, np.stack(ref, 1))
    _close(mp.step(_t(x0[0]), t[2], t[3]), mj.step(jnp.asarray(x0[0]), t[2], t[3]))
    _close(mp.step_batched(_t(x0), t[[0, 5, 9]], t[[1, 7, 10]]),
           vstep(jnp.asarray(x0), jnp.asarray(t[[0, 5, 9]]), jnp.asarray(t[[1, 7, 10]])))


def test_arenstorf_counts_attempts():
    a = P.ArenstorfOrbit(t_start=0, t_stop=T_ORBIT, nt=11, device="cpu")
    out = torch.empty((1, 10, 4), dtype=torch.float64)
    a.step_chain(a.vector_t_start[None], a.t[:-1, None], a.t[1:, None], out)
    assert a.steps == 10 and int(a.attempts) >= 10 and int(a.attempts_max) >= 1


def _solve(mod, model, nt, m, **kw):
    cpu = {"device": "cpu"} if mod is P else {}
    p0 = getattr(mod, model)(t_start=0, t_stop=T_ORBIT if model == "ArenstorfOrbit" else 12,
                             nt=nt, **cpu)
    mg = mod.Mgrit(problem=[p0, getattr(mod, model)(t_interval=p0.t[::m], **cpu)], logging_lvl=40,
                   **kw)
    return mg, mg.solve()["conv"]


def test_brusselator_history_matches_jax_and_the_golden():
    (mj, hj), (mp, hp) = (_solve(mod, "Brusselator", 641, 20, tol=1e-10) for mod in (J, P))
    u_c = mp.u[0][::20].numpy()
    floor = 8 * 20 * np.finfo(np.float64).eps * np.linalg.norm(u_c)
    assert hp.size == hj.size == 5
    np.testing.assert_allclose(hp, hj, rtol=1e-10, atol=floor)
    np.testing.assert_allclose(hp[:4], GOLDEN_BRUSSELATOR, rtol=5e-3)
    np.testing.assert_allclose(mp.u[0].numpy(), np.asarray(mj.u[0]), rtol=0, atol=1e-12)


def test_arenstorf_history_matches_jax():
    (mj, hj), (mp, hp) = (_solve(mod, "ArenstorfOrbit", 1001, 20, tol=1e-7) for mod in (J, P))
    assert hp.size == hj.size == 3 and hp[-1] < 1e-7
    np.testing.assert_allclose(hp[0], hj[0], rtol=1e-8)
    np.testing.assert_allclose(hp, hj, rtol=1e-5)
    np.testing.assert_allclose(mp.u[0].numpy(), np.asarray(mj.u[0]), rtol=0, atol=1e-9)


class _RelativeChange(P.Mgrit):
    """The user-defined criterion of examples/example_convergence_criterion.py
    on the port: 100 max |du/u| over the C-points between iterations."""

    def __init__(self, *args, **kwargs):
        self.last_it = None
        super().__init__(*args, **kwargs)
        self.convergence_criterion(iteration=0)

    def convergence_criterion(self, iteration):
        new = self.u[0][self.levels[0].cpts].cpu().numpy()
        last = np.zeros_like(new) if self.last_it is None else self.last_it
        self.conv[iteration] = 100 * np.max(np.abs(np.abs(np.divide(
            new - last, new, out=np.zeros_like(new), where=new != 0))))
        self.last_it = np.copy(new)


def test_custom_convergence_criterion_on_arenstorf():
    """The port's solve() with an overridden convergence_criterion, at the
    reference's configuration (nt = 10001, m = 100, tol 1 %): the first
    iteration matches the reference golden, the count (3) too; later
    iterations are the chaos-amplified observables that
    tests/models/test_arenstorf_parity.py bounds by order of magnitude."""
    a0 = P.ArenstorfOrbit(t_start=0, t_stop=T_ORBIT, nt=10001, device="cpu")
    mg = _RelativeChange(problem=[a0, P.ArenstorfOrbit(t_interval=a0.t[::100], device="cpu")],
                         tol=1, logging_lvl=40)
    assert not mg._condensed0
    conv = mg.solve()["conv"]
    assert len(conv) == 4, conv
    np.testing.assert_allclose(conv[1], GOLDEN_CRITERION_ITER1, rtol=1e-8)
    assert 1.0 < conv[2] < 15.0 and 0.01 < conv[3] < 0.3, conv
