"""Port parity: the solver skeleton on Dahlquist (scalar state).

The same hierarchy runs through ``pymgrit_tpu.Mgrit`` and
``pymgrit_tpu_torch.Mgrit``.  Tolerances:

* port against JAX: rtol 1e-12, atol 1e-16.  Both take the same float64
  steps, but XLA folds ``u / (1 - z)`` with a constant z into a product
  with the reciprocal, which moves each step by an ulp of a state of size
  <= 1; the history tails (~4e-12) then differ by ~1e-18 absolute.
* both packages against the README golden history, which the reference
  PyMGRIT printed: rtol 1e-6 (each package sits 2-4e-7 from it).
"""

import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


RTOL, ATOL = 1e-12, 1e-16
README_GOLDEN = np.array([7.186185937031941e-05, 1.2461067076355103e-06,
                          2.1015566145245807e-08, 3.144127445017594e-10,
                          3.975214076032893e-12])


def _solve(mod, levels=2, coarsening=2, entry="solve", method="BE", **kw):
    problem = mod.simple_setup_problem(
        mod.Dahlquist(t_start=0, t_stop=5, nt=101, method=method, **_cpu(mod)), levels, coarsening)
    mgrit = mod.Mgrit(problem=problem, logging_lvl=30, **{"tol": 1e-10, **kw})
    return mgrit, getattr(mgrit, entry)()["conv"]


def _tube(mgrit):
    u = mgrit.u[0]
    return u.numpy() if isinstance(u, torch.Tensor) else np.asarray(u)


@pytest.mark.parametrize("entry", ["solve", "solve_compiled"])
def test_readme_golden_history(entry):
    (mj, cj), (mp, cp) = _solve(J, entry=entry), _solve(P, entry=entry)
    assert len(cp) == len(cj) == 5
    np.testing.assert_allclose(cp, cj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cp, README_GOLDEN, rtol=1e-6)
    np.testing.assert_allclose(cj, README_GOLDEN, rtol=1e-6)
    np.testing.assert_allclose(_tube(mp), _tube(mj), rtol=RTOL, atol=ATOL)


def test_three_level():
    (mj, cj), (mp, cp) = _solve(J, levels=3), _solve(P, levels=3)
    assert len(cp) == len(cj) == 6
    np.testing.assert_allclose(cp, cj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        cp, [1.9402e-4, 7.9766e-6, 2.9930e-7, 8.8816e-9, 1.9390e-10, 3.0370e-12], rtol=2e-3)
    np.testing.assert_allclose(_tube(mp), _tube(mj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [
    dict(method="FE"), dict(method="TR"), dict(method="MR"),
    dict(levels=3, conv_crit=1), dict(levels=3, conv_crit=2), dict(levels=3, conv_crit=3),
    dict(levels=3, weight_c=1.3), dict(levels=3, cycle_type="F"), dict(levels=3, cf_iter=2),
    dict(levels=3, nested_iteration=False), dict(levels=3, t_norm=1), dict(levels=3, t_norm=3),
    dict(levels=3, entry="solve_compiled", conv_crit=1),
    dict(levels=3, entry="solve_compiled", cycle_type="F", weight_c=0.7),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_solver_options(kw):
    (mj, cj), (mp, cp) = _solve(J, **kw), _solve(P, **kw)
    assert len(cp) == len(cj)
    # the 1-norm over time adds up the differences of all 50 C-points
    atol = ATOL * (50 if kw.get("t_norm") == 1 else 1)
    np.testing.assert_allclose(cp, cj, rtol=RTOL, atol=atol)
    np.testing.assert_allclose(_tube(mp), _tube(mj), rtol=RTOL, atol=ATOL)


def test_mixed_time_integrators():
    """MR on the fine level, BE on the coarse level."""
    convs = []
    for mod in (J, P):
        problem = [mod.Dahlquist(t_start=0, t_stop=5, nt=101, method="MR", **_cpu(mod)),
                   mod.Dahlquist(t_start=0, t_stop=5, nt=51, method="BE", **_cpu(mod))]
        convs.append(mod.Mgrit(problem=problem, logging_lvl=30).solve()["conv"])
    assert len(convs[1]) == len(convs[0]) == 4
    np.testing.assert_allclose(convs[1], convs[0], rtol=RTOL, atol=ATOL)


def test_one_level_equals_sequential():
    """A one-level solve is sequential time stepping, exactly."""
    problem = [P.Dahlquist(t_start=0, t_stop=2, nt=17, device="cpu")]
    mgrit = P.Mgrit(problem=problem, nested_iteration=False, max_iter=2, logging_lvl=30)
    mgrit.solve()
    app = problem[0]
    seq = [app.vector_t_start]
    for i in range(1, 17):
        seq.append(app.step(seq[-1], app.t[i - 1], app.t[i]))
    np.testing.assert_array_equal(mgrit.u[0].numpy(), torch.stack(seq).numpy())
    mj = J.Mgrit(problem=[J.Dahlquist(t_start=0, t_stop=2, nt=17)], nested_iteration=False,
                 max_iter=2, logging_lvl=30)
    mj.solve()
    np.testing.assert_allclose(mgrit.u[0].numpy(), np.asarray(mj.u[0]), rtol=RTOL, atol=ATOL)
