"""Port parity: the slice as a whole -- Heat2D spectral, three levels
(nx = 17, nt = 129, coarsening 4/4), FCF V-cycles with nested iteration,
through ``solve()`` and ``solve_compiled()``, with the condensed level-0
carry and with the full tube.

Tolerances: histories rtol 1e-9 with atol 1e-14, because the CN tail sits
at the float64 residual floor (~2e-9 after four iterations, where 1e-16
absolute noise is ~1e-7 relative; cf. tests/core/test_condensed.py); the
level-0 tube to atol 1e-10.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


RTOL, ATOL, TUBE_ATOL = 1e-9, 1e-14, 1e-10
DECLINE = "MGRIT: condensed level-0 fast path DISABLED"


def _rhs(mod, time_dependent=False):
    xp = jnp if mod is J else np
    if time_dependent:
        return lambda x, y, t: xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * xp.cos(t)
    return lambda x, y, t: xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * xp.ones_like(t * x * y)


def _build(mod, method="BE", nt=129, ms=(4, 4), t=None, time_dependent=False):
    t = np.linspace(0, 1, nt) if t is None else t
    out, s = [], 1
    for lvl in range(len(ms) + 1):
        out.append(mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=17, ny=17, a=1.0,
                              rhs=_rhs(mod, time_dependent),
                              init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                              t_interval=t[::s], basis="spectral", method=method, **_cpu(mod)))
        if lvl < len(ms):
            s *= ms[lvl]
    return out


def _tube(mgrit):
    u = mgrit.u[0]
    return u.numpy() if isinstance(u, torch.Tensor) else np.asarray(u)


def _check(mj, cj, mp, cp):
    assert len(cp) == len(cj)
    np.testing.assert_allclose(cp, cj, rtol=RTOL, atol=ATOL)
    tj, tp = _tube(mj), _tube(mp)
    assert tp.shape == tj.shape
    np.testing.assert_allclose(tp, tj, rtol=0, atol=TUBE_ATOL)


@pytest.mark.parametrize("entry", ["solve", "solve_compiled"])
@pytest.mark.parametrize("condensed", [True, False])
@pytest.mark.parametrize("method", ["BE", "CN"])
def test_slice_matches_jax(method, condensed, entry):
    runs = []
    for mod in (J, P):
        mgrit = mod.Mgrit(problem=_build(mod, method), tol=1e-300, max_iter=4,
                          logging_lvl=40, condensed=condensed)
        assert mgrit._condensed0 == condensed
        runs += [mgrit, getattr(mgrit, entry)()["conv"]]
    _check(*runs)
    assert runs[2].u[0].shape == (129, 15, 15) and runs[2].u[0].dtype == torch.float64


class _CustomCriterionJ(J.Mgrit):
    def convergence_criterion(self, iteration):
        super().convergence_criterion(iteration)


class _CustomCriterionP(P.Mgrit):
    def convergence_criterion(self, iteration):
        super().convergence_criterion(iteration)


def _jittered():
    t = np.linspace(0, 1, 129)
    t[5] += 1e-9
    return t


@pytest.mark.parametrize("case", ["custom_criterion", "output_lvl2", "dt_jitter",
                                  "time_dependent_rhs"])
def test_decline_reason_text(case, caplog):
    messages = []
    for mod, custom in ((J, _CustomCriterionJ), (P, _CustomCriterionP)):
        cls, kw, build = mod.Mgrit, {}, {}
        if case == "custom_criterion":
            cls = custom
        elif case == "output_lvl2":
            kw = dict(output_fcn=lambda m: None, output_lvl=2)
        elif case == "dt_jitter":
            build = dict(t=_jittered())
        else:
            build = dict(time_dependent=True)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mgrit = cls(problem=_build(mod, **build), nested_iteration=False, max_iter=1,
                        logging_lvl=logging.INFO, **kw)
        assert not mgrit._condensed0
        messages.append([r.getMessage() for r in caplog.records if DECLINE in r.getMessage()])
    assert len(messages[0]) == 1 and messages[1] == messages[0]


def test_checkpoint_continuation(tmp_path, method="BE"):
    """A JAX checkpoint continues in both packages to the same history; the
    port's checkpoint reads back into the JAX package."""
    first = J.Mgrit(problem=_build(J, method), tol=1e-300, max_iter=2, logging_lvl=40)
    first.solve()
    path = str(tmp_path / "jax.npz")
    first.save_checkpoint(path)

    mj = J.Mgrit(problem=_build(J, method), tol=1e-300, max_iter=2, logging_lvl=40)
    mj.load_checkpoint(path)
    mp = P.Mgrit(problem=_build(P, method), tol=1e-300, max_iter=2, logging_lvl=40)
    mp.load_checkpoint(path)
    assert mp.solve_iter == mj.solve_iter == 2
    np.testing.assert_array_equal(mp.conv, mj.conv)
    _check(mj, mj.solve()["conv"], mp, mp.solve()["conv"])

    path_p = str(tmp_path / "port.npz")
    mp.save_checkpoint(path_p)
    mj2 = J.Mgrit(problem=_build(J, method), tol=1e-300, max_iter=1, logging_lvl=40)
    mj2.load_checkpoint(path_p)
    mp2 = P.Mgrit(problem=_build(P, method), tol=1e-300, max_iter=1, logging_lvl=40)
    mp2.load_checkpoint(path_p)
    _check(mj2, mj2.solve_compiled()["conv"], mp2, mp2.solve_compiled()["conv"])
