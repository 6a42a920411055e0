"""Port parity: ``precision='dd'`` in the port's Dahlquist and through the
solvers' DD routes (the README golden, an F-cycle, AtMgrit's windows, the
coarsest-prefix refusal, a JAX checkpoint continued), against the goldens
of tests/core/test_dd_goldens.py and the JAX package's runs of the same
problems.  Tolerances as in tests/test_torch_dd_models.py: rtol 1e-5 to
JAX above the DD floor, the same iteration count, a floor iteration only
below the tolerance.  The JAX F-cycle run is committed
(``JAX_F_CYCLE``) and recomputed by the slow case at the end.
"""

import logging

import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.ops import dd as jdd
from pymgrit_tpu_torch.ops import dd

torch.set_num_threads(1)

README_GOLDEN = [7.186185937e-05, 1.2461067e-06, 2.1015566e-08, 3.1441273e-10, 3.975e-12]
JAX_RTOL = 1e-5
# the JAX package's DD history of the F-cycle below (CPU)
JAX_F_CYCLE = np.array([6.73539107083343e-05, 1.124433651966683e-06, 1.8622225539388637e-08,
                        2.7901686516784707e-10, 3.572830399589666e-12])


def _cpu(mod):
    return {"device": "cpu"} if mod is P else {}


def _split(mod, a):
    return (dd if mod is P else jdd).from_f64(np.asarray(a, dtype=np.float64))


def _agree(port, jax_hist, tol=None):
    """Same length; rtol JAX_RTOL, the last iteration only below tol when
    it is the floor iteration of a run to tol."""
    port, jax_hist = np.asarray(port), np.asarray(jax_hist)
    assert port.shape == jax_hist.shape, (port, jax_hist)
    body = slice(None, -1) if tol is not None else slice(None)
    np.testing.assert_allclose(port[body], jax_hist[body], rtol=JAX_RTOL)
    if tol is not None:
        assert port[-1] < tol and jax_hist[-1] < tol


def _dahlquist(mod, precision="dd", level=2, **kw):
    d = mod.Dahlquist(t_start=0, t_stop=5, nt=101, precision=precision, **_cpu(mod))
    return mod.simple_setup_problem(problem=d, level=level, coarsening=2)


def test_dahlquist_dd_readme_golden_and_jax():
    conv = {}
    for mod in (P, J):
        conv[mod] = np.asarray(mod.Mgrit(problem=_dahlquist(mod), tol=1e-10,
                                         logging_lvl=logging.WARNING).solve()["conv"])
    assert len(conv[P]) == 5, conv[P]
    np.testing.assert_allclose(conv[P], README_GOLDEN, rtol=2e-3)
    assert conv[P][-1] < 1e-11
    _agree(conv[P], conv[J])


def _f_cycle(mod, precision):
    return mod.Mgrit(problem=_dahlquist(mod, precision, level=3), tol=1e-10, cycle_type="F",
                     logging_lvl=logging.WARNING).solve()["conv"]


def test_dahlquist_dd_f_cycle_against_f64_and_jax():
    conv_dd, conv_64 = _f_cycle(P, "dd"), _f_cycle(P, None)
    assert len(conv_dd) == len(conv_64)
    np.testing.assert_allclose(conv_dd, conv_64, rtol=2e-3)
    _agree(conv_dd, JAX_F_CYCLE, tol=1e-10)


@pytest.mark.parametrize("method", ["BE", "FE", "TR", "MR"])
def test_dahlquist_dd_step_parity(method):
    got = {}
    for mod in (P, J):
        m = mod.Dahlquist(t_start=0, t_stop=5, nt=101, method=method, precision="dd", **_cpu(mod))
        got[mod] = m.step(_split(mod, 0.7371), _split(mod, 0.1), _split(mod, 0.15)).to_float64()
    want = float(P.Dahlquist(t_start=0, t_stop=5, nt=101, method=method, device="cpu")
                 .step(torch.tensor(0.7371, dtype=torch.float64), 0.1, 0.15))
    assert abs(float(got[P]) - want) < 1e-13
    assert abs(float(got[P]) - float(got[J])) < 1e-13


def test_dd_declines_affine_coeffs_and_prefix():
    """DD models define no affine_coeffs, so coarsest_prefix=True raises,
    as in the JAX package; AtMgrit runs its masked windows."""
    for mod in (P, J):
        problem = _dahlquist(mod)
        assert getattr(problem[-1], "affine_coeffs", None) is None
        with pytest.raises(Exception, match="affine_coeffs"):
            mod.Mgrit(problem=problem, coarsest_prefix=True, logging_lvl=40)
    heat = P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=9, ny=9, a=1.0,
                    t_start=0, t_stop=1, nt=9, precision="dd", basis="spectral", device="cpu")
    assert getattr(heat, "affine_coeffs", None) is None


def test_at_mgrit_on_a_dd_problem():
    """AtMgrit (k = 4) on the 3-level DD Dahlquist hierarchy against the JAX
    package's, and against the port's float64 run."""
    conv = {}
    for mod in (P, J):
        conv[mod] = mod.AtMgrit(k=4, problem=_dahlquist(mod, level=3), tol=1e-10, max_iter=8,
                                logging_lvl=40).solve()["conv"]
    f64 = P.AtMgrit(k=4, problem=_dahlquist(P, None, level=3), tol=1e-10, max_iter=8,
                    logging_lvl=40).solve()["conv"]
    _agree(conv[P], conv[J], tol=1e-10)
    np.testing.assert_allclose(conv[P][:-1], f64[:-1], rtol=2e-3)


def test_jax_dd_checkpoint_continues_in_the_port(tmp_path):
    """Two iterations in JAX, saved (a DD tube is two leaves, hi then lo),
    loaded into the port and continued: the rest of the history is JAX's,
    and the state is a DD pair tube; the port saves it in the same leaves."""
    mj = J.Mgrit(problem=_dahlquist(J, level=3), max_iter=2, tol=1e-300, logging_lvl=40)
    mj.solve()
    path = str(tmp_path / "dd.npz")
    mj.save_checkpoint(path)
    href = J.Mgrit(problem=_dahlquist(J, level=3), max_iter=4, tol=1e-300,
                   logging_lvl=40).solve()["conv"]
    mp = P.Mgrit(problem=_dahlquist(P, level=3), max_iter=2, tol=1e-300, nested_iteration=False,
                 logging_lvl=40)
    mp.load_checkpoint(path)
    assert tuple(mp.u[0].shape) == (101, 2) and mp.u[0].dtype == torch.float32
    hp = mp.solve()["conv"]
    np.testing.assert_allclose(hp, href[2:], rtol=JAX_RTOL)
    back = tmp_path / "port.npz"
    mp.save_checkpoint(str(back))
    with np.load(back) as data, np.load(path) as ref:
        assert sorted(data.files) == sorted(ref.files)
        assert data["leaf_0"].dtype == np.float32 and data["leaf_0"].shape == (101,)


@pytest.mark.slow   # about 25 s: the JAX package compiles the F-cycle's phases
def test_committed_jax_f_cycle():
    history = np.asarray(_f_cycle(J, "dd"))
    np.testing.assert_allclose(history, JAX_F_CYCLE, rtol=1e-12, atol=0)


def test_random_init_guess_dd_tube_and_history():
    """random_init_guess=True on a DD problem: the level-0 tube is the JAX
    package's draw (hi uniform in float32 from the same threefry keys, lo =
    0) bit for bit, and the history follows JAX's."""
    kw = dict(tol=1e-10, random_init_guess=True, rng_seed=7, nested_iteration=False,
              logging_lvl=40)
    mj = J.Mgrit(problem=_dahlquist(J, level=3), **kw)
    mp = P.Mgrit(problem=_dahlquist(P, level=3), **kw)
    np.testing.assert_array_equal(mp.u[0][:, 0].numpy(), np.asarray(mj.u[0].hi))
    np.testing.assert_array_equal(mp.u[0][:, 1].numpy(), np.asarray(mj.u[0].lo))
    _agree(mp.solve()["conv"], mj.solve()["conv"], tol=1e-10)
