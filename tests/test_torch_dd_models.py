"""Port parity: ``precision='dd'`` (float32-pair states, ``ops/dd.py``) in
the port's Dahlquist, Heat1D, Heat2D and Diffusion2D and its solvers,
against the goldens of tests/models/test_heat_dd.py and
tests/models/test_diffusion_2d.py and against the JAX package's runs of
the same problems (Dahlquist and the solvers' DD routes:
tests/test_torch_dd_solvers.py).

Tolerances.  A DD history is a float32 norm of the float32 value of the
DD residual (as in the JAX package), so it carries about 7 digits: the
port is held to JAX at rtol 1e-5 above the DD floor, with the same
iteration count, and a floor iteration (the last of a run to a tolerance
near the floor) only to lie below the tolerance.  Steps are held to the
float64 step as the JAX tests hold them, and to JAX's DD step at 1e-13.
The JAX package contracts DD mul's multiply-adds under jit (see
tests/test_torch_dd.py) and forms products by the Ozaki scheme, the port
by K26's float64 accumulation, so the two are not equal bit for bit.

Four JAX runs take 25-100 s each on the CPU (the Ozaki products compile
per level and phase).  Their histories are committed below
(``JAX_HISTORIES``) and the port is held to them;
``test_committed_jax_histories`` (slow) recomputes them with the JAX
package: ``python -m pytest tests/test_torch_dd_models.py -m slow``
(about 3 minutes, each case in its own process).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.ops import dd as jdd
from pymgrit_tpu_torch.ops import dd

torch.set_num_threads(1)

JAX_RTOL = 1e-5

# the JAX package's DD histories of the four slow problems below (CPU)
JAX_HISTORIES = {
    "heat1d_golden": np.array([0.002676925156265497, 0.00018052739324048162]),
    "heat2d_physical": np.array([0.04672321304678917, 0.0011196680134162307,
                                 2.2918989998288453e-05, 7.213745083862935e-15]),
    "spatial_golden": np.array([0.03379533812403679, 0.002979397540912032,
                                0.00032555023790337145, 4.042946238769218e-05,
                                4.931579042022349e-06, 6.178526632538706e-07,
                                7.708781879500748e-08]),
    "diffusion": np.array([0.002920019207522273, 9.679517825134099e-05,
                           1.8317260810363223e-06, 4.851275834500367e-14]),
}


def _cpu(mod):
    return {"device": "cpu"} if mod is P else {}


def _np_rhs_1d(x, t):
    return -np.sin(np.pi * x) * (np.sin(t) - 1 * np.pi ** 2 * np.cos(t))


def _j_rhs_1d(x, t):
    return -jnp.sin(jnp.pi * x) * (jnp.sin(t) - 1 * jnp.pi ** 2 * jnp.cos(t))


def _rhs_1d(mod):
    return _np_rhs_1d if mod is P else _j_rhs_1d


def _ic_1d(x):
    return np.sin(np.pi * x)


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


# ---------------------------------------------------------------------------
# Heat1D
# ---------------------------------------------------------------------------


def _heat1d_golden(mod):
    mk = lambda nt: mod.Heat1D(x_start=0, x_end=2, nx=5, a=1, rhs=_rhs_1d(mod), init_cond=_ic_1d,
                               t_start=0, t_stop=2, nt=nt, precision="dd", **_cpu(mod))
    return mod.Mgrit(problem=[mk(65), mk(17), mk(5)], cf_iter=1, cycle_type="V", max_iter=2,
                     nested_iteration=True, logging_lvl=30).solve()["conv"]


def test_heat1d_dd_three_level_golden():
    conv = _heat1d_golden(P)
    np.testing.assert_allclose(conv, [0.00267692, 0.00018053], rtol=1e-3)
    _agree(conv, JAX_HISTORIES["heat1d_golden"])


@pytest.mark.parametrize("basis", ["physical", "spectral"])
def test_heat1d_dd_step_parity(basis):
    kw = dict(x_start=0, x_end=2, nx=33, a=1, rhs=lambda x, t: 0 * x, init_cond=_ic_1d,
              t_start=0, t_stop=2, nt=17, basis=basis)
    m64 = P.Heat1D(**kw, device="cpu")
    u0 = m64.vector_t_start.numpy()
    got = {}
    for mod in (P, J):
        mdd = mod.Heat1D(precision="dd", **kw, **_cpu(mod))
        got[mod] = mdd.step(_split(mod, u0), _split(mod, 0.0), _split(mod, 0.125)).to_float64()
    want = m64.step(torch.as_tensor(u0), 0.0, 0.125).numpy()
    assert np.max(np.abs(got[P] - want)) < 1e-12
    assert np.max(np.abs(got[P] - got[J])) < 1e-13


# ---------------------------------------------------------------------------
# Heat2D
# ---------------------------------------------------------------------------

HEAT2D_KW = dict(x_start=0, x_end=1, y_start=3, y_end=5, nx=17, ny=21, a=3.5,
                 init_cond=lambda x, y: np.sin(np.pi * x) * np.cos(y),
                 bc_left=1.0, bc_right=lambda y: 0 * y + 2.0, bc_bottom=0.5,
                 bc_top=0.0, t_start=0, t_stop=1, nt=9)


@pytest.mark.parametrize("method,tol", [("BE", 1e-12), ("CN", 1e-12), ("FE", 5e-11)])
def test_heat2d_dd_step_parity(method, tol):
    """Exactly representable data: the DD step within tol of float64 (FE
    amplifies by the stencil scale), and of JAX's DD step (held at 1e-13
    of the state; FE at tol)."""
    m64 = P.Heat2D(method=method, **HEAT2D_KW, device="cpu")
    u0 = m64.vector_t_start.numpy()
    got = {}
    for mod in (P, J):
        mdd = mod.Heat2D(method=method, precision="dd", **HEAT2D_KW, **_cpu(mod))
        got[mod] = mdd.step(_split(mod, u0), _split(mod, 0.125), _split(mod, 0.25)).to_float64()
    want = m64.step(torch.as_tensor(u0), 0.125, 0.25).numpy()
    assert got[P].shape == want.shape
    assert np.max(np.abs(got[P] - want)) < tol
    assert np.max(np.abs(got[P] - got[J])) < (tol if method == "FE" else 1e-13)


def _heat2d_hierarchy(mod, precision, basis="physical"):
    def rhs(x, y, t):
        lib = np if mod is P else jnp
        return lib.sin(lib.pi * x) * lib.sin(lib.pi * y) * lib.ones_like(t * x * y)

    def mk(nt):
        return mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=21, ny=17, a=1.0, rhs=rhs,
                          init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                          t_start=0, t_stop=1, nt=nt, precision=precision, basis=basis,
                          **_cpu(mod))

    return mod.Mgrit(problem=[mk(33), mk(9), mk(3)], tol=1e-12, max_iter=12,
                     nested_iteration=False, logging_lvl=30)


@pytest.mark.parametrize("basis", ["physical", "spectral"])
def test_heat2d_dd_history_against_f64_and_jax(basis):
    """The 3-level hierarchy of test_heat_dd.py: the DD history walks the
    float64 one to tol 1e-12 and stops at the same iteration; and JAX's
    (spectral: run here; physical: the committed history).  The spectral
    run takes the condensed level-0 carry through K23 and K24; its
    materialized level-0 tube, as float64, lies within 1e-12 max|u| of
    JAX's (the float32 rhs table keeps both ~1e-9 from the float64 tube)."""
    mg = _heat2d_hierarchy(P, "dd", basis)
    h_dd = mg.solve()["conv"]
    assert mg._condensed0 == (basis == "spectral")
    h_64 = _heat2d_hierarchy(P, None, basis).solve()["conv"]
    assert len(h_dd) == len(h_64)
    np.testing.assert_allclose(h_dd[:-1], h_64[:-1], rtol=1e-6)
    assert h_dd[-1] < 1e-12
    if basis == "physical":
        _agree(h_dd, JAX_HISTORIES["heat2d_physical"], tol=1e-12)
        return
    mj = _heat2d_hierarchy(J, "dd", basis)
    _agree(h_dd, mj.solve()["conv"], tol=1e-12)
    u_port = mg.u[0][:, 0].double().numpy() + mg.u[0][:, 1].double().numpy()
    u_jax = mj.u[0].to_float64()
    assert u_port.shape == u_jax.shape
    assert np.max(np.abs(u_port - u_jax)) < 1e-12 * np.max(np.abs(u_jax))


def _spatial_golden(mod):
    mk = lambda nx, t_interval=None, nt=None: mod.Heat1D(
        x_start=0, x_end=2, nx=nx, a=1, rhs=_rhs_1d(mod), init_cond=_ic_1d, precision="dd",
        **(dict(t_interval=t_interval) if t_interval is not None
           else dict(t_start=0, t_stop=2, nt=nt)), **_cpu(mod))
    heat0 = mk(2 ** 4 + 1, nt=2 ** 7 + 1)
    heat1 = mk(2 ** 3 + 1, t_interval=heat0.t[::2])
    heat2 = mk(2 ** 2 + 1, t_interval=heat1.t[::2])
    heat3 = mk(2 ** 2 + 1, t_interval=heat2.t[::2])
    transfer = [mod.GridTransferHeat(), mod.GridTransferHeat(), mod.GridTransferCopy()]
    return mod.Mgrit(problem=[heat0, heat1, heat2, heat3], transfer=transfer,
                     logging_lvl=30).solve()["conv"]


def test_spatial_coarsening_dd_golden():
    """The reference's 4-level spatial-coarsening example in DD: the 1D
    full-weighting transfer takes DD states (K25 combines)."""
    conv = _spatial_golden(P)
    expected = np.array([3.3795e-2, 2.9794e-3, 3.2555e-4, 4.0429e-5, 4.9316e-6, 6.1785e-7,
                         7.7088e-8])
    assert len(conv) == 7
    np.testing.assert_allclose(conv, expected, rtol=2e-3)
    _agree(conv, JAX_HISTORIES["spatial_golden"])


def test_heat_transfers_on_dd_states():
    """GridTransferHeat on DD states against its float64 transfer of the
    same values and JAX's DD transfer (the same DD operations in the same
    order); GridTransferHeat2D refuses DD states, as JAX's does."""
    rng = np.random.default_rng(4)
    u = rng.standard_normal((3, 17))
    tp, tj = P.GridTransferHeat(), J.GridTransferHeat()
    for name in ("restriction", "interpolation"):
        x = u if name == "restriction" else u[..., ::2]
        got = getattr(tp, name)(dd.from_f64(x))
        want = getattr(tp, name)(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got.to_float64(), want, rtol=0, atol=1e-14)
        jgot = np.stack([getattr(tj, name)(jdd.from_f64(row)).to_float64() for row in x])
        np.testing.assert_array_equal(got.to_float64(), jgot)
    with pytest.raises(TypeError, match="double-double"):
        P.GridTransferHeat2D(9, 11).restriction(dd.from_f64(np.zeros((9, 11))))


# ---------------------------------------------------------------------------
# Diffusion2D
# ---------------------------------------------------------------------------


def _diffusion(precision):
    problem = [P.Diffusion2D(n=8, length=10.0, kappa=0.1, t_start=0, t_stop=10, nt=nt,
                             precision=precision, device="cpu") for nt in (17, 9)]
    return P.Mgrit(problem=problem, tol=1e-11, max_iter=10, logging_lvl=30).solve()["conv"]


def test_diffusion_dd_against_f64_and_jax():
    """test_diffusion_2d.py's DD case: the DD history matches float64 to
    tol 1e-11, and the JAX package's DD history."""
    base, conv = _diffusion(None), _diffusion("dd")
    assert len(conv) == len(base)
    np.testing.assert_allclose(conv[:-1], base[:-1], rtol=1e-4)
    assert conv[-1] < 1e-11
    _agree(conv, JAX_HISTORIES["diffusion"], tol=1e-11)


# ---------------------------------------------------------------------------
# the committed JAX histories
# ---------------------------------------------------------------------------


def _jax_runs():
    def diffusion():
        problem = [J.Diffusion2D(n=8, length=10.0, kappa=0.1, t_start=0, t_stop=10, nt=nt,
                                 precision="dd") for nt in (17, 9)]
        return J.Mgrit(problem=problem, tol=1e-11, max_iter=10, logging_lvl=30).solve()["conv"]

    return {"heat1d_golden": lambda: _heat1d_golden(J),
            "heat2d_physical": lambda: _heat2d_hierarchy(J, "dd").solve()["conv"],
            "spatial_golden": lambda: _spatial_golden(J),
            "diffusion": diffusion}


@pytest.mark.slow   # 25-100 s a case: the JAX package's Ozaki products compile per phase
@pytest.mark.parametrize("name", list(JAX_HISTORIES))
def test_committed_jax_histories(name):
    history = np.asarray(_jax_runs()[name]())
    print(name, repr(history.tolist()))
    np.testing.assert_allclose(history, JAX_HISTORIES[name], rtol=1e-12, atol=0)
