"""Port parity: Heat2D in the spectral basis, and the plain versions of the
four kernels against the JAX expressions they replace.

Small size (nx = 17, so 15 x 15 coefficients; nt = 129) in float64.  Both
sides evaluate the same expressions in the same order; they differ only in
how the rhs table was transformed (an XLA matmul against a numpy matmul)
and in XLA's constant folding, so they agree to rounding: rtol 1e-12,
measured against the largest entry of the result (``_close``).

Kernel map (ROADMAP Queue B): K1 ``interval_affine`` replaces B1
(``Heat2D.relax_interval``) and B2 (``Mgrit._cnd_materialize_expr``); K2
``theta_chain`` replaces B4 (coarse F-relaxation scan of ``_step_spectral``
plus g) and the one-step forms of B5/B6; K3 ``residual_row_norms`` replaces
B7 (per-point residual norms); K4 ``cpoint_combine`` replaces the
elementwise parts of B3/B5 (FAS g_tail, correction, weighted C update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.core import vector as jv
from pymgrit_tpu_torch.ops import heat_kernels, indexed, row_norms

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


RTOL = 1e-12
NX, NT, M = 17, 129, 4
N = (NX - 2) ** 2


def _jrhs(x, y, t):
    return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.ones_like(t * x * y)


def _prhs(x, y, t):
    return np.sin(np.pi * x) * np.sin(np.pi * y) * np.ones_like(t * x * y)


def _jrhs_t(x, y, t):
    return jnp.sin(jnp.pi * x) * jnp.sin(jnp.pi * y) * jnp.cos(3.0 * t)


def _prhs_t(x, y, t):
    return np.sin(np.pi * x) * np.sin(np.pi * y) * np.cos(3.0 * t)


def _ic(x, y):
    return np.sin(np.pi * x) * np.sin(np.pi * y) + x * (1 - x) * y


def _pair(method="BE", time_dependent=False, nt=NT, bc=0.0):
    t = np.linspace(0, 1, nt)
    kw = dict(x_start=0, x_end=1, y_start=0, y_end=1, nx=NX, ny=NX, a=1.0, init_cond=_ic,
              t_interval=t, basis="spectral", method=method, bc_left=bc, bc_top=lambda x: bc * x)
    hj = J.Heat2D(rhs=_jrhs_t if time_dependent else _jrhs, **kw)
    hp = P.Heat2D(rhs=_prhs_t if time_dependent else _prhs, **kw, device="cpu")
    return hj, hp


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(p, j, rtol=RTOL):
    p, j = _np(p), _np(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * np.max(np.abs(j)))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _blocks(t, m, rows, J_):
    tp = np.stack([t[j * m:j * m + rows] for j in range(J_)], 1)
    tc = np.stack([t[j * m + 1:j * m + rows + 1] for j in range(J_)], 1)
    return tp, tc


# ---------------------------------------------------------------------------
# Heat2D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["BE", "CN"])
@pytest.mark.parametrize("bc", [0.0, 0.5])
def test_constructor_state(method, bc):
    hj, hp = _pair(method, bc=bc)
    _close(hp.vector_t_start, hj.vector_t_start)
    _close(hp._lift_hat, hj._lift_hat_np)
    _close(hp._Lam, hj._Lam_np)
    assert hp.vector_template.shape == (NX - 2, NX - 2) and hp.vector_template.dtype == torch.float64
    _close(hp.to_physical(hp.vector_t_start), hj.to_physical(jnp.asarray(hj.vector_t_start)))


@pytest.mark.parametrize("method", ["BE", "CN"])
@pytest.mark.parametrize("time_dependent", [False, True])
def test_step_spectral(method, time_dependent):
    hj, hp = _pair(method, time_dependent)
    u = _rand(NX - 2, NX - 2)
    t = hj.t
    # on the grid, and off the grid (the rhs callable is evaluated)
    for t0, t1 in ((t[3], t[4]), (t[7] + 1e-3, t[8] - 2e-3)):
        _close(hp._step_spectral(_t(u), t0, t1), hj._step_spectral(jnp.asarray(u), t0, t1))
        _close(hp.step(_t(u), t0, t1), hj.step(jnp.asarray(u), t0, t1))
    us = _rand(5, NX - 2, NX - 2, seed=1)
    ref = jax.vmap(hj.step)(jnp.asarray(us), jnp.asarray(t[2:7]), jnp.asarray(t[3:8]))
    _close(hp.step_batched(_t(us), t[2:7], t[3:8]), ref)


@pytest.mark.parametrize("method", ["BE", "CN"])
def test_interval_tables(method):
    hj, hp = _pair(method)
    dt = hj.t[1] - hj.t[0]
    for m1 in (M - 1, M):
        (Aj, Gj), (Ap, Gp) = hj._interval_tables(dt, m1), hp._interval_tables(dt, m1)
        _close(Ap, Aj)
        _close(Gp, Gj)


@pytest.mark.parametrize("method", ["BE", "CN"])
@pytest.mark.parametrize("layout", ["row-major", "interval-major", "only_last"])
def test_relax_interval(method, layout):
    hj, hp = _pair(method)
    J_ = (NT - 1) // M
    rows = M if layout == "only_last" else M - 1
    tp, tc = _blocks(hj.t, M, rows, J_)
    seeds = _rand(J_, NX - 2, NX - 2, seed=2)
    kw = {"only_last": layout == "only_last", "interval_major": layout == "interval-major"}
    yj = hj.relax_interval(jnp.asarray(seeds), tp, tc, **kw)
    yp = hp.relax_interval(_t(seeds), tp, tc, **kw)
    _close(yp, yj)


def test_relax_interval_declines_alike():
    """Time-dependent rhs, and a non-uniform dt: both hooks decline."""
    hj, hp = _pair(time_dependent=True)
    tp, tc = _blocks(hj.t, M, M - 1, 4)
    seeds = _rand(4, NX - 2, NX - 2)
    assert hj.relax_interval(jnp.asarray(seeds), tp, tc) is None
    assert hp.relax_interval(_t(seeds), tp, tc) is None
    hj, hp = _pair()
    tc = tc.copy()
    tc[0, 0] += 1e-6
    assert hj.relax_interval(jnp.asarray(seeds), tp, tc) is None
    assert hp.relax_interval(_t(seeds), tp, tc) is None


def test_spectral_fe_raises_alike():
    """FE has no spectral form in either package (the ring quirk)."""
    kw = dict(x_start=0, x_end=1, y_start=0, y_end=1, nx=NX, ny=NX, a=1.0,
              t_interval=np.linspace(0, 1, NT), basis="spectral", method="FE")
    msgs = []
    for mod, rhs in ((J, _jrhs), (P, _prhs)):
        with pytest.raises(Exception) as exc:
            mod.Heat2D(rhs=rhs, **kw, **_cpu(mod))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "spectral" in msgs[0]


# ---------------------------------------------------------------------------
# plain versions of the kernels against the JAX expressions they replace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,r0", [(M - 1, 0), (M, 0), (M, M - 1)])
def test_k1_plain_matches_relax_interval_expression(rows, r0):
    """B1: y[j, r] = A[r0 + r] * seed_j + G[r0 + r] (interval-major)."""
    A, G = _rand(rows, N, seed=3), _rand(rows, N, seed=4)
    x = _rand(7, N, seed=5)
    R = rows - r0
    ref = jnp.asarray(x)[:, None] * jnp.asarray(A)[None, r0:] + jnp.asarray(G)[None, r0:]
    out = torch.empty((7, R, N), dtype=torch.float64)
    seed_out = torch.empty((7, N), dtype=torch.float64)
    heat_kernels.interval_affine_plain(_t(x), _t(A), _t(G), out, r0, seed_out)
    _close(out, ref)
    np.testing.assert_array_equal(seed_out.numpy(), x)


def _solvers(**kw):
    built = []
    for mod, rhs in ((J, _jrhs), (P, _prhs)):
        t = np.linspace(0, 1, NT)
        problem = [mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=NX, ny=NX, a=1.0,
                              rhs=rhs, init_cond=_ic, t_interval=t[::s], basis="spectral",
                              **_cpu(mod))
                   for s in (1, M, M * M)]
        built.append(mod.Mgrit(problem=problem, logging_lvl=40, nested_iteration=False, **kw))
    return built


def test_k1_materialize_matches_cnd_materialize_expr():
    """B2: condensed C-rows -> full level-0 tube."""
    mj, mp = _solvers()
    assert mj._condensed0 and mp._condensed0
    u_c = _rand((NT - 1) // M + 1, NX - 2, NX - 2, seed=6)
    _close(mp._cnd_materialize_expr(_t(u_c)), mj._cnd_materialize_expr(jnp.asarray(u_c)))
    _close(mp._cnd_c_step(_t(u_c)), mj._cnd_c_step(jnp.asarray(u_c)))


@pytest.mark.parametrize("method", ["BE", "CN"])
@pytest.mark.parametrize("with_g", [True, False])
def test_k2_plain_matches_relaxation_scan(method, with_g):
    """B4: the coarse F-relaxation scan x <- g_k + Phi(x) over k, batched
    over J intervals (and without g: the level-0 / one-step forms)."""
    hj, hp = _pair(method)
    t, m, J_ = hj.t, 8, (NT - 1) // 8
    tp, tc = _blocks(t, m, m - 1, J_)
    x = _rand(J_, NX - 2, NX - 2, seed=7)
    g = _rand(m - 1, J_, NX - 2, NX - 2, seed=8) * 1e-2
    vstep = jax.vmap(hj.step)

    def body(carry, inp):
        a, b, gi = inp
        out = vstep(carry, a, b)
        out = jv.add(gi, out) if with_g else out
        return out, out

    _, ys = jax.lax.scan(body, jnp.asarray(x), (jnp.asarray(tp), jnp.asarray(tc), jnp.asarray(g)))
    out = torch.empty((J_, m - 1, NX - 2, NX - 2), dtype=torch.float64)
    gp = _t(np.moveaxis(g, 0, 1)) if with_g else None
    hp.step_chain(_t(x), tp, tc, out, gp)
    _close(out, jnp.moveaxis(ys, 0, 1))


def test_k3_plain_matches_point_residual_norms():
    """B7: per-C-point 2-norm of Phi(u_{c-1}) - u_c."""
    s, u = _rand(9, NX - 2, NX - 2, seed=9), _rand(9, NX - 2, NX - 2, seed=10)
    ref = jax.vmap(jv.norm)(jv.sub(jnp.asarray(s), jnp.asarray(u)))
    _close(row_norms.residual_row_norms_plain(_t(s).view(9, -1), _t(u).view(9, -1)), ref)


def test_k4_plain_matches_cpoint_phases():
    """B3/B5: FAS g_tail, uniform FAS inner term, correction, weighted C."""
    r, v, s, u, g = (jnp.asarray(_rand(6, N, seed=k)) for k in range(11, 16))
    p = {k: _t(np.asarray(a)) for k, a in dict(r=r, v=v, s=s, u=u, g=g).items()}
    plain = indexed.cpoint_combine_plain

    def run(terms, coeffs):
        return plain(torch.empty((6, N), dtype=torch.float64), [p[k] for k in terms], coeffs)

    _close(run("vsr", [1.0, -1.0, 1.0]), jv.add(r, jv.sub(v, s)))          # g_tail
    _close(run("gus", [1.0, -1.0, 1.0]), jv.add(jv.sub(g, u), s))          # inner, lvl > 0
    _close(run("su", [1.0, -1.0]), jv.sub(s, u))                           # inner, lvl 0
    _close(run("uv", [1.0, 1.0]), jv.add(u, v))                            # correction
    w = 1.3
    _close(run("su", [w, 1.0 - w]), jv.add(jv.scale(s, w), jv.scale(u, 1.0 - w)))
