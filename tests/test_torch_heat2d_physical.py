"""Port parity: Heat2D in the physical basis (the default), the plain versions
of K5 ``sine_solve2d``, K6 ``sine_affine2d`` and K7 ``theta_rhs2d`` against
the JAX expressions they replace, and the physical slice as a whole.

Small size (nx = 17, so 15 x 15 interiors; nt = 129; coarsening 4/4) in
float64; FE on nx = 9, t in [0, 1/16], nt = 65, coarsening 2/2, a grid on
which FE is stable on every level (coarsest dt = 1/256 = dx^2/(4a)).

Tolerances, with their reasons:
* step-level functions and plain kernels: rtol 1e-12 against the largest
  entry (``_close``).  Both sides evaluate the same expressions; the port
  tabulates the rhs with numpy where JAX evaluates it with XLA, adds the
  bc lift as one table where JAX adds it edge by edge, and its products
  sum in another order than XLA's, so they agree to rounding.
* histories rtol 1e-9 with atol 1e-14 (the CN tail sits at the float64
  residual floor, as in ``tests/test_torch_slice.py``); level-0 tubes atol
  1e-10.

Kernel map (ROADMAP Queue B, item B8): K5 replaces
``Heat2D._solve_interior_batched`` and the solve/ring part of
``step_batched`` (and serves the seed transform and ``to_physical``); K6 the
back transform of the physical ``relax_interval``; K7 the right-hand-side
assembly of ``step`` / ``step_batched`` (the whole step for FE).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.core import vector as jv
from pymgrit_tpu.ops import dirichlet_spectral as jds
from pymgrit_tpu_torch.interop import state_from_numpy
from pymgrit_tpu_torch.ops import dirichlet_spectral as pds
from pymgrit_tpu_torch.ops import heat_kernels, triton_kernels

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


RTOL = 1e-12
H_RTOL, H_ATOL, TUBE_ATOL = 1e-9, 1e-14, 1e-10
NX, NT, M = 17, 129, 4
N = (NX - 2) ** 2
METHODS = ["BE", "CN", "FE"]
DECLINE = "MGRIT: condensed level-0 fast path DISABLED"


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


def _pair(method="BE", time_dependent=False, nt=NT, bc=0.5):
    t = np.linspace(0, 1, nt)
    kw = dict(x_start=0, x_end=1, y_start=0, y_end=1, nx=NX, ny=NX, a=1.0, init_cond=_ic,
              t_interval=t, method=method, bc_left=bc, bc_bottom=-bc,
              bc_top=lambda x: bc * x)
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


def _ringed(hj, states):
    """states with the Dirichlet ring of hj (the solver's tubes carry it)."""
    return np.stack([np.asarray(hj._set_bc(jnp.asarray(s))) for s in states])


# ---------------------------------------------------------------------------
# Heat2D, physical basis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_default_heat2d_constructs(method):
    """basis='physical' is the default, for FE, BE and CN alike."""
    hp = P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=NX, ny=NX, a=1.0, nt=NT,
                  t_start=0, t_stop=1, method=method, device="cpu")
    assert not hp._spectral and hp.theta == {"BE": 1.0, "CN": 0.5, "FE": 0.0}[method]
    assert hp.vector_template.shape == (NX, NX) and hp.vector_template.dtype == torch.float64
    assert hp.vector_t_start.shape == (NX, NX)


@pytest.mark.parametrize("method", METHODS)
def test_constructor_state(method):
    hj, hp = _pair(method)
    _close(hp.vector_t_start, hj.vector_t_start)
    _close(hp._lift, hj._lift_np)
    _close(hp._lift_hat, hj._lift_hat_np)
    _close(hp._ring, np.asarray(hj._set_bc(jnp.zeros((NX, NX)))))
    assert hp._rhs_tbl.shape == (1, NX - 2, NX - 2)
    if method != "FE":          # the JAX package tabulates no rhs for FE
        _close(hp._rhs_tbl[0], hj._rhs_tbl0_np)
        _close(hp._rhs_tbl0_hat_np, hj._rhs_tbl0_hat_np)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("time_dependent", [False, True])
def test_step(method, time_dependent):
    hj, hp = _pair(method, time_dependent)
    u = _rand(NX, NX)           # a ring that is not the bc data
    t = hj.t
    # on the grid, and off the grid (the rhs callable is evaluated)
    for t0, t1 in ((t[3], t[4]), (t[7] + 1e-3, t[8] - 2e-3)):
        _close(hp.step(_t(u), t0, t1), hj.step(jnp.asarray(u), t0, t1))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("time_dependent", [False, True])
def test_step_batched(method, time_dependent):
    hj, hp = _pair(method, time_dependent)
    us, t = _rand(5, NX, NX, seed=1), hj.t
    ref = hj.step_batched(jnp.asarray(us), jnp.asarray(t[2:7]), jnp.asarray(t[3:8]))
    _close(hp.step_batched(_t(us), t[2:7], t[3:8]), ref)
    # non-uniform steps take the (J,) device step-size path
    t0 = t[2:7] + np.linspace(0, 2e-3, 5)
    ref = hj.step_batched(jnp.asarray(us), jnp.asarray(t0), jnp.asarray(t[3:8]))
    _close(hp.step_batched(_t(us), t0, t[3:8]), ref)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("with_g", [True, False])
def test_step_chain(method, with_g):
    """B4's physical counterpart: x <- [g_k +] step_batched(x) over k,
    batched over J intervals, as the JAX solver's scan runs it."""
    hj, hp = _pair(method)
    t, m, J_ = hj.t, 8, (NT - 1) // 8
    tp, tc = _blocks(t, m, m - 1, J_)
    x = _ringed(hj, _rand(J_, NX, NX, seed=7))
    g = _rand(m - 1, J_, NX, NX, seed=8) * 1e-2

    def body(carry, inp):
        a, b, gi = inp
        out = hj.step_batched(carry, a, b)
        out = jv.add(gi, out) if with_g else out
        return out, out

    _, ys = jax.lax.scan(body, jnp.asarray(x), (jnp.asarray(tp), jnp.asarray(tc), jnp.asarray(g)))
    tube = torch.zeros((J_, m, NX, NX), dtype=torch.float64)
    gp = _t(np.moveaxis(g, 0, 1)) if with_g else None
    hp.step_chain(_t(x), tp, tc, tube[:, 1:], gp)
    _close(tube[:, 1:], jnp.moveaxis(ys, 0, 1))


@pytest.mark.parametrize("method", ["BE", "CN"])
@pytest.mark.parametrize("layout", ["row-major", "interval-major", "only_last"])
def test_relax_interval(method, layout):
    hj, hp = _pair(method)
    J_ = (NT - 1) // M
    rows = M if layout == "only_last" else M - 1
    tp, tc = _blocks(hj.t, M, rows, J_)
    seeds = _ringed(hj, _rand(J_, NX, NX, seed=2))
    kw = {"only_last": layout == "only_last", "interval_major": layout == "interval-major"}
    yj = hj.relax_interval(jnp.asarray(seeds), tp, tc, **kw)
    yp = hp.relax_interval(_t(seeds), tp, tc, **kw)
    _close(yp, yj)


@pytest.mark.parametrize("method", ["BE", "CN"])
def test_relax_interval_out_and_seed_out(method):
    """out= / seed_out= write straight into a tube's block view."""
    hj, hp = _pair(method)
    J_ = (NT - 1) // M
    tp, tc = _blocks(hj.t, M, M - 1, J_)
    seeds = _ringed(hj, _rand(J_, NX, NX, seed=3))
    tube = torch.zeros((J_ * M + 1, NX, NX), dtype=torch.float64)
    blocks = tube[:J_ * M].view(J_, M, NX, NX)
    f_rows = blocks[:, 1:]
    assert hp.relax_interval(_t(seeds), tp, tc, out=f_rows, seed_out=blocks[:, 0]) is f_rows
    _close(blocks[:, 1:], hj.relax_interval(jnp.asarray(seeds), tp, tc, interval_major=True))
    np.testing.assert_array_equal(blocks[:, 0].numpy(), seeds)
    assert not tube[-1].any()


def test_relax_interval_cn_ring_correction():
    """CN with seeds whose carried ring is NOT the bc data (as during FAS):
    the closed form must match m-1 sequential steps, in both packages."""
    hj, hp = _pair("CN")
    J_ = 8
    tp, tc = _blocks(hj.t, M, M - 1, J_)
    seeds = _rand(J_, NX, NX, seed=4)
    yp = hp.relax_interval(_t(seeds), tp, tc)
    _close(yp, hj.relax_interval(jnp.asarray(seeds), tp, tc))
    x, steps = _t(seeds), []
    for k in range(M - 1):
        x = hp.step_batched(x, tp[k], tc[k])
        steps.append(x)
    _close(yp, torch.stack(steps), rtol=1e-11)


@pytest.mark.parametrize("case", ["FE", "time_dependent", "dt_jitter"])
def test_relax_interval_declines_alike(case):
    hj, hp = _pair("FE" if case == "FE" else "BE", time_dependent=case == "time_dependent")
    tp, tc = _blocks(hj.t, M, M - 1, 4)
    if case == "dt_jitter":
        tc = tc.copy()
        tc[0, 0] += 1e-6
    seeds = _ringed(hj, _rand(4, NX, NX))
    assert hj.relax_interval(jnp.asarray(seeds), tp, tc) is None
    assert hp.relax_interval(_t(seeds), tp, tc) is None


def test_to_physical_matches():
    hj, hp = _pair("BE")
    u_hat = _rand(3, NX - 2, NX - 2, seed=5)
    _close(hp.to_physical(_t(u_hat)), hj.to_physical(jnp.asarray(u_hat)))
    _close(hp.to_physical(_t(u_hat[0])), hj.to_physical(jnp.asarray(u_hat[0])))


def test_solve_shifted_2d_matches():
    Sx, lamx = pds.sine_eigenbasis(NX - 2, 3.0)
    Sy, lamy = pds.sine_eigenbasis(NX, 2.0)
    b = _rand(NX - 2, NX, seed=6)
    ref = jds.solve_shifted_2d(jnp.asarray(Sx), jnp.asarray(lamx), jnp.asarray(Sy),
                               jnp.asarray(lamy), 0.3, jnp.asarray(b))
    _close(pds.solve_shifted_2d(_t(Sx), _t(lamx), _t(Sy), _t(lamy), 0.3, _t(b)), ref)


# ---------------------------------------------------------------------------
# plain versions of K5, K6, K7 against the JAX expressions they replace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift_kind", ["float", "tensor"])
def test_k5_plain_matches_solve_interior_batched(shift_kind):
    """B8: x = Sx ((Sx b Sy) / (1 + shift*Lam)) Sy, written with the ring and
    plus g (step_batched's `.at[].set` chain)."""
    hj, hp = _pair("BE")
    b = _rand(6, NX - 2, NX - 2, seed=9)
    shifts = np.linspace(1e-3, 4e-3, 6)
    ref = hj._solve_interior_batched(jnp.asarray(shifts)[:, None, None], jnp.asarray(b))
    shift = _t(shifts)
    if shift_kind == "float":           # one shift for every state
        ref = hj._solve_interior_batched(2e-3, jnp.asarray(b))
        shift = 2e-3
    g = _rand(6, NX, NX, seed=10)
    out = torch.empty((6, NX, NX), dtype=torch.float64)
    heat_kernels.sine_solve2d_plain(_t(b), out, hp._Sx, hp._Sy, hp._Lam, shift, hp._ring, _t(g))
    full = jax.vmap(lambda x: hj._set_bc(jnp.zeros((NX, NX)).at[1:-1, 1:-1].set(x)))(ref)
    _close(out, jnp.asarray(g) + full)


def test_k5_plain_transform_matches():
    """Transform mode: Sx b Sy, the seeds' forward transform in the physical
    relax_interval (and to_physical with the ring)."""
    hj, hp = _pair("BE")
    b = _rand(4, NX, NX, seed=11)
    out = torch.empty((4, NX - 2, NX - 2), dtype=torch.float64)
    heat_kernels.sine_solve2d_plain(_t(b)[:, 1:-1, 1:-1], out, hp._Sx, hp._Sy)
    Sx, Sy = jnp.asarray(hj._Sx_np), jnp.asarray(hj._Sy_np)
    _close(out, hj._rx(hj._lx(Sx, jnp.asarray(b)[:, 1:-1, 1:-1]), Sy))


@pytest.mark.parametrize("cn", [False, True])
@pytest.mark.parametrize("r0,R", [(0, M - 1), (M - 1, 1)])
def test_k6_plain_matches_relax_interval_back_transform(cn, r0, R):
    """B8: y[j, r] = Sx (xhat_j A_r + G_r [+ delta_j A_{r-1}]) Sy with ring,
    the `back` expression of the physical relax_interval."""
    hj, hp = _pair("CN" if cn else "BE")
    T = M
    A, G = np.abs(_rand(T, N, seed=12)), _rand(T, N, seed=13)
    xhat, dhat = _rand(5, N, seed=14), _rand(5, N, seed=15)
    dscale = np.abs(_rand(N, seed=16)) * 1e-3
    seeds = _rand(5, NX, NX, seed=17)
    Sx, Sy = jnp.asarray(hj._Sx_np), jnp.asarray(hj._Sy_np)
    yhat = jnp.asarray(xhat)[:, None] * jnp.asarray(A)[None, r0:r0 + R] \
        + jnp.asarray(G)[None, r0:r0 + R]
    if cn:
        A_km1 = jnp.concatenate([jnp.ones_like(jnp.asarray(A)[:1]), jnp.asarray(A)[:-1]])
        yhat = yhat + (jnp.asarray(dhat) * jnp.asarray(dscale))[:, None] * A_km1[None, r0:r0 + R]
    y = hj._rx(hj._lx(Sx, yhat.reshape(5, R, NX - 2, NX - 2)), Sy)
    ref = jax.vmap(jax.vmap(lambda x: hj._set_bc(jnp.zeros((NX, NX)).at[1:-1, 1:-1].set(x))))(y)
    out = torch.empty((5, R, NX, NX), dtype=torch.float64)
    seed_out = torch.empty((5, NX, NX), dtype=torch.float64)
    heat_kernels.sine_affine2d_plain(_t(xhat), _t(A), _t(G), out, hp._Sx, hp._Sy, r0, hp._ring,
                                     _t(dhat) if cn else None, _t(dscale) if cn else None,
                                     _t(seeds), seed_out)
    _close(out, ref)
    np.testing.assert_array_equal(seed_out.numpy(), seeds)


@pytest.mark.parametrize("method", METHODS)
def test_k7_plain_matches_step_rhs(method):
    """B8: the right-hand side step_batched assembles (BE: u + dt rhs1 + lift;
    CN: u - theta dt L u + dt (mix) + lift, L reading the carried ring), and
    FE's whole step with its ring quirk, plus g."""
    hj, hp = _pair(method)
    u = _rand(6, NX, NX, seed=18)
    dt, theta = 1.0 / 64, hj.theta
    r1, r0 = _rand(6, N, seed=19), _rand(6, N, seed=20)
    if method == "FE":
        g = _rand(6, NX, NX, seed=21)
        ref = jnp.asarray(g) + jax.vmap(
            lambda x, r: (hj._set_bc(jnp.zeros((NX, NX))) + x - dt * hj._apply_L(x))
            .at[1:-1, 1:-1].add(dt * r))(jnp.asarray(u), jnp.asarray(r0).reshape(6, NX - 2, NX - 2))
        out = torch.empty((6, NX, NX), dtype=torch.float64)
        triton_kernels.theta_rhs2d_plain(_t(u), out, dt, 0.0, hp.fx, hp.fy, _t(r1), _t(r0),
                                         ring=hp._ring, g=_t(g))
        _close(out, ref)
        return
    ju, shift = jnp.asarray(u), theta * dt
    jr1, jr0 = (jnp.asarray(r).reshape(6, NX - 2, NX - 2) for r in (r1, r0))
    if theta == 1.0:
        b = ju[:, 1:-1, 1:-1] + dt * jr1
    else:
        b = (ju - shift * jax.vmap(hj._apply_L)(ju))[:, 1:-1, 1:-1] \
            + dt * (theta * jr1 + (1 - theta) * jr0)
    b = b.at[:, :, 0].add(shift * hj.fy * hj.bc_left_arr[1:-1])
    b = b.at[:, :, -1].add(shift * hj.fy * hj.bc_right_arr[1:-1])
    b = b.at[:, 0, :].add(shift * hj.fx * hj.bc_top_arr[1:-1])
    b = b.at[:, -1, :].add(shift * hj.fx * hj.bc_bottom_arr[1:-1])
    out = torch.empty((6, NX - 2, NX - 2), dtype=torch.float64)
    triton_kernels.theta_rhs2d_plain(_t(u), out, dt, theta, hp.fx, hp.fy, _t(r1), _t(r0),
                                     lift=hp._lift)
    _close(out, b)


# ---------------------------------------------------------------------------
# the physical slice as a whole
# ---------------------------------------------------------------------------


def _build(mod, method="BE", nx=NX, nt=NT, ms=(M, M), t_end=1.0, time_dependent=False):
    t = np.linspace(0, t_end, nt)
    rhs = (_jrhs_t if time_dependent else _jrhs) if mod is J else \
        (_prhs_t if time_dependent else _prhs)
    out, s = [], 1
    for lvl in range(len(ms) + 1):
        out.append(mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=nx, a=1.0,
                              rhs=rhs, init_cond=_ic, t_interval=t[::s], method=method,
                              bc_left=0.5, bc_top=lambda x: 0.5 * x, **_cpu(mod)))
        if lvl < len(ms):
            s *= ms[lvl]
    return out


FE_GRID = dict(method="FE", nx=9, nt=65, ms=(2, 2), t_end=1.0 / 16)


def _tube(mgrit):
    u = mgrit.u[0]
    return u.numpy() if isinstance(u, torch.Tensor) else np.asarray(u)


def _check(mj, cj, mp, cp):
    assert len(cp) == len(cj)
    np.testing.assert_allclose(cp, cj, rtol=H_RTOL, atol=H_ATOL)
    tj, tp = _tube(mj), _tube(mp)
    assert tp.shape == tj.shape
    np.testing.assert_allclose(tp, tj, rtol=0, atol=TUBE_ATOL)


@pytest.mark.parametrize("entry", ["solve", "solve_compiled"])
@pytest.mark.parametrize("condensed", [True, False])
@pytest.mark.parametrize("method", ["BE", "CN"])
def test_physical_slice_matches_jax(method, condensed, entry):
    runs = []
    for mod in (J, P):
        mgrit = mod.Mgrit(problem=_build(mod, method), tol=1e-300, max_iter=4,
                          logging_lvl=40, condensed=condensed)
        assert mgrit._condensed0 == condensed
        runs += [mgrit, getattr(mgrit, entry)()["conv"]]
    _check(*runs)
    assert runs[2].u[0].shape == (NT, NX, NX) and runs[2].u[0].dtype == torch.float64


@pytest.mark.parametrize("entry", ["solve", "solve_compiled"])
def test_fe_slice_matches_jax(entry, caplog):
    """FE declines the condensed carry with JAX's INFO line and runs the
    full-tube executor; both packages converge alike."""
    runs, messages = [], []
    for mod in (J, P):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mgrit = mod.Mgrit(problem=_build(mod, **FE_GRID), tol=1e-300, max_iter=5,
                              logging_lvl=logging.INFO)
        messages.append([r.getMessage() for r in caplog.records if DECLINE in r.getMessage()])
        assert not mgrit._condensed0
        runs += [mgrit, getattr(mgrit, entry)()["conv"]]
    assert len(messages[0]) == 1 and messages[1] == messages[0]
    assert "relax_interval hook declined this configuration" in messages[0][0]
    _check(*runs)


def test_time_dependent_physical_slice_matches_jax():
    """A time-dependent rhs declines the closed form in both packages; the
    full-tube executor then steps with the tabulated samples."""
    runs = []
    for mod in (J, P):
        mgrit = mod.Mgrit(problem=_build(mod, "CN", time_dependent=True), tol=1e-300,
                          max_iter=3, logging_lvl=40)
        assert not mgrit._condensed0
        runs += [mgrit, mgrit.solve()["conv"]]
    _check(*runs)


@pytest.mark.parametrize("method", ["BE", "CN"])
def test_physical_checkpoint_continuation(tmp_path, method):
    """A JAX physical solve, carried across with interop.state_from_numpy,
    continues in the port to the JAX package's history."""
    first = J.Mgrit(problem=_build(J, method), tol=1e-300, max_iter=2, logging_lvl=40)
    first.solve()
    path = str(tmp_path / "jax.npz")
    first.save_checkpoint(path)
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(3 * 3 - 2)]
    mj = J.Mgrit(problem=_build(J, method), tol=1e-300, max_iter=2, logging_lvl=40)
    mj.load_checkpoint(path)
    mp = P.Mgrit(problem=_build(P, method), tol=1e-300, max_iter=2, logging_lvl=40)
    state_from_numpy(mp, leaves)
    assert mp.u[0].shape[1:] == (NX, NX)
    _check(mj, mj.solve()["conv"], mp, mp.solve()["conv"])
