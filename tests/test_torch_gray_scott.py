"""Port parity: 2D Gray-Scott (IMEX, IMPL, EXPL) against
``pymgrit_tpu.models.gray_scott_2d.GrayScott2D``, and the plain versions of
K10 ``periodic_solve2d`` with its species axis and of K14
``gray_scott_pointwise``.

Small sizes (nx = 12 and 16) in float64, inputs from a numpy seed.
Tolerances:

* operators and single steps: rtol 1e-12 against the largest entry.  The
  port solves the diffusion in the real Hartley basis, the JAX package with
  complex FFTs; both round each length-n transform (a few ulp);
* MGRIT histories: rtol 1e-9 with an atol at the float64 floor
  8 eps ||u_C||_2;
* iteration counts: equal.  Newton stops on max|g| >= nlsol_tol and
  BiCGStab on <r, r> > lsol_tol^2 <b, b>; the decisions are the same in both
  packages on these inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.models.gray_scott_2d import GrayScott2D as JGrayScott2D
from pymgrit_tpu_torch.interop import state_from_numpy
from pymgrit_tpu_torch.ops import periodic, triton_kernels

torch.set_num_threads(1)

RTOL = 1e-12
H_RTOL, FLOOR_OPS = 1e-9, 8
METHODS = ["IMEX", "IMPL", "EXPL"]
CPU = dict(device="cpu")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(p, j, rtol=RTOL):
    p, j = _np(p), _np(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * np.max(np.abs(j)))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _pair(nx, method, **kw):
    kw = dict(nx=nx, method=method, t_start=0, t_stop=1.0, nt=11, **kw)
    return JGrayScott2D(**kw), P.GrayScott2D(**kw, **CPU)


def _states(gj, seed):
    """Three states: the seed pattern, a scaled copy and a perturbed copy."""
    rng = np.random.default_rng(seed)
    s0 = np.asarray(gj.vector_t_start)
    return np.stack([s0, 0.9 * s0, np.clip(s0 + 0.05 * rng.standard_normal(s0.shape), 0, 1)])


def _build(mod, method, nx=16, nt=33, ms=(4,), t_stop=20.0):
    cpu = CPU if mod is P else {}
    cls = P.GrayScott2D if mod is P else JGrayScott2D
    g0 = cls(nx=nx, method=method, t_start=0, t_stop=t_stop, nt=nt, **cpu)
    problem, stride = [g0], 1
    for m in ms:
        stride *= m
        problem.append(cls(nx=nx, method=method, t_interval=g0.t[::stride], **cpu))
    return problem


def _floor(mgrit):
    u0 = _np(mgrit.u[0])
    info = mgrit.levels[0]
    return FLOOR_OPS * np.finfo(np.float64).eps * np.linalg.norm(u0[0:info.nt:info.m])


def _check_history(hp, hj, mp):
    assert hp.shape == hj.shape, (hp, hj)
    np.testing.assert_allclose(hp, hj, rtol=H_RTOL, atol=_floor(mp))


@pytest.mark.parametrize("nx", [12, 16])
def test_constructor_state(nx):
    gj, gp = _pair(nx, "IMEX")
    np.testing.assert_array_equal(gp.vector_t_start.numpy(), np.asarray(gj.vector_t_start))
    np.testing.assert_array_equal(gp.lap_eigs, gj.lap_eigs)
    assert gp.vector_template.shape == (2, nx, nx) and gp.vector_template.dtype == torch.float64
    assert (gp.dx, gp.du, gp.dv, gp.a, gp.b) == (gj.dx, gj.du, gj.dv, gj.a, gj.b)


def test_unknown_method_raises():
    with pytest.raises(Exception, match="Unknown method"):
        P.GrayScott2D(nx=8, method="CN", t_start=0, t_stop=1, nt=3, **CPU)


def test_hartley_basis_diagonalises_the_gray_scott_laplacian():
    """The Hartley matrix diagonalises Gray-Scott's periodic Laplacian
    (dx = L / nx) with the model's eigenvalue sums."""
    nx = 12
    gp = P.GrayScott2D(nx=nx, t_start=0, t_stop=1, nt=3, **CPU)
    H = periodic.hartley_basis(nx)
    L1 = (np.roll(np.eye(nx), 1, 0) + np.roll(np.eye(nx), -1, 0) - 2 * np.eye(nx)) / gp.dx ** 2
    lam1 = np.diag(H @ L1 @ H)
    np.testing.assert_allclose(H @ L1 @ H, np.diag(lam1), atol=1e-10 / gp.dx ** 2)
    np.testing.assert_allclose(lam1[:, None] + lam1[None, :], gp.lap_eigs, atol=1e-10 / gp.dx ** 2)


@pytest.mark.parametrize("nx", [12, 16])
def test_operators_match_jax(nx):
    """K10's species solve (plain) against _fft_solve_diffusion; K14's
    residual, its per-lane max and its Jacobian matvec (plain) against
    the expressions of JAX's _newton closures."""
    gj, gp = _pair(nx, "IMPL")
    ss = _states(gj, nx)
    w = np.random.default_rng(nx + 1).standard_normal(ss.shape)
    dts = np.array([0.5, 1.0, 0.25])
    _close(gp._diffusion_solve(_t(dts), _t(w)),
           np.stack([gj._fft_solve_diffusion(d, jnp.asarray(x)) for d, x in zip(dts, w)]))
    g, gmax = gp.g_of(_t(ss), _t(w), _t(dts))
    gjx = np.stack([s - d * (gj._diffuse(jnp.asarray(s)) + gj._reaction(jnp.asarray(s))) - s0
                    for s, s0, d in zip(ss, w, dts)])
    _close(g, gjx)
    _close(gmax, np.max(np.abs(gjx), axis=(1, 2, 3)))
    a, b = gj.a, gj.b

    def jac(s, x, d):
        u, v = s[0], s[1]
        ru = (-v ** 2 - a) * x[0] + (-2 * u * v) * x[1]
        rv = (v ** 2) * x[0] + (2 * u * v - b) * x[1]
        return x - d * (gj._diffuse(jnp.asarray(x)) + jnp.stack([ru, rv]))

    _close(gp.jac_mv(_t(ss), _t(w), _t(dts)),
           np.stack([jac(s, x, d) for s, x, d in zip(ss, w, dts)]))


@pytest.mark.parametrize("nx", [12, 16])
@pytest.mark.parametrize("method", METHODS)
def test_step_matches_jax(nx, method):
    gj, gp = _pair(nx, method)
    ss, t = _states(gj, 2 * nx), gj.t
    for k, s in enumerate(ss):
        _close(gp.step(_t(s), t[k], t[k + 1]), gj.step(jnp.asarray(s), t[k], t[k + 1]))
    ref = jax.vmap(gj.step)(jnp.asarray(ss), jnp.asarray(t[0:3]), jnp.asarray(t[[1, 3, 4]]))
    _close(gp.step_batched(_t(ss), t[0:3], t[[1, 3, 4]]), ref)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("with_g", [True, False])
def test_step_chain_matches_a_scan_of_steps(method, with_g):
    """J chains of L steps plus g, written into strided views of a tube."""
    gj, gp = _pair(12, method)
    ss = _states(gj, 5)
    t, m, L = gj.t, 3, 2
    tp = np.stack([t[j * m:j * m + L] for j in range(3)], 1)
    tc = np.stack([t[j * m + 1:j * m + L + 1] for j in range(3)], 1)
    g = np.random.default_rng(9).standard_normal((3, L, 2, 12, 12)) * 1e-3
    x, ref = jnp.asarray(ss), []
    for k in range(L):
        x = jax.vmap(gj.step)(x, jnp.asarray(tp[k]), jnp.asarray(tc[k]))
        if with_g:
            x = jnp.asarray(g[:, k]) + x
        ref.append(x)
    tube = torch.zeros((3 * m + 1, 2, 12, 12), dtype=torch.float64)
    out = tube[1:].view(3, m, 2, 12, 12)[:, :L]
    gp.step_chain(_t(ss), tp, tc, out, _t(g) if with_g else None)
    _close(out, np.stack(ref, 1))


def _jax_counts(gj, s0, dt):
    """(s, Newton iterations, BiCGStab iterations) of one JAX IMPL step,
    counted with debug callbacks: each Newton iteration evaluates g in the
    loop test and in the body, JAX's BiCGStab applies the Jacobian twice
    before its loop (r0, and once more in ``_isolve``) and twice per
    iteration, and the preconditioner twice per iteration; so _diffuse runs
    4 N + 1 + 2 C times and the FFT solve 2 C times."""
    calls = {"diffuse": 0, "pre": 0}
    diffuse, solve = gj._diffuse, gj._fft_solve_diffusion

    def counted(key, fn):
        def run(*args):
            jax.debug.callback(lambda: calls.__setitem__(key, calls[key] + 1))
            return fn(*args)
        return run

    gj._diffuse, gj._fft_solve_diffusion = counted("diffuse", diffuse), counted("pre", solve)
    try:
        s = np.asarray(gj._newton(jnp.asarray(s0), dt))
    finally:
        del gj._diffuse, gj._fft_solve_diffusion
    newton = (calls["diffuse"] - calls["pre"] - 1) // 4
    assert 4 * newton + 1 + calls["pre"] == calls["diffuse"] and calls["pre"] % 2 == 0
    return s, newton, calls["pre"] // 2


def test_newton_and_bicgstab_counts_per_lane_match_jax():
    gj, gp = _pair(12, "IMPL")
    ss = _states(gj, 11)
    dts = np.array([0.5, 2.0, 1.0])
    s, n, k = gp._newton_krylov(_t(ss), _t(dts), _t(ss))
    for i in range(3):
        sj, nj, kj = _jax_counts(gj, ss[i], dts[i])
        assert (int(n[i]), int(k[i])) == (nj, kj)
        _close(s[i], sj)
    assert int(n.min()) >= 2 and len(set(k.tolist())) > 1     # lanes differ


def test_newton_stops_at_maxiter_and_on_nan():
    """A lane whose residual cannot reach nlsol_tol runs nlsol_maxiter
    iterations; a lane with a NaN stops at once (max|g| >= tol is False on
    NaN, as in JAX)."""
    gp = P.GrayScott2D(nx=8, method="IMPL", t_start=0, t_stop=1, nt=3, nlsol_tol=0.0,
                       nlsol_maxiter=2, **CPU)
    s = gp.vector_t_start.expand(2, 2, 8, 8).clone()
    s[1, 1, 2, 3] = float("nan")
    x, n, k = gp._newton_krylov(s, torch.tensor([0.5, 0.5], dtype=torch.float64), s)
    assert n.tolist() == [2, 0] and int(k[1]) == 0
    assert bool(torch.isnan(x[1]).any()) and bool(torch.isfinite(x[0]).all())


@pytest.mark.parametrize("mode", ["expl", "residual", "jacobian"])
def test_pointwise_wrapper_routes_cpu_tensors_to_plain(mode):
    """K14 on CPU tensors is its plain version (strided pair views)."""
    tube = _t(np.random.default_rng(3).uniform(0, 1, (7, 2, 9, 9)))
    dt = _t([0.1, 0.2, 0.3])
    args = (mode, tube[0:6:2], torch.empty((3, 2, 9, 9), dtype=torch.float64), dt, 1e-3, 5e-4,
            0.02, 0.08, 0.01)
    kw = dict(r=tube[1:7:2]) if mode == "residual" else dict(w=tube[1:7:2])
    if mode == "expl":
        kw = dict(g=tube[1:7:2])
    got = triton_kernels.gray_scott_pointwise(*args, **kw)
    ref = triton_kernels.gray_scott_pointwise_plain(*args, **kw)
    for a, b in zip(got if mode == "residual" else [got], ref if mode == "residual" else [ref]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_imex_mgrit_history_matches_jax():
    """tests/models/test_gray_scott_burgers.py's MGRIT case: nx = 24, IMEX,
    t in [0, 20], 33 / 9 points."""
    runs = []
    for mod in (J, P):
        mg = mod.Mgrit(problem=_build(mod, "IMEX", nx=24), tol=1e-7, max_iter=10, logging_lvl=40)
        runs.append((mg, mg.solve()["conv"]))
    (mj, hj), (mp, hp) = runs
    assert hj[-1] < 1e-7
    _check_history(hp, hj, mp)
    np.testing.assert_allclose(_np(mp.u[0]), _np(mj.u[0]), rtol=0, atol=1e-11)


def test_three_level_at_mgrit_matches_jax():
    """The space-time demo's solver, small: AtMgrit(k=2), three levels."""
    runs = []
    for mod in (J, P):
        mg = mod.AtMgrit(k=2, problem=_build(mod, "IMEX", nx=12, nt=65, ms=(4, 4), t_stop=8.0),
                         tol=1e-7, max_iter=8, logging_lvl=40)
        runs.append((mg, mg.solve()["conv"]))
    (mj, hj), (mp, hp) = runs
    _check_history(hp, hj, mp)


@pytest.mark.parametrize("method", ["IMPL", "EXPL"])
def test_impl_and_expl_mgrit_histories_match_jax(method):
    """Three iterations of two levels (9 coarse points, so no exact finish)."""
    runs = []
    for mod in (J, P):
        mg = mod.Mgrit(problem=_build(mod, method, nx=8, nt=33, t_stop=8.0), tol=1e-300,
                       max_iter=3, logging_lvl=40)
        runs.append((mg, mg.solve()["conv"]))
    (mj, hj), (mp, hp) = runs
    _check_history(hp, hj, mp)


def test_checkpoint_continuation(tmp_path):
    """A JAX IMEX solve, carried across with interop.state_from_numpy,
    continues in the port to the JAX package's history."""
    first = J.Mgrit(problem=_build(J, "IMEX", nx=12), tol=1e-300, max_iter=2, logging_lvl=40)
    first.solve()
    path = str(tmp_path / "jax.npz")
    first.save_checkpoint(path)
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(3 * 2 - 2)]
    mj = J.Mgrit(problem=_build(J, "IMEX", nx=12), tol=1e-300, max_iter=2, logging_lvl=40)
    mj.load_checkpoint(path)
    mp = P.Mgrit(problem=_build(P, "IMEX", nx=12), tol=1e-300, max_iter=2, logging_lvl=40)
    state_from_numpy(mp, leaves)
    hj, hp = mj.solve()["conv"][:2], mp.solve()["conv"]
    assert np.all(np.isfinite(hj))
    _check_history(hp, hj, mp)


def demo_at_history(mod, nx, nt, iters):
    """``examples/at_mgrit/example_at_mgrit_gray_scott.py``'s solver --
    IMEX, AtMgrit(k=8), coarsening 16/4, tol 1e-7 -- at the demo's fine step
    8 / 2^14 on t in [0, 8 (nt - 1) / 2^14]: (solver, history)."""
    problem = _build(mod, "IMEX", nx=nx, nt=nt, ms=(16, 4), t_stop=8.0 * (nt - 1) / 2 ** 14)
    mg = mod.AtMgrit(k=8, problem=problem, tol=1e-7, max_iter=iters, logging_lvl=40)
    return mg, np.asarray(mg.solve()["conv"])


# the demo's AT(8) reduces its residual by this factor an iteration from the
# first (the JAX package on the CPU, nx = 16, nt = 4097)
DEMO_AT_RATE = 0.993246


def test_demo_at_mgrit_stalls_as_in_jax():
    """On [0, 2] at the demo's fine step both packages stall alike: the same
    history, reduced by DEMO_AT_RATE an iteration (rtol 1e-5)."""
    (mj, hj), (mp, hp) = (demo_at_history(mod, 16, 4097, 3) for mod in (J, P))
    _check_history(hp, hj, mp)
    np.testing.assert_allclose(hj[1:] / hj[:-1], DEMO_AT_RATE, rtol=1e-5)


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_gray_scott.py NX NT ITERS jax|torch
    # prints the demo's AT history and its reduction per iteration in one
    # package on the CPU (nx = 128, nt = 4097 takes about 7 GB)
    import sys
    nx_, nt_, iters_ = (int(a) for a in sys.argv[1:4])
    _, h = demo_at_history(J if sys.argv[4] == "jax" else P, nx_, nt_, iters_)
    print(sys.argv[4], f"nx={nx_} nt={nt_}", "history", h.tolist(), "per iteration",
          (h[1:] / h[:-1]).tolist())
