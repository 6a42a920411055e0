"""Port parity: the 2D Allen-Cahn equation (IMEX, CN, IMPL) against
``pymgrit_tpu.AllenCahn``, and the plain versions of K10
``periodic_solve2d`` and K11 ``allen_cahn_pointwise``.

Small sizes (nx = 16 and 17) in float64, inputs from a numpy seed.
Tolerances:

* operators and single steps: rtol 1e-12 against the largest entry.  The
  port solves in the real Hartley basis, the JAX package with complex
  dense DFT products; both round each length-n product (a few ulp), and
  XLA folds the division by dx^2 into a reciprocal product;
* MGRIT histories: rtol 1e-9 with an atol at the float64 floor
  8 eps ||u_C||_2 (the IMPL and IMEX tails end at that floor, where the two
  packages' roundings differ);
* iteration counts: equal.  Newton stops on max|g| >= 1e-12 and CG on
  <r, r> > lin_tol^2 <b, b>; the decisions are the same in both packages on
  these inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu_torch.interop import state_from_numpy
from pymgrit_tpu_torch.ops import periodic, pointwise, row_norms

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


RTOL = 1e-12
H_RTOL, FLOOR_OPS = 1e-9, 8
METHODS = ["IMEX", "CN", "IMPL"]
T_STOP, NT, MS = 0.032, 65, (4, 4)     # levels 65 / 17 / 5


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(p, j, rtol=RTOL):
    p, j = _np(p), _np(j)
    assert p.shape == j.shape, (p.shape, j.shape)
    np.testing.assert_allclose(p, j, rtol=rtol, atol=rtol * np.max(np.abs(j)))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _pair(nx, method):
    return (J.AllenCahn(nx=nx, method=method, t_start=0, t_stop=T_STOP, nt=NT),
            P.AllenCahn(nx=nx, method=method, t_start=0, t_stop=T_STOP, nt=NT, device="cpu"))


def _states(aj, seed):
    """Three states near the solution: the initial circle, shrunk, and
    perturbed by noise."""
    rng = np.random.default_rng(seed)
    u0 = np.asarray(aj.vector_t_start)
    noisy = np.clip(u0 + 0.05 * rng.standard_normal(u0.shape), -1, 1)
    return np.stack([u0, 0.9 * u0, noisy])


def _build(mod, method, nx=16):
    a0 = mod.AllenCahn(nx=nx, method=method, t_start=0, t_stop=T_STOP, nt=NT, **_cpu(mod))
    stride, problem = 1, [a0]
    for m in MS:
        stride *= m
        problem.append(mod.AllenCahn(nx=nx, method=method, t_interval=a0.t[::stride], **_cpu(mod)))
    return problem


def _floor(mgrit):
    u0 = _np(mgrit.u[0])
    info = mgrit.levels[0]
    return FLOOR_OPS * np.finfo(np.float64).eps * np.linalg.norm(u0[0:info.nt:info.m])


def _check_history(hp, hj, mp):
    assert hp.shape == hj.shape, (hp, hj)
    np.testing.assert_array_equal(np.isnan(hp), np.isnan(hj))
    fin = ~np.isnan(hj)
    np.testing.assert_allclose(hp[fin], hj[fin], rtol=H_RTOL, atol=_floor(mp))


@pytest.mark.parametrize("nx", [16, 17])
def test_constructor_state(nx):
    aj, ap = _pair(nx, "IMPL")
    np.testing.assert_array_equal(ap.vector_t_start.numpy(), np.asarray(aj.vector_t_start))
    np.testing.assert_array_equal(ap.lap_eigs, aj.lap_eigs)
    assert ap.vector_template.shape == (nx, nx) and ap.vector_template.dtype == torch.float64
    assert ap.exact_radius(0.01) == aj.exact_radius(0.01)
    assert ap.compute_radius(ap.vector_t_start) == aj.compute_radius(aj.vector_t_start)


def test_unknown_method_raises():
    with pytest.raises(Exception, match="Unknown method"):
        P.AllenCahn(nx=8, method="RK4", t_start=0, t_stop=1, nt=3, device="cpu")


@pytest.mark.parametrize("nx", [16, 17])
def test_hartley_basis_is_symmetric_orthogonal_and_diagonalises_L(nx):
    H = periodic.hartley_basis(nx)
    np.testing.assert_array_equal(H, H.T)
    np.testing.assert_allclose(H @ H, np.eye(nx), atol=1e-14)
    ap = P.AllenCahn(nx=nx, method="IMEX", t_start=0, t_stop=1, nt=3, device="cpu")
    L1 = (np.roll(np.eye(nx), 1, 0) + np.roll(np.eye(nx), -1, 0) - 2 * np.eye(nx)) * nx ** 2
    lam1 = np.diag(H @ L1 @ H)
    np.testing.assert_allclose(H @ L1 @ H, np.diag(lam1), atol=1e-10 * nx ** 2)
    np.testing.assert_allclose(lam1[:, None] + lam1[None, :], ap.lap_eigs, atol=1e-10 * nx ** 2)


@pytest.mark.parametrize("nx", [16, 17])
def test_operators_match_jax(nx):
    aj, ap = _pair(nx, "IMPL")
    us = _states(aj, nx)
    b = np.random.default_rng(nx + 1).standard_normal(us.shape)
    shifts = np.array([1e-3, 2e-3, 5e-4])
    facs = np.array([5e-4, 1e-3, 2.5e-4])
    _close(ap._diffusion_solve(_t(shifts), _t(b)),
           np.stack([aj._fft_solve(s, jnp.asarray(x)) for s, x in zip(shifts, b)]))
    _close(ap._lap(_t(us)), np.stack([aj._lap(jnp.asarray(u)) for u in us]))
    _close(ap._nonlin(_t(us)), np.stack([aj._nonlin(jnp.asarray(u)) for u in us]))
    # g_of and jac_mv are closures inside JAX's _newton_solve: the same
    # expressions, written out here
    g, gmax = ap.g_of(_t(us), _t(b), _t(facs))
    gj = np.stack([u - f * (aj._lap(jnp.asarray(u)) + aj._nonlin(jnp.asarray(u))) - r
                   for u, r, f in zip(us, b, facs)])
    _close(g, gj)
    _close(gmax, np.max(np.abs(gj), axis=(1, 2)))
    diag = 1.0 / aj.eps ** 2 * (1.0 - (aj.nu + 1) * us ** aj.nu)
    jvj = np.stack([v - f * (aj._lap(jnp.asarray(v)) + d * v) for v, f, d in zip(b, facs, diag)])
    _close(ap.jac_mv(_t(us), _t(b), _t(facs)), jvj)


@pytest.mark.parametrize("nx", [16, 17])
@pytest.mark.parametrize("method", METHODS)
def test_step_matches_jax(nx, method):
    aj, ap = _pair(nx, method)
    us, t = _states(aj, 2 * nx), aj.t
    for k, u in enumerate(us):
        _close(ap.step(_t(u), t[k], t[k + 1]), aj.step(jnp.asarray(u), t[k], t[k + 1]))
    # a batch with one step size per state, as the solver's C-relaxation
    ref = jax.vmap(aj.step)(jnp.asarray(us), jnp.asarray(t[0:3]), jnp.asarray(t[[1, 3, 4]]))
    _close(ap.step_batched(_t(us), t[0:3], t[[1, 3, 4]]), ref)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("with_g", [True, False])
def test_step_chain_matches_a_scan_of_steps(method, with_g):
    """J chains of L steps plus g, written into strided views of a tube."""
    aj, ap = _pair(16, method)
    us = _states(aj, 5)
    t, m, L = aj.t, 4, 3
    tp = np.stack([t[j * m:j * m + L] for j in range(3)], 1)
    tc = np.stack([t[j * m + 1:j * m + L + 1] for j in range(3)], 1)
    g = np.random.default_rng(9).standard_normal((3, L, 16, 16)) * 1e-3
    x, ref = jnp.asarray(us), []
    for k in range(L):
        x = jax.vmap(aj.step)(x, jnp.asarray(tp[k]), jnp.asarray(tc[k]))
        if with_g:
            x = jnp.asarray(g[:, k]) + x
        ref.append(x)
    tube = torch.zeros((3 * m + 1, 16, 16), dtype=torch.float64)
    out = tube[1:].view(3, m, 16, 16)[:, :L]
    ap.step_chain(_t(us), tp, tc, out, _t(g) if with_g else None)
    _close(out, np.stack(ref, 1))


def _jax_counts(aj, rhs, fac, u0):
    """(u, Newton iterations, CG iterations) of one JAX Newton solve,
    counted with debug callbacks: each Newton iteration evaluates g in the
    loop test and in the body, and the CG applies the Jacobian once for r0
    and once per iteration, so the Laplacian runs 3 N + 1 + C times and the
    preconditioner N + C times."""
    calls = {"lap": 0, "pre": 0}
    lap, solve = aj._lap, aj._fft_solve

    def counted(key, fn):
        def run(*args):
            jax.debug.callback(lambda: calls.__setitem__(key, calls[key] + 1))
            return fn(*args)
        return run

    aj._lap, aj._fft_solve = counted("lap", lap), counted("pre", solve)
    try:
        u = np.asarray(aj._newton_solve(jnp.asarray(rhs), fac, jnp.asarray(u0)))
    finally:
        del aj._lap, aj._fft_solve
    newton = (calls["lap"] - calls["pre"] - 1) // 2
    return u, newton, calls["pre"] - newton


@pytest.mark.parametrize("method", ["IMPL", "CN"])
def test_newton_and_cg_counts_per_lane_match_jax(method):
    aj, ap = _pair(16, method)
    us = _states(aj, 11)
    facs = np.array([5e-4, 2e-3, 1e-3])
    rhs = us if method == "IMPL" else us + 1e-3 * np.random.default_rng(1).standard_normal(us.shape)
    u, n, k = ap._newton_krylov(_t(rhs), _t(facs), _t(us))
    for i in range(3):
        uj, nj, kj = _jax_counts(aj, rhs[i], facs[i], us[i])
        assert (int(n[i]), int(k[i])) == (nj, kj)
        _close(u[i], uj)
    assert int(n.min()) >= 2 and len(set(k.tolist())) > 1     # lanes differ


def test_newton_stops_at_maxiter_and_on_nan():
    """A lane whose residual cannot reach newton_tol runs newton_maxiter
    iterations; a lane with a NaN stops at once (max|g| >= tol is False on
    NaN, as in JAX)."""
    ap = P.AllenCahn(nx=8, method="IMPL", t_start=0, t_stop=1, nt=3, newton_tol=0.0,
                     newton_maxiter=3, device="cpu")
    u = ap.vector_t_start.expand(2, 8, 8).clone()
    u[1, 2, 3] = float("nan")
    x, n, k = ap._newton_krylov(u, torch.tensor([1e-3, 1e-3], dtype=torch.float64), u)
    assert n.tolist() == [3, 0]
    assert bool(torch.isnan(x[1]).any()) and bool(torch.isfinite(x[0]).all())


@pytest.mark.parametrize("nx", [16, 17])
def test_residual_max_keeps_nan_and_inf(nx):
    """K11's per-lane max|g| (plain version here) as jnp.max(|g|): NaN
    wherever the lane holds a NaN (even beside an inf), inf for an inf."""
    u = np.random.default_rng(4).uniform(-1, 1, (4, nx, nx))
    rhs = np.zeros_like(u)
    rhs[1, 3, 4] = np.nan
    rhs[2, 0, 0] = np.inf
    rhs[3, 1, 1], rhs[3, 2, 2] = np.inf, np.nan
    fac = _t(np.full(4, 1e-3))
    g, gmax = pointwise.allen_cahn_pointwise("residual", _t(u), torch.empty(u.shape, dtype=torch.float64),
                                             fac, 625.0, 1.0 / nx ** 2, 2, rhs=_t(rhs))
    ref = np.asarray(jnp.max(jnp.abs(jnp.asarray(g.numpy())), axis=(1, 2)))
    np.testing.assert_array_equal(gmax.numpy(), ref)
    assert np.isfinite(ref[0]) and np.isnan(ref[1]) and ref[2] == np.inf and np.isnan(ref[3])


def test_residual_row_norms_keep_nan_and_inf():
    """K3's plain version on NaN and inf rows, as the JAX package's
    batched 2-norm."""
    from pymgrit_tpu.core import vector as jv
    s = np.random.default_rng(5).standard_normal((4, 9))
    u = np.zeros_like(s)
    s[1, 2], s[2, 3] = np.nan, np.inf
    u[3, 4] = s[3, 4] = np.inf                  # inf - inf
    got = row_norms.residual_row_norms(_t(s), _t(u)).numpy()
    ref = np.asarray(jv.batched_norm(jnp.asarray(s) - jnp.asarray(u)))
    np.testing.assert_array_equal(got, ref)
    assert np.isnan(got[1]) and got[2] == np.inf and np.isnan(got[3])


def test_imex_history_keeps_the_nan_iterations():
    """IMEX on the coarse grid is unstable for the first two iterations
    (dt/eps^2 = 0.8 on the coarsest level): both packages report NaN there,
    then the same finite tail."""
    runs = []
    for mod in (J, P):
        mg = mod.Mgrit(problem=_build(mod, "IMEX"), tol=1e-10, max_iter=10, logging_lvl=40)
        runs.append((mg, mg.solve()["conv"]))
    (mj, hj), (mp, hp) = runs
    assert np.isnan(hj[:2]).all() and np.isfinite(hj[2:]).all() and hj.size == 8
    _check_history(hp, hj, mp)
    np.testing.assert_allclose(_np(mp.u[0]), _np(mj.u[0]), rtol=0, atol=1e-11)


def test_checkpoint_continuation(tmp_path):
    """A JAX IMEX solve, carried across with interop.state_from_numpy,
    continues in the port to the JAX package's history."""
    first = J.Mgrit(problem=_build(J, "IMEX"), tol=1e-300, max_iter=3, logging_lvl=40)
    first.solve()
    path = str(tmp_path / "jax.npz")
    first.save_checkpoint(path)
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(3 * 3 - 2)]
    mj = J.Mgrit(problem=_build(J, "IMEX"), tol=1e-300, max_iter=2, logging_lvl=40)
    mj.load_checkpoint(path)
    mp = P.Mgrit(problem=_build(P, "IMEX"), tol=1e-300, max_iter=2, logging_lvl=40)
    state_from_numpy(mp, leaves)
    # the JAX solver also restores the history, whose entry 3 outlives the
    # two new iterations
    hj, hp = mj.solve()["conv"][:2], mp.solve()["conv"]
    assert np.all(np.isfinite(hj))
    _check_history(hp, hj, mp)
