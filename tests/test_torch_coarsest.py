"""Port parity: the coarsest-level strategies -- the parallel-prefix
coarsest solve (``Mgrit(coarsest_prefix=True)``, kernel K8) and AT-MGRIT
(``AtMgrit(k)``, kernel K9 or masked batched steps) -- with the
``affine_coeffs`` of Dahlquist, Heat1D and Heat2D that feed them.

The same problems run through ``pymgrit_tpu`` and ``pymgrit_tpu_torch``.
Tolerances:

* plain scan against JAX's associative scan and a sequential loop: rtol and
  atol 1e-12 (the JAX package's own test; three association orders);
* the plain K9 against a direct loop: rtol 1e-14 (the same expression per
  step);
* affine_coeffs against step (nothing else checks the two agree): rtol 1e-14
  for Dahlquist, rtol 1e-12 with atol 1e-14 for the heat models;
* solver histories and level-0 tubes, port against JAX: rtol 1e-9, atol
  1e-13 (``tests/core/test_prefix_coarsest.py``'s tolerance: the prefix
  rounds differently from the scan, and XLA folds constants);
* the Heat1D AT-MGRIT golden: rtol 1e-3, the JAX test's own.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymgrit_tpu as J
import pymgrit_tpu_torch as P
from pymgrit_tpu.ops.prefix import affine_prefix_states as j_prefix
from pymgrit_tpu_torch.interop import state_from_numpy
from pymgrit_tpu_torch.ops import prefix

torch.set_num_threads(1)


def _cpu(mod):
    """Builds a port model on the CPU (the JAX package's models take no device)."""
    return {"device": "cpu"} if mod is P else {}


RTOL, ATOL = 1e-9, 1e-13
AT_GOLDEN = np.array([0.1767778, 0.01223507])


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _sequential(A, c, x0):
    out, x = [], x0
    for k in range(A.shape[0]):
        x = A[k] * x + c[k]
        out.append(x)
    return np.stack(out)


# ---------------------------------------------------------------------------
# the plain versions of K8 and K9
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,N,broadcast_A", [(37, 5, False), (1, 3, False), (1000, 1, False),
                                             (129, 7, True), (2, 1, True)])
def test_affine_prefix_states_matches_jax_and_loop(n, N, broadcast_A):
    rng = np.random.default_rng(n + N)
    A = rng.uniform(-1.0, 1.0, (1 if broadcast_A else n, N))
    A = np.broadcast_to(A, (n, N))
    c, x0 = rng.normal(size=(n, N)), rng.normal(size=N)
    ref = _sequential(A, c, x0)
    At = _t(A[:1]).expand(n, N) if broadcast_A else _t(A)
    got = prefix.affine_prefix_states(At, _t(c), _t(x0))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    jax_got = np.asarray(j_prefix(jnp.asarray(A), jnp.asarray(c), jnp.asarray(x0)))
    np.testing.assert_allclose(got.numpy(), jax_got, rtol=1e-12, atol=1e-12)


def test_affine_prefix_states_scalar_states_do_not_underflow():
    """1.2^-65536 underflows; the doubling scan never divides by it."""
    n = 65536
    A = torch.full((n,), 1 / 1.2, dtype=torch.float64)
    got = prefix.affine_prefix_states(A, torch.zeros(n, dtype=torch.float64),
                                      torch.ones((), dtype=torch.float64))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got[:40].numpy(), (1 / 1.2) ** np.arange(1, 41), rtol=1e-13)
    assert float(got[-1]) == 0.0


@pytest.mark.parametrize("with_g", [True, False])
def test_affine_prefix_plain_writes_strided_rows(with_g):
    """K8's plain version into the rows 1..n of a tube, b with stride 0."""
    rng = np.random.default_rng(3)
    n, N = 23, 4
    A, b_row, g = rng.uniform(0, 1, (n, N)), rng.normal(size=N), rng.normal(size=(n + 1, N))
    tube = torch.zeros((2 * (n + 1), N), dtype=torch.float64)[::2]
    tube[0] = _t(rng.normal(size=N))
    c = b_row[None] + (g[1:] if with_g else np.zeros((n, N)))
    ref = _sequential(A, c, tube[0].numpy())
    gt = _t(g)
    prefix.affine_prefix(_t(A), _t(b_row).expand(n, N), tube[0].clone(), tube[1:],
                         gt[1:] if with_g else None)
    np.testing.assert_allclose(tube[1:].numpy(), ref, rtol=1e-12, atol=1e-12)


def _windows_loop(u, A, b, g, k):
    out = u.copy()
    for p in range(u.shape[0]):
        ws = max(0, p - k + 1)
        x = u[ws]
        for i in range(ws + 1, p + 1):
            x = g[i - 1] + (A[i - 1] * x + b[i - 1])
        out[p] = x
    return out


@pytest.mark.parametrize("k", [1, 3, 7, 40])
@pytest.mark.parametrize("broadcast", [False, True])
def test_affine_windows_plain_matches_loop(k, broadcast):
    rng = np.random.default_rng(k)
    nt, N = 29, 3
    u, g = rng.normal(size=(nt, N)), rng.normal(size=(nt - 1, N))
    A = rng.uniform(0, 1, (1 if broadcast else nt - 1, N))
    b = rng.normal(size=A.shape)
    A, b = np.broadcast_to(A, (nt - 1, N)), np.broadcast_to(b, (nt - 1, N))
    ref = _windows_loop(u, A, b, g, k)
    At, bt = ((_t(x[:1]).expand(nt - 1, N) for x in (A, b)) if broadcast
              else (_t(A), _t(b)))
    out = torch.empty((nt, N), dtype=torch.float64)
    prefix.affine_windows(_t(u), At, bt, _t(g), out, k)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-14, atol=1e-15)
    np.testing.assert_array_equal(out[0].numpy(), u[0])
    if k == 1:
        np.testing.assert_array_equal(out.numpy(), u)


# ---------------------------------------------------------------------------
# affine_coeffs against step
# ---------------------------------------------------------------------------


_TIMES = (np.array([0.0, 1.25, 0.5, 4.0]), np.array([0.5, 1.3, 0.75, 4.1]))


@pytest.mark.parametrize("method", ["BE", "FE", "TR", "MR"])
def test_dahlquist_affine_coeffs_match_step(method):
    app = P.Dahlquist(t_start=0, t_stop=5, nt=11, method=method, device="cpu")
    japp = J.Dahlquist(t_start=0, t_stop=5, nt=11, method=method)
    u = torch.tensor([0.7317, -1.5, 2.0, 0.1], dtype=torch.float64)
    A, b = app.affine_coeffs(*_TIMES)
    assert A.shape == b.shape == (4,) and b.stride() == (0,)
    for i, (t0, t1) in enumerate(zip(*_TIMES)):
        np.testing.assert_allclose(float(A[i] * u[i] + b[i]), float(app.step(u[i], t0, t1)),
                                   rtol=1e-14)
        Aj, bj = japp.affine_coeffs(t0, t1)
        np.testing.assert_allclose([float(A[i]), float(b[i])], [float(Aj), float(bj)],
                                   rtol=1e-14)


def _heat2d(mod, nt, method, time_dependent=True, basis="spectral", nx=17, t_end=1.0):
    xp = jnp if mod is J else np
    if time_dependent:
        def rhs(x, y, t):
            return xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * xp.exp(-t) * xp.ones_like(t * x * y)
    else:
        def rhs(x, y, t):
            return xp.sin(xp.pi * x) * xp.sin(xp.pi * y) * xp.ones_like(t * x * y)
    return mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=nx, a=1.0, rhs=rhs,
                      init_cond=lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y),
                      t_interval=np.linspace(0, t_end, nt), basis=basis, method=method,
                      bc_left=0.25, **_cpu(mod))


def _heat1d(mod, nt, basis="spectral", time_dependent=True, nx=33):
    xp = jnp if mod is J else np
    if time_dependent:
        def rhs(x, t):
            return xp.sin(t) * xp.ones_like(x * t)
    else:
        def rhs(x, t):
            return xp.sin(xp.pi * x / 2) * xp.ones_like(x * t)
    return mod.Heat1D(x_start=0, x_end=2, nx=nx, a=1.0, init_cond=lambda x: np.sin(np.pi * x / 2),
                      rhs=rhs, basis=basis, t_interval=np.linspace(0, 2, nt), **_cpu(mod))


def _check_affine_against_step(app, t0, t1, shape):
    rng = np.random.default_rng(1)
    u = _t(rng.normal(size=(t0.size,) + shape))
    A, c = app.affine_coeffs(t0, t1)
    assert A.shape == c.shape == u.shape
    for i in range(t0.size):
        np.testing.assert_allclose((A[i] * u[i] + c[i]).numpy(),
                                   app.step(u[i], t0[i], t1[i]).numpy(), rtol=1e-12, atol=1e-14)
    return A, c


@pytest.mark.parametrize("method", ["BE", "CN"])
@pytest.mark.parametrize("time_dependent", [True, False])
def test_heat2d_affine_coeffs_match_step(method, time_dependent):
    app = _heat2d(P, 9, method, time_dependent)
    japp = _heat2d(J, 9, method, time_dependent)
    t = app.t
    # on the grid, uniform; then off the grid with another dt (rhs evaluated)
    for t0, t1 in ((t[:-1], t[1:]), (t[:3] + 1e-3, t[1:4] + 4e-3)):
        A, c = _check_affine_against_step(app, t0, t1, (15, 15))
        for i in range(t0.size):
            Aj, cj = japp.affine_coeffs(t0[i], t1[i])
            np.testing.assert_allclose(A[i].numpy(), np.asarray(Aj), rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(c[i].numpy(), np.asarray(cj), rtol=1e-12, atol=1e-14)
    A, c = app.affine_coeffs(t[:-1], t[1:])
    assert (A.stride(0) == 0) == (not time_dependent)


@pytest.mark.parametrize("time_dependent", [True, False])
def test_heat1d_affine_coeffs_match_step(time_dependent):
    app, japp = _heat1d(P, 17, time_dependent=time_dependent), _heat1d(J, 17, time_dependent=time_dependent)
    t = app.t
    A, c = _check_affine_against_step(app, t[:-1], t[1:], (31,))
    for i in (0, 7, 15):
        Aj, cj = japp.affine_coeffs(t[i], t[i + 1])
        np.testing.assert_allclose(A[i].numpy(), np.asarray(Aj), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(c[i].numpy(), np.asarray(cj), rtol=1e-12, atol=1e-14)
    assert (A.stride(0) == 0) == (not time_dependent)


def test_physical_bases_have_no_affine_coeffs():
    for mod in (J, P):
        assert getattr(_heat2d(mod, 9, "BE", basis="physical"), "affine_coeffs", None) is None
        assert getattr(_heat1d(mod, 9, basis="physical"), "affine_coeffs", None) is None


# ---------------------------------------------------------------------------
# Mgrit(coarsest_prefix=True): the port against the JAX package
# ---------------------------------------------------------------------------


def _tube(mgrit):
    return _np(mgrit.u[0])


def _prefix_pair(build, max_iter=4, **kw):
    """(solver, history) of the JAX prefix, the port's prefix and the
    port's sequential scan."""
    out = {}
    for name, mod, pfx in (("jax", J, True), ("port", P, True), ("scan", P, False)):
        mg = mod.Mgrit(problem=build(mod), tol=1e-300, max_iter=max_iter, logging_lvl=40,
                       coarsest_prefix=pfx, **kw)
        out[name] = (mg, mg.solve_compiled()["conv"])
    return out


def _check_prefix(runs, tube=True):
    (mj, hj), (mp, hp), (ms, hs) = runs["jax"], runs["port"], runs["scan"]
    assert len(hp) == len(hj) == len(hs)
    np.testing.assert_allclose(hp, hj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hp, hs, rtol=RTOL, atol=ATOL)
    if tube:
        np.testing.assert_allclose(_tube(mp), _tube(mj), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(_tube(mp), _tube(ms), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", ["BE", "TR"])
def test_dahlquist_prefix_matches_jax(method):
    def build(mod):
        return [mod.Dahlquist(t_start=0, t_stop=5, nt=1025, method=method, **_cpu(mod)),
                mod.Dahlquist(t_start=0, t_stop=5, nt=129, method=method, **_cpu(mod))]
    _check_prefix(_prefix_pair(build))


def test_heat2d_spectral_prefix_matches_jax():
    def build(mod):
        return [_heat2d(mod, 257, "CN"), _heat2d(mod, 33, "CN")]
    _check_prefix(_prefix_pair(build))


def test_heat1d_spectral_prefix_matches_jax():
    def build(mod):
        return [_heat1d(mod, nt) for nt in (257, 33)]
    _check_prefix(_prefix_pair(build))


@pytest.mark.parametrize("kw", [dict(cycle_type="F"), dict(conv_crit=1)],
                         ids=["F-cycle", "conv_crit=1"])
def test_prefix_f_cycle_and_jump_criterion_match_jax(kw):
    def build(mod):
        d0 = mod.Dahlquist(t_start=0, t_stop=5, nt=513, **_cpu(mod))
        d1 = mod.Dahlquist(t_interval=d0.t[::4], **_cpu(mod))
        return [d0, d1, mod.Dahlquist(t_interval=d1.t[::4], **_cpu(mod))]
    _check_prefix(_prefix_pair(build, max_iter=3, **kw))


def test_prefix_one_level_is_the_sequential_march():
    """A one-level solve through the prefix is the time march, to rounding."""
    app = P.Dahlquist(t_start=0, t_stop=2, nt=17, method="TR", device="cpu")
    mgrit = P.Mgrit(problem=[app], nested_iteration=False, max_iter=1, logging_lvl=40,
                    coarsest_prefix=True)
    mgrit.solve()
    seq = [app.vector_t_start]
    for i in range(1, 17):
        seq.append(app.step(seq[-1], app.t[i - 1], app.t[i]))
    np.testing.assert_allclose(mgrit.u[0].numpy(), torch.stack(seq).numpy(), rtol=1e-14)


def test_prefix_requires_affine_capability_alike(caplog):
    errs = []
    for mod in (J, P):
        phys = [_heat2d(mod, nt, "BE", basis="physical", nx=9) for nt in (33, 9)]
        with pytest.raises(Exception) as exc:
            mod.Mgrit(problem=phys, logging_lvl=40, coarsest_prefix=True)
        errs.append((type(exc.value).__name__, str(exc.value)))
    assert errs[0] == errs[1] and "affine_coeffs" in errs[1][1] and "Heat2D" in errs[1][1]
    lines = []
    for mod in (J, P):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.Mgrit(problem=[mod.Dahlquist(t_start=0, t_stop=1, nt=9, **_cpu(mod))] * 1,
                      max_iter=1, logging_lvl=logging.INFO, coarsest_prefix=True)
        lines.append([r.getMessage() for r in caplog.records if "parallel-prefix" in r.getMessage()])
    assert len(lines[0]) == 1 and lines[1] == lines[0]


# ---------------------------------------------------------------------------
# AtMgrit: the port against the JAX package
# ---------------------------------------------------------------------------


def _at_pair(k, build, entry="solve", **kw):
    runs = []
    for mod in (J, P):
        mg = mod.AtMgrit(k=k, problem=build(mod), logging_lvl=40, **kw)
        runs.append((mg, getattr(mg, entry)()["conv"]))
    return runs


def _check_at(runs, tube=True):
    (mj, hj), (mp, hp) = runs
    assert len(hp) == len(hj)
    np.testing.assert_allclose(hp, hj, rtol=RTOL, atol=ATOL)
    if tube:
        np.testing.assert_allclose(_tube(mp), _tube(mj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_dahlquist_at_mgrit_matches_jax(k):
    """The cases of tests/core/test_cross_validation_2.py (through K9's
    plain version here)."""
    def build(mod):
        return [mod.Dahlquist(t_start=0, t_stop=5, nt=101, **_cpu(mod)),
                mod.Dahlquist(t_start=0, t_stop=5, nt=51, **_cpu(mod))]
    _check_at(_at_pair(k, build, tol=1e-10, max_iter=12))


@pytest.mark.parametrize("basis", ["spectral", "physical"])
@pytest.mark.parametrize("entry", ["solve", "solve_compiled"])
def test_heat2d_at_mgrit_matches_jax(basis, entry):
    """Spectral: the coarsest level has affine_coeffs (K9's path).
    Physical: masked batched steps (K7 + K5 on the card)."""
    def build(mod):
        return [_heat2d(mod, nt, "BE", time_dependent=False, basis=basis, nx=9)
                for nt in (65, 17, 5)]
    _check_at(_at_pair(3, build, entry, tol=1e-300, max_iter=3))


def test_heat2d_at_mgrit_cn_time_dependent_matches_jax():
    def build(mod):
        return [_heat2d(mod, nt, "CN", nx=9) for nt in (65, 9)]
    _check_at(_at_pair(4, build, tol=1e-300, max_iter=3))


def _golden_build(basis):
    def build(mod):
        xp = jnp if mod is J else np

        def rhs(x, t):
            return -xp.sin(xp.pi * x) * (xp.sin(t) - 1 * xp.pi ** 2 * xp.cos(t))

        return [mod.Heat1D(x_start=0, x_end=2, nx=5, a=1, rhs=rhs,
                           init_cond=lambda x: np.sin(np.pi * x), t_start=0, t_stop=2, nt=nt,
                           basis=basis, **_cpu(mod))
                for nt in (65, 17, 5)]
    return build


@pytest.mark.parametrize("basis", ["physical", "spectral"])
def test_heat1d_at_mgrit_golden(basis):
    """tests/core/test_solver_goldens_2.py::test_at_mgrit_golden (reference
    tests/core/test_at_mgrit.py): physical basis, masked steps; spectral
    basis, K9's path."""
    runs = _at_pair(2, _golden_build(basis), cf_iter=1, nested_iteration=False, max_iter=2,
                    random_init_guess=False)
    _check_at(runs)
    np.testing.assert_allclose(runs[1][1], AT_GOLDEN, rtol=1e-3)


def test_at_mgrit_rejects_local_criteria_alike():
    for crit in (2, 3):
        errs = []
        for mod in (J, P):
            problem = [mod.Dahlquist(t_start=0, t_stop=5, nt=101, **_cpu(mod)),
                       mod.Dahlquist(t_start=0, t_stop=5, nt=51, **_cpu(mod))]
            with pytest.raises(Exception) as exc:
                mod.AtMgrit(k=3, problem=problem, conv_crit=crit, logging_lvl=40)
            errs.append(str(exc.value))
        assert errs[0] == errs[1] and "global criterion" in errs[0]


def test_at_mgrit_one_level_is_mgrit():
    """With one level there is no coarse grid to truncate."""
    runs = [cls(**kw, problem=[P.Dahlquist(t_start=0, t_stop=2, nt=17, device="cpu")],
                nested_iteration=False, max_iter=2, logging_lvl=40)
            for cls, kw in ((P.AtMgrit, dict(k=2)), (P.Mgrit, {}))]
    for mg in runs:
        mg.solve()
    np.testing.assert_array_equal(runs[0].u[0].numpy(), runs[1].u[0].numpy())


@pytest.mark.parametrize("basis", ["spectral", "physical"])
def test_at_mgrit_jax_state_continues_in_port(tmp_path, basis):
    """A JAX AtMgrit state, carried into the port mid-solve with
    interop.state_from_numpy, continues to the JAX package's history."""
    def build(mod):
        return [_heat2d(mod, nt, "BE", time_dependent=False, basis=basis, nx=9)
                for nt in (65, 17, 5)]
    first = J.AtMgrit(k=3, problem=build(J), tol=1e-300, max_iter=2, logging_lvl=40)
    first.solve()
    path = str(tmp_path / "jax.npz")
    first.save_checkpoint(path)
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(3 * 3 - 2)]
    mj = J.AtMgrit(k=3, problem=build(J), tol=1e-300, max_iter=2, logging_lvl=40)
    mj.load_checkpoint(path)
    mp = P.AtMgrit(k=3, problem=build(P), tol=1e-300, max_iter=2, logging_lvl=40)
    state_from_numpy(mp, leaves)
    _check_at([(mj, mj.solve()["conv"]), (mp, mp.solve()["conv"])])
