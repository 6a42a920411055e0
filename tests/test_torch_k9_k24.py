"""K24 ``dd_theta_chain`` (a thread a coefficient, a chain's invariants
formed once, its rows a step ahead; ``csrc/dd_theta_chain.cu``) and K9
``affine_windows`` (each row loaded once for a run of lanes,
``csrc/affine_windows.cu``), both on the one-call launch path: their plain
versions against the JAX package, both wrappers' plans, packed arguments
and cached checks (the launches the checks would make, run by numpy
stand-ins of the C launchers: K9's stand-in walks the kernel's runs, head,
middle and tail rows), and on the card the kernels against their plain
versions.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k9_k24.py -q -m cuda --noconftest

and the rest here with ``-m 'not cuda'`` (the JAX package is imported by
the tests that compare with it, never by the ``cuda`` ones).

Tolerances.  K24's plain version equals the JAX package's eager DD
``Heat2D._step_spectral`` chain bit for bit in hi and lo, given the same
float32 rhs rows: the two packages' rhs tables differ by up to two float32
ulps (the spectral transform of the rhs rounds in another order), so both
sides read the JAX package's rows.  On the card K24 equals its plain
version bit for bit (every float32 operation rounds once, in the plain
version's order).  K9's plain version against the JAX package's
``AtMgrit._forward_solve``: 1e-12 of the largest entry (the port steps a
window by A x + b, the JAX package by the model's step, b / (1 + dt lam):
the same map rounded differently).  K9's numpy stand-in against the plain
version: 1e-14 of the largest entry.  On the card K9 against its plain
version at ``KERNEL_RTOL`` of the largest entry (1e-13 float64, 1e-5
float32: the kernel contracts A x + b into an FMA), a second launch bit for
bit with the first.
"""

import ctypes

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, dd, heat_kernels, prefix

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
F32 = dict(dtype=torch.float32)
KERNEL_RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
JAX_RTOL = 1e-12
MODEL_RTOL = 1e-14
_CT = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got, ref, rtol):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_dd(a, b):
    return torch.equal(_bits(a.hi), _bits(b.hi)) and torch.equal(_bits(a.lo), _bits(b.lo))


def _cuda_facts(ops, index=0):
    """The facts of these tensors as if they lay on CUDA device ``index``."""
    dev = torch.device("cuda", index)
    return tuple((t.dtype, dev, t.shape, t.stride()) for t in ops)


def _view(ptr, shape, strides, dtype):
    """A numpy view of the memory at ``ptr`` (a CPU tensor's), element
    strides (None for a null pointer)."""
    if ptr == 0:
        return None
    span = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = np.ctypeslib.as_array((_CT[dtype] * span).from_address(ptr))
    es = buf.itemsize
    return np.lib.stride_tricks.as_strided(buf, shape, [st * es for st in strides])


# ---------------------------------------------------------------------------
# K24: the plain version against the JAX package's DD step chain
# ---------------------------------------------------------------------------


def _heat2d_dd(mod, method, tabulated):
    """A spectral DD Heat2D of 5 x 7 coefficients (N = 35: odd, not a
    multiple of 4) with a Dirichlet lift, on 13 time points."""
    import jax.numpy as jnp
    xp = jnp if mod.__name__ == "pymgrit_tpu" else np
    kw = {} if mod.__name__ == "pymgrit_tpu" else {"device": "cpu"}
    if tabulated:
        def rhs(x, y, t):
            return xp.sin(xp.pi * x) * xp.cos(y) * xp.exp(-t) * xp.ones_like(t * x * y)
    else:
        def rhs(x, y, t):
            return xp.sin(xp.pi * x) * xp.cos(y) * xp.ones_like(t * x * y)
    return mod.Heat2D(x_start=0, x_end=1, y_start=3, y_end=5, nx=7, ny=9, a=3.5, rhs=rhs,
                      init_cond=lambda x, y: np.sin(np.pi * x) * np.cos(y), bc_left=1.0,
                      bc_right=2.0, bc_bottom=0.5, bc_top=0.0, t_interval=np.linspace(0, 1, 13),
                      method=method, basis="spectral", precision="dd", **kw)


def _jax_pair(x):
    """A port DD of a JAX DD's flattened components."""
    return dd._raw(torch.tensor(np.asarray(x.hi)).reshape(-1),
                   torch.tensor(np.asarray(x.lo)).reshape(-1))


@pytest.mark.parametrize("J,L", [(1, 1), (1, 4), (3, 1), (3, 4)])
@pytest.mark.parametrize("tabulated", [False, True])
@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("method", ["BE", "CN"])
def test_k24_plain_matches_jax_step_chain(method, with_g, tabulated, J, L):
    """J chains of L steps (chain j from point 4 j), each step plus g when
    given, into the packed (J, L, 2, N) tube layout of the solver: bit for
    bit with the JAX package's eager ``_step_spectral`` (+ g) in hi and lo.
    A time-independent rhs reaches the kernel as rows of stride 0."""
    import pymgrit_tpu as JX
    import pymgrit_tpu_torch as P
    from pymgrit_tpu.ops import dd as jdd
    mj, mp = _heat2d_dd(JX, method, tabulated), _heat2d_dd(P, method, tabulated)
    N, shape = mp._N, mp._int_shape
    rng = np.random.default_rng(24 + J + 10 * L)
    x0 = rng.uniform(-1, 1, (J, N))
    g = rng.uniform(-1e-3, 1e-3, (J, L, N))
    starts = 4 * np.arange(J)
    tp = np.stack([mp.t[starts + k] for k in range(L)])
    tc = np.stack([mp.t[starts + k + 1] for k in range(L)])

    def rows(ts):
        if not tabulated:       # one row, as the model's table_rows gives it
            row = np.asarray(mj._rhs_at(jdd.from_f64(ts[0, 0]))).reshape(-1)
            return torch.tensor(row).expand(L, J, N)
        return torch.tensor(np.stack([[np.asarray(mj._rhs_at(jdd.from_f64(v))).reshape(-1)
                                       for v in row] for row in ts]))

    dt = dd.dd_arith("sub", dd.from_f64(tc), dd.from_f64(tp))
    seed = torch.stack([dd.from_f64(x0).hi, dd.from_f64(x0).lo], 1)
    gt = dd.from_f64(g)
    gp = torch.stack([gt.hi, gt.lo], 2)
    out = torch.full((J, L, 2, N), float("nan"), **F32)
    got = heat_kernels.dd_theta_chain_plain(
        dd.pair(seed), dd.pair(out, None, 2), dt, _jax_pair(mj._Lam), _jax_pair(mj._lift_hat),
        rows(tc), rows(tp), mp.theta, dd.pair(gp, None, 2) if with_g else None)
    assert got.hi.data_ptr() == out.data_ptr()
    for j in range(J):
        x = jdd.from_f64(x0[j].reshape(shape))
        for k in range(L):
            x = mj._step_spectral(x, jdd.from_f64(tp[k, j]), jdd.from_f64(tc[k, j]))
            if with_g:
                x = jdd.from_f64(g[j, k].reshape(shape)) + x
            assert _same_dd(got[j, k], _jax_pair(x)), (j, k)


def test_k24_wrapper_on_the_cpu_is_the_plain_version():
    """The model's own chain (Heat2D.step_chain through the wrapper, the
    model's tables) against the plain version called directly."""
    import pymgrit_tpu_torch as P
    m = _heat2d_dd(P, "CN", True)
    J, L, N = 2, 3, m._N
    rng = np.random.default_rng(5)
    seed = torch.tensor(rng.uniform(-1, 1, (J, 2, N)), **F32)
    g = torch.tensor(rng.uniform(-1e-3, 1e-3, (J, L, 2, N)), **F32)
    tp = np.stack([m.t[[k, 6 + k]] for k in range(L)])
    tc = np.stack([m.t[[k + 1, 7 + k]] for k in range(L)])
    out = torch.empty((J, L, 2, N), **F32)
    m.step_chain(seed, tp, tc, out, g)
    want = torch.empty_like(out)
    heat_kernels.dd_theta_chain_plain(
        dd.pair(seed), dd.pair(want, None, 2), m._times.dd_steps(tp, tc, m.ops), m._Lam_dd,
        m._lift_hat_dd, m._rhs_rows(tc), m._rhs_rows(tp), m.theta, dd.pair(g, None, 2))
    assert torch.equal(_bits(out), _bits(want))


# ---------------------------------------------------------------------------
# K24: plan, pack, the cached checks and the launch they would make
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("J,N,want", [
    (32, 16129, (256, 64, 2048)),        # dd_toms129's level 1 (F-relaxation, C-steps)
    (8, 16129, (128, 127, 1016)),        # level 2
    (1, 16129, (64, 253, 253)),          # the coarsest march
    (3, 35, (64, 1, 3)),
    (600, 1024, (256, 4, 2400))])
def test_k24_plan(J, N, want):
    """One thread a coefficient, segments of a block's threads a chain, one
    block an item; the largest block of 256, 128, 64 threads that gives 4
    items an SM (132 SMs), else 64."""
    assert heat_kernels.dd_theta_chain_plan(J, N, 132) == want


def test_k24_pack_layout():
    args = heat_kernels.dd_theta_chain_pack(3, (70, 700, 140, 7000, 210, 0, 0), 10, 5, 35, True,
                                            False, False, (64, 1, 10))
    assert list(args) == [3, *[0] * 14, 70, 700, 140, 7000, 210, 0, 0, 10, 5, 35, 1, 10, 1, 0, 0,
                          64]


def _k24_ops(J=3, L=2, N=37, with_g=True, tabulated=False, seed=1):
    """Packed seeds, a packed tube view for out and g, DD step sizes, lam,
    lift and float32 rhs rows (stride 0 unless tabulated)."""
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(rng.uniform(-1, 1, (J, 2, N)), **F32)
    tube = torch.zeros((J * (L + 1), 2, N), **F32)
    out = tube.view(J, L + 1, 2, N)[:, 1:]
    g = torch.tensor(rng.uniform(-1e-3, 1e-3, (J, L, 2, N)), **F32) if with_g else None
    dt = dd.from_f64(rng.uniform(0.01, 0.1, (L, J)))
    lam, lift = dd.from_f64(rng.uniform(1, 1e3, N)), dd.from_f64(rng.uniform(-1, 1, N))
    if tabulated:
        r1 = torch.tensor(rng.uniform(-1, 1, (L, J, N)), **F32)
        r0 = torch.tensor(rng.uniform(-1, 1, (L, J, N)), **F32)
    else:
        r1 = torch.tensor(rng.uniform(-1, 1, N), **F32).expand(L, J, N)
        r0 = torch.tensor(rng.uniform(-1, 1, N), **F32).expand(L, J, N)
    return x0, out, dt, lam, lift, r1, r0, g


def _k24_call(x0, out, dt, lam, lift, r1, r0, g, theta=1.0):
    return heat_kernels.dd_theta_chain(dd.pair(x0), dd.pair(out, None, 2), dt, lam, lift, r1, r0,
                                       theta, None if g is None else dd.pair(g, None, 2))


def test_k24_repeat_call_hits_the_cache_and_new_strides_miss():
    """A second call with the same facts re-checks nothing (one cache hit,
    no miss); out at another chain stride is checked anew (a miss)."""
    ops = _k24_ops()
    _k24_call(*ops)
    info = heat_kernels._dd_chain_checked.cache_info()
    _k24_call(*ops[:7], ops[7].clone(), theta=1.0)
    after = heat_kernels._dd_chain_checked.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    _k24_call(ops[0], torch.zeros_like(ops[1]), *ops[2:])
    assert heat_kernels._dd_chain_checked.cache_info().misses == after.misses + 1


@pytest.mark.parametrize("change,match", [
    ("rhs float64", "float32"), ("dt transposed", "dt must be"), ("out lo strides", "hi and lo"),
    ("theta 0", "theta"), ("g shape", "g must have"), ("lam float64", "float32 pairs"),
    ("not a pair", "DD pair")])
def test_k24_cached_checks_raise_on_every_call(change, match):
    """After a good call has cached its facts, a call whose dtype, strides,
    shape or theta changed raises, twice, with a good call between (the
    cache holds no failed check)."""
    ops = list(_k24_ops())
    x0, out, dt, lam, lift, r1, r0, g = ops
    theta = 1.0
    if change == "rhs float64":
        ops[5] = r1.double()
    elif change == "dt transposed":
        t = dd.from_f64(np.full((dt.shape[1], dt.shape[0]), 0.05))
        ops[2] = dd._raw(t.hi.T, t.lo.T)
    elif change == "theta 0":
        theta = 0.0
    elif change == "g shape":
        ops[7] = g[:, :1]
    elif change == "lam float64":
        ops[3] = dd._raw(lam.hi.double(), lam.lo.double())
    for _ in range(2):
        _k24_call(x0, out, dt, lam, lift, r1, r0, g)
        with pytest.raises(ValueError, match=match):
            if change == "out lo strides":
                lo = torch.zeros((out.shape[0], out.shape[1], out.shape[3]), **F32)
                heat_kernels.dd_theta_chain(dd.pair(x0), dd._raw(out[:, :, 0], lo), dt, lam,
                                            lift, r1, r0, 1.0, dd.pair(g, None, 2))
            elif change == "not a pair":
                heat_kernels.dd_theta_chain(x0, dd.pair(out, None, 2), dt, lam, lift, r1, r0,
                                            1.0, dd.pair(g, None, 2))
            else:
                _k24_call(*ops, theta=theta)


class _K24Launcher:
    """A numpy stand-in for ``pm_dd_theta_chain``: reads the packed array
    as csrc/dd_theta_chain.cu does and runs the plain version on views of
    the memory its pointers and strides name."""

    def __init__(self):
        self.calls = []

    def __call__(self, address, theta, stream):
        a = list((ctypes.c_int64 * 31).from_address(address))
        self.calls.append((a, theta, stream))
        x_sj, out_sj, out_sk, g_sj, g_sk, r_sk, r_sj = a[15:22]
        J, L, N, segs, grid, cn, has_g, tab, threads = a[22:31]
        assert (threads, segs, grid) == heat_kernels.dd_theta_chain_plan(J, N, 132)
        assert cn == int(theta != 1.0) and has_g == int(a[5] != 0) and tab == int(
            (r_sk, r_sj) != (0, 0))

        def pair(i, shape, strides):
            hi, lo = (_view(a[i + c], shape, strides, torch.float32) for c in (0, 1))
            return None if hi is None else dd._raw(torch.from_numpy(hi), torch.from_numpy(lo))
        rows = [torch.from_numpy(_view(a[i], (L, J, N), (r_sk, r_sj, 1), torch.float32))
                for i in (13, 14)]
        heat_kernels.dd_theta_chain_plain(
            pair(1, (J, N), (x_sj, 1)), pair(3, (J, L, N), (out_sj, out_sk, 1)),
            pair(7, (L, J), (J, 1)), pair(9, (N,), (1,)), pair(11, (N,), (1,)), *rows, theta,
            pair(5, (J, L, N), (g_sj, g_sk, 1)) if has_g else None)
        return 0


@pytest.mark.parametrize("theta", [1.0, 0.5])
@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("tabulated", [False, True])
def test_k24_launch_the_checks_would_make(monkeypatch, theta, with_g, tabulated):
    """The launch the cached checks build for a CUDA call, made by the
    wrapper with a numpy stand-in of the launcher: every pointer, stride and
    flag of the packed array reaches the plain version, bit for bit with a
    direct call."""
    ops = _k24_ops(with_g=with_g, tabulated=tabulated)
    x0, out, dt, lam, lift, r1, r0, g = ops
    pairs = [dd.pair(x0), dd.pair(out, None, 2), dt, lam, lift]
    if g is not None:
        pairs.append(dd.pair(g, None, 2))
    checked = heat_kernels._dd_chain_checked
    monkeypatch.setattr(heat_kernels, "_dd_launcher", lambda nm: nm)
    monkeypatch.setattr(heat_kernels._build, "sm_count", lambda index: 132)
    checked.cache_clear()
    try:
        facts = tuple((f_hi, f_lo) for f_hi, f_lo in zip(
            _cuda_facts([p.hi for p in pairs], 1), _cuda_facts([p.lo for p in pairs], 1)))
        on_cpu, (args, launcher, index) = checked(facts, _cuda_facts((r1, r0), 1), theta)
        assert not on_cpu and launcher == "pm_dd_theta_chain" and index == 1
        fn = _K24Launcher()
        monkeypatch.setattr(heat_kernels, "_dd_chain_checked",
                            lambda f, r, th: (False, (args, fn, index)))
        monkeypatch.setattr(heat_kernels._build, "stream", lambda index: 99)
        want = torch.zeros_like(out)
        heat_kernels.dd_theta_chain_plain(dd.pair(x0), dd.pair(want, None, 2), dt, lam, lift, r1,
                                          r0, theta, None if g is None else dd.pair(g, None, 2))
        _k24_call(*ops, theta=theta)
        (packed, th, stream), = fn.calls
        assert (th, stream) == (theta, 99) and packed[0] == 1
        assert torch.equal(_bits(out), _bits(want))
    finally:
        checked.cache_clear()


# ---------------------------------------------------------------------------
# K9: the plain version against the JAX package's truncated windows
# ---------------------------------------------------------------------------


def _at_problem(mod, kind):
    """Two levels: Dahlquist 33 / 17 points (N = 1, A a full table, b of
    stride 0) or a spectral Heat2D of 5 x 5 coefficients, 33 / 9 points
    (N = 25, A and b of stride 0)."""
    kw = {} if mod.__name__ == "pymgrit_tpu" else {"device": "cpu"}
    if kind == "dahlquist":
        return [mod.Dahlquist(t_start=0, t_stop=5, nt=nt, **kw) for nt in (33, 17)]
    return [mod.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=7, ny=7, a=1.0,
                       rhs=lambda x, y, t: 0 * x + 1.0, init_cond=lambda x, y: 0 * x + 0.5,
                       t_interval=np.linspace(0, 1, nt), basis="spectral", bc_left=0.25, **kw)
            for nt in (33, 9)]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("kind,k", [(kind, k) for kind, nt in (("dahlquist", 17), ("heat2d", 9))
                                    for k in (1, 2, 5, nt - 1, nt + 3)])
def test_k9_plain_matches_jax_forward_solve(kind, k, full):
    """The coarsest level's windows of random u and g: the plain version on
    the rows the port's AtMgrit hands it (``_affine_rows``; with ``full``,
    A and b as contiguous tables) against the JAX package's
    ``AtMgrit._forward_solve``."""
    import jax.numpy as jnp
    import pymgrit_tpu as JX
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.core.solver import _rows
    mj = JX.AtMgrit(k=k, problem=_at_problem(JX, kind), logging_lvl=40)
    mp = P.AtMgrit(k=k, problem=_at_problem(P, kind), logging_lvl=40)
    lvl = mp.lvl_max - 1
    nt = mp.levels[lvl].nt
    shape = tuple(np.shape(mj.u[lvl]))
    rng = np.random.default_rng(k)
    u, g = rng.uniform(-1, 1, shape), rng.uniform(-1, 1, shape)
    want = np.asarray(mj._forward_solve(lvl, jnp.asarray(u), jnp.asarray(g)))[:nt]
    ut, gt = torch.tensor(u), torch.tensor(g)
    A, b = mp._affine_rows(lvl, ut[1:nt].shape)
    if full:
        A, b = A.contiguous(), b.contiguous()
    out = torch.empty_like(ut)
    prefix.affine_windows_plain(_rows(ut)[:nt], A, b, _rows(gt)[1:nt], _rows(out)[:nt], k)
    _close(out[:nt].numpy(), want, JAX_RTOL)
    np.testing.assert_array_equal(out[0].numpy(), u[0])


# ---------------------------------------------------------------------------
# K9: plan, pack, a model of the kernel's walk, the cached checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nt,N,k,want", [
    (2049, 16129, 64, (32, 65, 256, 4096)),      # the TOMS width
    (16385, 1, 128, (1, 16385, 64, 257)),        # the Dahlquist row
    (300, 16129, 64, (32, 10, 256, 631)),
    (200, 16129, 64, (1, 200, 256, 12601)),      # 7 runs a column: too few
    (2049, 16129, 32, (1, 2049, 256, 129096)),   # k = Q
    (65, 25, 3, (1, 65, 64, 26))])
def test_k9_plan(nt, N, k, want):
    """Q = 32 where k > 32 and the runs fill 4 blocks of 256 threads an SM
    (132 SMs), else 1; 256 threads a block where the threads fill 2 blocks
    an SM, else 64."""
    assert prefix.affine_windows_plan(nt, N, k, 132) == want


def test_k9_pack_layout():
    args = prefix.affine_windows_pack(2, (10, 0, 0, 10, 20), 7, 10, 4, False, (8, 1, 64, 1))
    assert list(args) == [2, 0, 0, 0, 0, 0, 10, 0, 0, 10, 20, 7, 10, 4, 8, 1, 0, 64, 1]


def _k9_model(u, A, B, g, out, nt, N, k, Q, rows):
    """The kernel's walk, a thread (run, column) at a time (the columns of
    a run at once): the fixed-shape runs (head, middle, tail) and the other
    runs lane by lane, each step g + (A x + b)."""
    def row(r):
        return g[r], (A[r] if rows else A[0]), (B[r] if rows else B[0])

    def step(w, x):
        return w[0] + (w[1] * x + w[2])
    for run in range(-(-nt // Q)):
        p0 = run * Q
        nq = min(Q, nt - p0)
        x = [None] * Q
        if Q > 1 and p0 >= k - 1 and nq == Q and k > Q:
            r0 = p0 - k + 1
            for h in range(Q):
                x[h] = u[r0 + h].copy()
                w = row(r0 + h)
                for q in range(h + 1):
                    x[q] = step(w, x[q])
            for r in range(r0 + Q, p0):
                w = row(r)
                for q in range(Q):
                    x[q] = step(w, x[q])
            for h in range(Q - 1):
                out[p0 + h] = x[h]
                w = row(p0 + h)
                for q in range(h + 1, Q):
                    x[q] = step(w, x[q])
            out[p0 + Q - 1] = x[Q - 1]
            continue
        for q in range(nq):
            p = p0 + q
            ws = max(0, p - k + 1)
            y = u[ws].copy()
            for r in range(ws, p):
                y = step(row(r), y)
            out[p] = y


class _K9Launcher:
    """A numpy stand-in for ``pm_affine_windows_f64``: reads the packed
    array as csrc/affine_windows.cu does and runs ``_k9_model``."""

    def __init__(self):
        self.calls = []

    def __call__(self, address, stream):
        a = list((ctypes.c_int64 * 19).from_address(address))
        self.calls.append((a, stream))
        u_s, a_s, b_s, g_s, o_s, nt, N, k, Q, runs, rows, block, grid = a[6:19]
        assert runs == -(-nt // Q) and grid == -(-N * runs // block)
        assert rows == int(a_s != 0 or b_s != 0)
        d = torch.float64
        _k9_model(_view(a[1], (nt, N), (u_s, 1), d), _view(a[2], (nt - 1, N), (a_s, 1), d),
                  _view(a[3], (nt - 1, N), (b_s, 1), d), _view(a[4], (nt - 1, N), (g_s, 1), d),
                  _view(a[5], (nt, N), (o_s, 1), d), nt, N, k, Q, rows)
        return 0


def _k9_ops(nt, N, rows, seed=9):
    """u and out as alternate rows of one tube, g rows 1..nt-1 of another,
    A and b full tables or rows of stride 0."""
    rng = np.random.default_rng(seed)
    tube = torch.tensor(rng.uniform(-1, 1, (2 * nt, N)), **F64)
    g = torch.tensor(rng.uniform(-1, 1, (nt, N)), **F64)[1:]
    if rows:
        A = torch.tensor(rng.uniform(0, 1, (nt - 1, N)), **F64)
        b = torch.tensor(rng.uniform(-1, 1, (1, N)), **F64).expand(nt - 1, N)
    else:
        A = torch.tensor(rng.uniform(0, 1, (1, N)), **F64).expand(nt - 1, N)
        b = torch.tensor(rng.uniform(-1, 1, (1, N)), **F64).expand(nt - 1, N)
    return tube[0::2], A, b, g, tube[1::2]


@pytest.mark.parametrize("nt,N,k,sms,rows", [
    (224, 160, 64, 1, False),    # Q = 32: whole runs, the first two lane by lane
    (203, 160, 64, 1, True),     # a partial last run, A with rows
    (200, 160, 33, 1, False),    # k = Q + 1: no middle rows
    (200, 80, 20, 1, False),     # Q = 1 (k too short for 32)
    (70, 3, 8, 132, False),      # Q = 1
    (9, 5, 12, 132, False),      # k > nt
    (9, 5, 1, 132, True),        # k = 1: a copy
    (33, 1, 30, 132, True)])     # N = 1
def test_k9_launch_the_checks_would_make(monkeypatch, nt, N, k, sms, rows):
    """The launch the cached checks build for a CUDA call (on a card of
    ``sms`` SMs, which with the shape picks Q), made by the wrapper with a numpy stand-in
    of the launcher walking the kernel's runs: within MODEL_RTOL of the
    plain version, every lane written."""
    u, A, b, g, out = _k9_ops(nt, N, rows)
    checked = prefix._windows_checked
    monkeypatch.setattr(prefix, "_launcher", lambda nm, d: (nm, d))
    monkeypatch.setattr(prefix._build, "sm_count", lambda index: sms)
    checked.cache_clear()
    try:
        on_cpu, (args, launcher, index) = checked(_cuda_facts((u, A, b, g, out), 3), k)
        assert not on_cpu and launcher == ("pm_affine_windows", torch.float64) and index == 3
        assert tuple(args[14:18]) == prefix.affine_windows_plan(nt, N, k, sms)[:2] + (
            int(rows),) + prefix.affine_windows_plan(nt, N, k, sms)[2:3]
        fn = _K9Launcher()
        monkeypatch.setattr(prefix, "_windows_checked", lambda f, kk: (False, (args, fn, index)))
        monkeypatch.setattr(prefix._build, "stream", lambda index: 5)
        want = prefix.affine_windows_plain(u, A, b, g, torch.zeros_like(u), k)
        out.fill_(float("nan"))
        prefix.affine_windows(u, A, b, g, out, k)
        (packed, stream), = fn.calls
        assert stream == 5 and packed[:6] == [3, u.data_ptr(), A.data_ptr(), b.data_ptr(),
                                              g.data_ptr(), out.data_ptr()]
        assert torch.isfinite(out).all()
        _close(out.numpy(), want.numpy(), MODEL_RTOL)
    finally:
        checked.cache_clear()


def test_k9_repeat_call_hits_the_cache_and_new_strides_miss():
    u, A, b, g, out = _k9_ops(20, 4, False)
    prefix.affine_windows(u, A, b, g, out, 5)
    info = prefix._windows_checked.cache_info()
    prefix.affine_windows(u, A, b, g, out, 5)
    after = prefix._windows_checked.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    prefix.affine_windows(u, A, b, g, torch.empty((20, 4), **F64), 5)
    assert prefix._windows_checked.cache_info().misses == after.misses + 1


@pytest.mark.parametrize("change,match", [
    ("overlap", "must not overlap u"), ("same view", "must not overlap u"),
    ("g dtype", "dtype"), ("g strides", "contiguous in its last axis"), ("k 0", "k = 0")])
def test_k9_cached_checks_raise_on_every_call(change, match):
    """After a good call has cached its facts, a call that changes only
    what the facts do not hold (out overlapping u, with u's shape and
    strides) or a dtype, a stride or k raises, twice, with a good call
    between."""
    tube = torch.zeros((13, 3), **F64)
    u, out = tube[:6], tube[6:12]
    A = torch.ones((5, 3), **F64)
    b, g = torch.zeros_like(A), torch.ones_like(A)
    args = dict(u=u, A=A, b=b, g=g, out=out, k=4)
    bad = dict(args)
    if change == "overlap":
        bad["out"] = tube[5:11]
    elif change == "same view":
        bad["out"] = u
    elif change == "g dtype":
        bad["g"] = g.float()
    elif change == "g strides":
        bad["g"] = torch.ones((3, 5), **F64).T
    else:
        bad["k"] = 0
    for _ in range(2):
        prefix.affine_windows(**args)
        with pytest.raises(ValueError, match=match):
            prefix.affine_windows(**bad)


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------

K24_CARD_CASES = [
    # (J, L, N, theta, g, tabulated, uniform dt)
    (32, 15, 16129, 1.0, True, False, True),     # dd_toms129's level 1
    (32, 15, 16129, 0.5, True, False, True),
    (3, 4, 37, 1.0, True, True, False),          # rows off alignment, N not a multiple of 4
    (3, 4, 37, 0.5, False, True, False),
    (2, 3, 1030, 0.5, True, False, False),
    (5, 2, 3, 1.0, False, False, True),          # N < 4
    (1, 1, 16129, 1.0, True, False, True),       # J = 1, L = 1
    (1, 1, 1, 0.5, True, True, True),
    (4, 33, 257, 1.0, True, True, True),         # a step size constant, rows tabulated
    (7, 40, 129, 0.5, True, False, False),       # more steps than a warp checks at once
    (20, 5, 13531, 1.0, True, True, False),      # N odd, step sizes that vary
    (70, 4, 3999, 0.5, False, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("J,L,N,theta,with_g,tabulated,uniform", K24_CARD_CASES)
def test_k24_on_card(cuda, J, L, N, theta, with_g, tabulated, uniform):
    """The kernel against its plain version bit for bit in hi and lo, into
    the solver's packed tube rows (an odd N puts every row at another
    16-byte offset), one launch a call (one step or more); a second launch
    bit for bit."""
    rng = np.random.default_rng(J * 100 + L + N)
    x0 = torch.tensor(rng.uniform(-1, 1, (J, 2, N)), dtype=torch.float32, device=cuda)
    g = torch.tensor(rng.uniform(-1e-3, 1e-3, (J, L, 2, N)), dtype=torch.float32, device=cuda)
    step = rng.uniform(0.01, 0.1, (L, J)) if not uniform else np.full((L, J), 1.0 / 512)
    dt = dd.from_f64(step, cuda)
    lam, lift = dd.from_f64(rng.uniform(1, 1e4, N), cuda), dd.from_f64(rng.uniform(-1, 1, N), cuda)
    shape = (L, J, N) if tabulated else (N,)
    r1, r0 = (torch.tensor(rng.uniform(-1, 1, shape), dtype=torch.float32, device=cuda)
              .expand(L, J, N) for _ in range(2))

    def run(ops):
        tube = torch.zeros((J * (L + 1) + 1, 2, N), dtype=torch.float32, device=cuda)
        out = tube[1:].view(J, L + 1, 2, N)[:, 1:]
        ops.dd_theta_chain(dd.pair(x0, ops), dd.pair(out, ops, 2), dt, lam, lift, r1, r0, theta,
                           dd.pair(g, ops, 2) if with_g else None)
        return tube

    before = heat_kernels.dd_theta_chain.launches
    got = run(DISPATCH)
    torch.cuda.synchronize()
    assert heat_kernels.dd_theta_chain.launches == before + 1
    want = run(PLAIN)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(run(DISPATCH)))


K9_CARD_CASES = [
    # (nt, N, k, A with rows)
    (2049, 16129, 64, False),    # the TOMS width: Q = 32
    (300, 16129, 64, True),
    (303, 16129, 40, True),      # a partial last run
    (300, 16129, 33, False),     # k = Q + 1: no middle rows
    (200, 16129, 64, False),     # Q = 1: too few runs a column
    (16385, 1, 128, True),       # the Dahlquist row: Q = 1, N = 1
    (65, 33, 5, True),
    (65, 33, 8, False),
    (9, 5, 12, False),           # k > nt
    (9, 5, 1, True),             # k = 1
    (1, 7, 3, False),            # one point
    (129, 2, 2, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nt,N,k,rows", K9_CARD_CASES)
def test_k9_on_card(cuda, dtype, nt, N, k, rows):
    """The kernel against its plain version at KERNEL_RTOL of the largest
    entry, u and out alternate rows of one tube, one launch a call; a
    second launch bit for bit with the first."""
    rng = np.random.default_rng(nt + N + k)
    tube = torch.tensor(rng.uniform(-1, 1, (2 * nt, N)), dtype=dtype, device=cuda)
    u = tube[0::2]
    g = torch.tensor(rng.uniform(-1e-2, 1e-2, (nt, N)), dtype=dtype, device=cuda)[1:]
    A = torch.tensor(rng.uniform(0.5, 1, (nt - 1 if rows else 1, N)), dtype=dtype,
                     device=cuda).expand(nt - 1, N)
    b = torch.tensor(rng.uniform(-1e-2, 1e-2, (1, N)), dtype=dtype, device=cuda).expand(nt - 1, N)

    def run(ops):
        out = torch.full((2 * nt, N), float("nan"), dtype=dtype, device=cuda)[1::2]
        return ops.affine_windows(u, A, b, g, out, k).clone()

    before = prefix.affine_windows.launches
    got = run(DISPATCH)
    torch.cuda.synchronize()
    assert prefix.affine_windows.launches == before + 1
    want = run(PLAIN)
    assert torch.isfinite(got).all()
    _close(got.cpu().numpy(), want.cpu().numpy(), KERNEL_RTOL[dtype])
    assert torch.equal(got, run(DISPATCH))
