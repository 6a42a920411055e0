"""K13 ``rk4_brusselator`` (CUDA C++, ``csrc/rk4_brusselator.cu``: a thread
a lane, its step times and g rows copied a chunk ahead into shared memory)
and K23 ``dd_interval_affine`` (K1's interval blocking in double-double,
``csrc/dd_interval_affine.cu``: each DD value computed once, hi and lo rows
stored from their own sector alignment), both on the one-call launch path:
their plain versions against the JAX package, numpy stand-ins of the
kernels' arithmetic and store walk, the plans, packed arguments and cached
checks (the launches the checks would make, run by numpy stand-ins of the
C launchers), and on the card the kernels against their plain versions.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k13_k23.py -q -m cuda --noconftest

and the rest here with ``-m 'not cuda'`` (the JAX package is imported by
the tests that compare with it, never by the ``cuda`` ones).

Tolerances.  K13's plain version against the JAX package's eager
``rk4_step`` with ``Brusselator._f``: bit for bit (both divide dt by 6
and round each operation once).  The numpy stand-in of K13's per-lane
arithmetic (every operation a numpy scalar operation, rounded once, h6 a
division) equals the plain version bit for bit in float64 and float32.
K23's plain version equals the JAX package's eager DD ``relax_interval``
bit for bit in hi and lo (Heat2D and Heat1D, spectral), given the same
tables.  On the card each kernel equals its plain version bit for bit.
"""

import ctypes
import struct

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, dd, heat_kernels, runge_kutta

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
F32 = dict(dtype=torch.float32)
_CT = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float}

# the Brusselator's fine grid (models/brusselator.py: nt = 641 on [0, 12],
# m = 20), as chip_smoke.py's [ode] phase runs it
BRUSS_NT, BRUSS_M = 641, 20


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


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
# K13: inputs, the JAX package, a numpy stand-in of the kernel's arithmetic
# ---------------------------------------------------------------------------


def _k13_inputs(J, L, m, with_g, dtype, seed):
    """Seeds, (L, J) step times of J chains on the Brusselator's grid of J m
    steps (chain j from point j m), and g, made with numpy; returns
    make(device) -> (seed, tp, tc, g)."""
    rng = np.random.default_rng(seed)
    seeds = rng.uniform(0, 3, (J, 2))
    g = rng.uniform(-1e-3, 1e-3, (J, L, 2)) if with_g else None
    tt = np.linspace(0, 12, J * m + 1)
    tp, tc = (np.stack([tt[j * m + o:j * m + o + L] for j in range(J)], 1) for o in (0, 1))

    def t(a, dev):
        return None if a is None else torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                                   device=dev)
    return lambda dev: (t(seeds, dev), t(tp, dev), t(tc, dev), t(g, dev))


def _k13_run(ops, seed, tp, tc, g, out=None):
    """One K13 call into the chain rows of a fresh (J, L + 1, 2) tube (or
    into ``out``)."""
    J, L = tp.shape[1], tp.shape[0]
    if out is None:
        out = torch.full((J, L + 1, 2), float("nan"), dtype=seed.dtype,
                         device=seed.device)[:, 1:]
    return ops.rk4_brusselator(seed, tp, tc, out, g)


@pytest.mark.parametrize("J", [1, 3])
@pytest.mark.parametrize("L", [1, 5])
@pytest.mark.parametrize("with_g", [False, True])
def test_k13_plain_matches_jax_rk4_chain(J, L, with_g):
    """J chains of L steps of the Brusselator, each step plus g when given:
    the plain version bit for bit with the JAX package's ``rk4_step`` on
    ``Brusselator._f``, vmapped over the lanes, chained (eager)."""
    import jax
    import jax.numpy as jnp
    import pymgrit_tpu as JX
    from pymgrit_tpu.ops import runge_kutta as jrk
    bj = JX.Brusselator(t_start=0, t_stop=12, nt=2)
    seed, tp, tc, g = _k13_inputs(J, L, 7, with_g, torch.float64, 10 * J + L)("cpu")
    got = _k13_run(PLAIN, seed, tp, tc, g)
    step = jax.vmap(lambda y, a, b: jrk.rk4_step(bj._f, y, a, b))
    x = jnp.asarray(seed.numpy())
    for k in range(L):
        x = step(x, jnp.asarray(tp[k].numpy()), jnp.asarray(tc[k].numpy()))
        if with_g:
            x = jnp.asarray(g[:, k].numpy()) + x
        np.testing.assert_array_equal(got[:, k].numpy(), np.asarray(x))


def _k13_model(seed, tp, tc, g, a, b, dtype):
    """The kernel's per-lane arithmetic in numpy scalars of ``dtype`` (each
    operation rounded once, in csrc/rk4_brusselator.cu's order; h6 = dt / 6
    a division)."""
    T = np.float64 if dtype == torch.float64 else np.float32
    a, b, b1 = T(a), T(b), T(b + 1)
    J, L = tp.shape[1], tp.shape[0]
    out = np.empty((J, L, 2), dtype=T)

    def rhs(x, y):
        q = x * x
        return (a + q * y) - b1 * x, b * x - q * y
    for j in range(J):
        y0, y1 = T(seed[j, 0]), T(seed[j, 1])
        for k in range(L):
            dt = T(tc[k, j]) - T(tp[k, j])
            h2, h6 = dt * T(0.5), dt / T(6)
            k1 = rhs(y0, y1)
            k2 = rhs(y0 + h2 * k1[0], y1 + h2 * k1[1])
            k3 = rhs(y0 + h2 * k2[0], y1 + h2 * k2[1])
            k4 = rhs(y0 + dt * k3[0], y1 + dt * k3[1])
            y0 = y0 + h6 * (((k1[0] + T(2) * k2[0]) + T(2) * k3[0]) + k4[0])
            y1 = y1 + h6 * (((k1[1] + T(2) * k2[1]) + T(2) * k3[1]) + k4[1])
            if g is not None:
                y0, y1 = T(g[j, k, 0]) + y0, T(g[j, k, 1]) + y1
            out[j, k] = y0, y1
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_g", [False, True])
@pytest.mark.parametrize("a,b", [(1.0, 3.0), (0.7, 2.3)])
def test_k13_operation_order_equals_plain(dtype, with_g, a, b):
    """A numpy stand-in of K13's per-lane arithmetic in the kernel's order
    equals the plain version on the CPU bit for bit (the Brusselator's own
    a = 1, b = 3, and coefficients that are not exact in float32)."""
    seed, tp, tc, g = _k13_inputs(4, 6, BRUSS_M, with_g, dtype, 3)("cpu")
    got = _k13_run(PLAIN, seed, tp, tc, g) if (a, b) == (1.0, 3.0) else \
        runge_kutta.rk4_brusselator_plain(seed, tp, tc, torch.empty((4, 6, 2), dtype=dtype), g,
                                          a, b)
    want = _k13_model(seed.numpy(), tp.numpy(), tc.numpy(), None if g is None else g.numpy(),
                      a, b, dtype)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k13_sixth_divides_by_six(dtype):
    """rk4_step's dt / 6 (``_sixth``) is the division (the kernel's
    __ddiv_rn, the JAX package's divide) on the Brusselator's fine steps; a
    multiplication by the rounded reciprocal, what PyTorch's CUDA division
    by a Python scalar does, gives other bits on these inputs."""
    dt = np.diff(np.linspace(0, 12, BRUSS_NT)).astype(np.float64 if dtype == torch.float64
                                                       else np.float32)
    got = runge_kutta._sixth(torch.tensor(dt))
    np.testing.assert_array_equal(got.numpy(), dt / dt.dtype.type(6))
    assert not torch.equal(got, torch.tensor(dt) * (1.0 / torch.full((), 6.0, dtype=dtype)))


# ---------------------------------------------------------------------------
# K13: pack, the cached checks and the launch they would make
# ---------------------------------------------------------------------------


def _bits_of(v):
    return struct.unpack("<q", struct.pack("<d", v))[0]


def test_k13_pack_layout():
    args = runge_kutta.rk4_brusselator_pack(2, (2, 40, 2, 38, 2), 32, 19, 1.0, 3.0)
    assert list(args) == [2, 0, 0, 0, 0, 0, 2, 40, 2, 38, 2, 32, 19, _bits_of(1.0),
                          _bits_of(3.0), _bits_of(4.0)]


class _K13Launcher:
    """A numpy stand-in for ``pm_rk4_brusselator_f64`` / ``_f32``: reads the
    packed array as csrc/rk4_brusselator.cu does and runs ``_k13_model`` on
    views of the memory its pointers and strides name."""

    def __init__(self, dtype):
        self.dtype, self.calls = dtype, []

    def __call__(self, address, stream):
        a = list((ctypes.c_int64 * 16).from_address(address))
        self.calls.append((a, stream))
        s_sj, o_sj, o_sk, g_sj, g_sk, J, L = a[6:13]
        ca, cb, cb1 = (struct.unpack("<d", struct.pack("<q", v))[0] for v in a[13:16])
        assert cb1 == cb + 1
        d = self.dtype
        g = _view(a[5], (J, L, 2), (g_sj, g_sk, 1), d)
        out = _view(a[4], (J, L, 2), (o_sj, o_sk, 1), d)
        out[...] = _k13_model(_view(a[1], (J, 2), (s_sj, 1), d), _view(a[2], (L, J), (J, 1), d),
                              _view(a[3], (L, J), (J, 1), d), g, ca, cb, d)
        return 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_g", [False, True])
def test_k13_launch_the_checks_would_make(monkeypatch, dtype, with_g):
    """The launch the cached checks build for a CUDA call, made by the
    wrapper with a numpy stand-in of the launcher: every pointer, stride
    and coefficient of the packed array reaches the kernel's arithmetic,
    bit for bit with the plain version; out rows of a tube, seeds strided."""
    seed, tp, tc, g = _k13_inputs(5, 3, 4, with_g, dtype, 8)("cpu")
    seed = torch.cat([seed, seed], 1)[:, 1:3]       # a lane stride of 4
    a, b = 0.9, 2.7
    checked = runge_kutta._rk4_checked
    monkeypatch.setattr(runge_kutta, "_launcher", lambda nm, d: (nm, d))
    checked.cache_clear()
    try:
        out = torch.full((5, 4, 2), float("nan"), dtype=dtype)[:, 1:]
        ops = (seed, tp, tc, out) if g is None else (seed, tp, tc, out, g)
        on_cpu, (args, launcher, index) = checked(_cuda_facts(ops, 1), a, b)
        assert not on_cpu and launcher == ("pm_rk4_brusselator", dtype) and index == 1
        fn = _K13Launcher(dtype)
        monkeypatch.setattr(runge_kutta, "_rk4_checked",
                            lambda f, aa, bb: (False, (args, fn, index)))
        monkeypatch.setattr(runge_kutta._build, "stream", lambda index: 7)
        runge_kutta.rk4_brusselator(seed, tp, tc, out, g, a, b)
        (packed, stream), = fn.calls
        assert stream == 7 and packed[:6] == [1, seed.data_ptr(), tp.data_ptr(), tc.data_ptr(),
                                              out.data_ptr(), 0 if g is None else g.data_ptr()]
        want = runge_kutta.rk4_brusselator_plain(seed, tp, tc, torch.empty_like(out), g, a, b)
        assert torch.equal(_bits(out), _bits(want))
    finally:
        checked.cache_clear()


def test_k13_repeat_call_hits_the_cache_and_new_strides_miss():
    seed, tp, tc, g = _k13_inputs(3, 4, 5, True, torch.float64, 2)("cpu")
    _k13_run(DISPATCH, seed, tp, tc, g)
    info = runge_kutta._rk4_checked.cache_info()
    _k13_run(DISPATCH, seed, tp, tc, g)
    after = runge_kutta._rk4_checked.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    _k13_run(DISPATCH, seed, tp, tc, g, out=torch.empty((3, 4, 2), **F64))
    assert runge_kutta._rk4_checked.cache_info().misses == after.misses + 1


@pytest.mark.parametrize("change,match", [
    ("g dtype", "dtype"), ("seed shape", "seed has shape"), ("out shape", "out has shape"),
    ("tp strides", "tp and tc"), ("g shape", "g must have"),
    ("out strides", "contiguous in its last axis")])
def test_k13_cached_checks_raise_on_every_call(change, match):
    """After a good call has cached its facts, a call whose dtype, strides
    or shape changed raises, twice, with a good call between."""
    seed, tp, tc, g = _k13_inputs(3, 4, 5, True, torch.float64, 4)("cpu")
    out = torch.empty((3, 4, 2), **F64)
    bad = dict(seed=seed, tp=tp, tc=tc, out=out, g=g)
    if change == "g dtype":
        bad["g"] = g.float()
    elif change == "seed shape":
        bad["seed"] = torch.zeros((3, 3), **F64)
    elif change == "out shape":
        bad["out"] = torch.empty((2, 4, 2), **F64)
    elif change == "tp strides":
        bad["tp"] = torch.zeros((4, 6), **F64)[:, :3]
    elif change == "g shape":
        bad["g"] = g[:, :2]
    else:
        bad["out"] = torch.empty((3, 2, 4), **F64).transpose(1, 2)
    for _ in range(2):
        runge_kutta.rk4_brusselator(seed, tp, tc, out, g)
        with pytest.raises(ValueError, match=match):
            runge_kutta.rk4_brusselator(**bad)


def test_k13_model_uses_the_wrapper():
    """The Brusselator's step_chain goes through K13's wrapper (the plain
    version on the CPU): the model's chain equals a direct call."""
    import pymgrit_tpu_torch as P
    m = P.Brusselator(t_start=0, t_stop=12, nt=BRUSS_NT, device="cpu")
    rng = np.random.default_rng(6)
    seed = torch.tensor(rng.uniform(0, 3, (4, 2)), **F64)
    tp = np.stack([m.t[[0, 20, 40, 60]] + 0.0, m.t[[1, 21, 41, 61]]])
    tc = np.stack([m.t[[1, 21, 41, 61]], m.t[[2, 22, 42, 62]]])
    out = torch.empty((4, 2, 2), **F64)
    m.step_chain(seed, tp, tc, out)
    want = runge_kutta.rk4_brusselator_plain(seed, torch.tensor(tp), torch.tensor(tc),
                                             torch.empty_like(out))
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# K23: the plain version against the JAX package's DD relax_interval
# ---------------------------------------------------------------------------


def _spectral_dd(mod, kind):
    """A spectral DD Heat2D of 5 x 7 coefficients (N = 35: odd) with a
    Dirichlet lift, or a spectral DD Heat1D of 13 coefficients, on 17 time
    points, with a time-independent rhs (the JAX package's in jnp)."""
    kw = {} if mod.__name__ == "pymgrit_tpu" else {"device": "cpu"}
    import jax.numpy as jnp
    xp = jnp if mod.__name__ == "pymgrit_tpu" else np
    if kind == "heat2d":
        return mod.Heat2D(x_start=0, x_end=1, y_start=3, y_end=5, nx=7, ny=9, a=3.5,
                          rhs=lambda x, y, t: xp.sin(xp.pi * x) * xp.cos(y)
                          * xp.ones_like(t * x * y),
                          init_cond=lambda x, y: np.sin(np.pi * x) * np.cos(y), bc_left=1.0,
                          bc_right=2.0, bc_bottom=0.5, bc_top=0.0,
                          t_interval=np.linspace(0, 1, 17), basis="spectral", precision="dd",
                          **kw)
    return mod.Heat1D(x_start=0, x_end=2, nx=15, a=1.3,
                      rhs=lambda x, t: xp.sin(x) * xp.ones_like(t * x),
                      init_cond=lambda x: np.sin(np.pi * x), t_interval=np.linspace(0, 1, 17),
                      basis="spectral", precision="dd", **kw)


def _jax_dd(x):
    """A port DD of a JAX DD's components, flattened to rows of N."""
    n = np.asarray(x.hi).shape
    return dd._raw(torch.tensor(np.asarray(x.hi)).reshape(n[0], n[1], -1),
                   torch.tensor(np.asarray(x.lo)).reshape(n[0], n[1], -1))


@pytest.mark.parametrize("kind", ["heat2d", "heat1d"])
@pytest.mark.parametrize("m1,only_last", [(1, False), (4, False), (4, True)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("with_seed_out", [False, True])
def test_k23_plain_matches_jax_relax_interval(kind, m1, only_last, packed, with_seed_out):
    """J = 3 intervals of m1 steps (R = m1 rows, or the last one): the plain
    version on the JAX model's DD tables (the packages' rhs tables may
    differ by an ulp, so both sides read the JAX package's) bit for bit with
    the JAX package's eager DD ``relax_interval`` (interval-major) in hi and
    lo; operands packed (rows, 2, N) tube views or separate hi and lo
    tensors; seed_out a copy of the seeds."""
    import pymgrit_tpu as JX
    import pymgrit_tpu_torch as P
    from pymgrit_tpu.ops import dd as jdd
    mj, mp = _spectral_dd(JX, kind), _spectral_dd(P, kind)
    J = 3
    shape = tuple(np.shape(mj.vector_template.hi if hasattr(mj.vector_template, "hi")
                           else mj.vector_template))
    N = int(np.prod(shape))
    rng = np.random.default_rng(23 + m1 + 10 * packed)
    x0 = rng.uniform(-1, 1, (J, N))
    starts = 4 * np.arange(J)
    tp = np.stack([mp.t[starts + k] for k in range(m1)])
    tc = np.stack([mp.t[starts + k + 1] for k in range(m1)])
    want = _jax_dd(mj.relax_interval(jdd.from_f64(x0.reshape((J,) + shape)), tp, tc,
                                     only_last=only_last, interval_major=True))
    (Ah, Al), (Gh, Gl) = mj._interval_tables(float(tc[0, 0] - tp[0, 0]), m1)
    A, G = (dd._raw(torch.tensor(np.asarray(h)).reshape(m1, N),
                    torch.tensor(np.asarray(lo)).reshape(m1, N)) for h, lo in ((Ah, Al), (Gh, Gl)))
    r0, R = (m1 - 1, 1) if only_last else (0, m1)
    xs = dd.from_f64(x0)
    if packed:
        tube = torch.full((J * (R + 1), 2, N), float("nan"), **F32)
        out = dd.pair(tube.view(J, R + 1, 2, N)[:, 1:], None, 2)
        seed_out = dd.pair(tube[0::R + 1]) if with_seed_out else None
        x = dd.pair(torch.stack([xs.hi, xs.lo], 1))
    else:
        out = dd._raw(torch.full((J, R, N), float("nan"), **F32),
                      torch.full((J, R, N), float("nan"), **F32))
        seed_out = dd._raw(torch.empty((J, N), **F32), torch.empty((J, N), **F32)) \
            if with_seed_out else None
        x = xs
    got = heat_kernels.dd_interval_affine_plain(x, A, G, out, r0, seed_out)
    assert got is out and _same_dd(out, want)
    if with_seed_out:
        assert _same_dd(seed_out, xs)


def test_k23_model_uses_the_wrapper():
    """Heat2D's DD relax_interval (the materialization's call: into a tube
    view, the seeds copied to the C-rows) through K23's wrapper equals the
    plain version called on the model's tables."""
    import pymgrit_tpu_torch as P
    m = _spectral_dd(P, "heat2d")
    J, m1, N = 2, 4, m._N
    rng = np.random.default_rng(9)
    seed = torch.tensor(rng.uniform(-1, 1, (J, 2, N)), **F32)
    tp = np.stack([m.t[[0, 4]] + 0.0 * k for k in range(m1)]) + np.arange(m1)[:, None] / 16
    tc = tp + 1.0 / 16
    tube = torch.zeros((J * m1 + 1, 2, N), **F32)
    out = tube[:J * m1].view(J, m1, 2, N)[:, 1:]
    m.relax_interval(seed, tp[:m1 - 1], tc[:m1 - 1], interval_major=True, out=out,
                     seed_out=tube[0:J * m1:m1])
    want = torch.zeros_like(tube)
    A, G = m._interval_tables_dev(1.0 / 16, m1 - 1)
    heat_kernels.dd_interval_affine_plain(
        dd.pair(seed), A, G, dd.pair(want[:J * m1].view(J, m1, 2, N)[:, 1:], None, 2), 0,
        dd.pair(want[0:J * m1:m1]))
    assert torch.equal(_bits(tube), _bits(want))


# ---------------------------------------------------------------------------
# K23: the store walk, the plan, pack, cached checks, the launch
# ---------------------------------------------------------------------------


def _k23_store_walk(phase, N):
    """The stores of csrc/dd_interval_affine.cu ``store_range`` over a row of
    N float32 elements whose element 0 lies ``phase`` elements past a
    32-byte sector boundary, every block of K23_C coefficients: (how many
    times each element is written, the element offsets of the 16-byte
    vector stores from a sector boundary, the elements each block stores
    alone)."""
    C, SA, VW, threads = heat_kernels.K23_C, 8, 4, heat_kernels.K23_C // 4
    writes, vectors, alone = np.zeros(N, dtype=np.int64), [], []
    for cb in range(0, N, C):
        nb = min(N - cb, C)
        e = (SA - (phase + cb) % SA) % SA
        alone.append(0)
        for t in range(threads):
            i = e + VW * t
            if i + VW <= nb:
                writes[cb + i:cb + i + VW] += 1
                vectors.append((phase + cb + i) % SA)
            else:
                for u in range(VW):
                    if i + u < nb:
                        writes[cb + i + u] += 1
                        alone[-1] += 1
            if t < e and t < nb:
                writes[cb + t] += 1
                alone[-1] += 1
    return writes, vectors, alone


@pytest.mark.parametrize("phase", range(8))
@pytest.mark.parametrize("N", [1, 5, 7, 8, 511, 512, 513, 1030, 16129])
def test_k23_store_walk_writes_every_element_once(phase, N):
    """Hi and lo rows at every 4-byte offset from a sector (a packed tube's
    rows of odd N step through all of them), N below and above a block's
    width and odd: every element of the row written exactly once, every
    vector store 16-byte aligned, and a block stores alone only the part of
    its range that lies in the sectors at its two ends (fewer than 8
    elements each)."""
    writes, vectors, alone = _k23_store_walk(phase, N)
    np.testing.assert_array_equal(writes, np.ones(N, dtype=np.int64))
    assert all(v in (0, 4) for v in vectors)
    assert all(n <= 14 for n in alone)


@pytest.mark.parametrize("J,R,N,seed_out,want", [
    (512, 31, 16129, True, (4, 32, 128, 128, 0)),     # dd_toms129's materialization
    (512, 1, 16129, False, (4, 32, 128, 128, 1)),     # its condensed C-step
    (512, 1, 16129, True, (4, 32, 128, 128, 0)),      # one row, the seeds copied
    (100, 31, 16129, True, (2, 32, 50, 50, 0)),
    (64, 1, 16129, False, (1, 32, 64, 64, 1)),
    (3, 4, 35, False, (1, 1, 3, 3, 0)),               # Heat1D, a small Heat2D
    (2 ** 20, 1, 1, False, (4, 1, 2 ** 18, 65535, 1))])  # more groups than the grid's y
def test_k23_plan(J, R, N, seed_out, want):
    """A block K23_C = 512 coefficients of a group of JB intervals; the
    seeds streamed where each is read once (R = 1, no seed_out); the
    largest JB of 4, 2, 1 that gives 8 blocks an SM (132 SMs), else 1; the
    grid's y at most 65535 (the kernel walks the rest)."""
    assert heat_kernels.dd_interval_affine_plan(J, R, N, seed_out, 132) == want


def test_k23_pack_layout():
    args = heat_kernels.dd_interval_affine_pack(3, (70, 700, 140, 7000), 2, 5, 10, 35,
                                                (4, 1, 3, 3, 0))
    assert list(args) == [3, *[0] * 10, 70, 700, 140, 7000, 2, 5, 10, 35, 4, 1, 3, 3, 0]


def _k23_ops(J=3, R=2, N=37, T=4, seed=1, with_seed_out=True):
    """Packed seeds, a packed tube view for out and seed_out, DD tables."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1, 1, (J, 2, N)), **F32)
    tube = torch.zeros((J * (R + 1), 2, N), **F32)
    out = tube.view(J, R + 1, 2, N)[:, 1:]
    A, G = dd.from_f64(rng.uniform(0, 1, (T, N))), dd.from_f64(rng.uniform(-1, 1, (T, N)))
    return (dd.pair(x), A, G, dd.pair(out, None, 2),
            dd.pair(tube[0::R + 1]) if with_seed_out else None, tube)


class _K23Launcher:
    """A numpy stand-in for ``pm_dd_interval_affine``: reads the packed
    array as csrc/dd_interval_affine.cu does and runs the plain version on
    views of the memory its pointers and strides name."""

    def __init__(self):
        self.calls = []

    def __call__(self, address, stream):
        a = list((ctypes.c_int64 * 24).from_address(address))
        self.calls.append((a, stream))
        x_sj, out_sj, out_sr, seed_sj, r0, R, J, N = a[11:19]
        assert tuple(a[19:24]) == heat_kernels.dd_interval_affine_plan(J, R, N, a[9] != 0, 132)

        def pair(i, shape, strides):
            hi, lo = (_view(a[i + c], shape, strides, torch.float32) for c in (0, 1))
            return None if hi is None else dd._raw(torch.from_numpy(hi), torch.from_numpy(lo))
        T = r0 + R
        heat_kernels.dd_interval_affine_plain(
            pair(1, (J, N), (x_sj, 1)), pair(3, (T, N), (N, 1)), pair(5, (T, N), (N, 1)),
            pair(7, (J, R, N), (out_sj, out_sr, 1)), r0, pair(9, (J, N), (seed_sj, 1)))
        return 0


@pytest.mark.parametrize("with_seed_out", [False, True])
@pytest.mark.parametrize("r0", [0, 2])
@pytest.mark.parametrize("R", [1, 2])
def test_k23_launch_the_checks_would_make(monkeypatch, with_seed_out, r0, R):
    """The launch the cached checks build for a CUDA call (R = 1 without
    seed_out: the seeds streamed), made by the wrapper with a numpy stand-in
    of the launcher: every pointer, stride and size of the packed array
    reaches the plain version, bit for bit with a direct call."""
    x, A, G, out, seed_out, tube = _k23_ops(R=R, with_seed_out=with_seed_out)
    pairs = [x, A, G, out] + ([seed_out] if with_seed_out else [])
    checked = heat_kernels._dd_interval_checked
    monkeypatch.setattr(heat_kernels, "_dd_launcher", lambda nm: nm)
    monkeypatch.setattr(heat_kernels._build, "sm_count", lambda index: 132)
    checked.cache_clear()
    try:
        facts = tuple(zip(_cuda_facts([p.hi for p in pairs], 2),
                          _cuda_facts([p.lo for p in pairs], 2)))
        on_cpu, (args, launcher, index) = checked(facts, r0)
        assert not on_cpu and launcher == "pm_dd_interval_affine" and index == 2
        fn = _K23Launcher()
        monkeypatch.setattr(heat_kernels, "_dd_interval_checked",
                            lambda f, r: (False, (args, fn, index)))
        monkeypatch.setattr(heat_kernels._build, "stream", lambda index: 9)
        want = torch.zeros_like(tube)
        w_out = dd.pair(want.view(3, R + 1, 2, 37)[:, 1:], None, 2)
        heat_kernels.dd_interval_affine_plain(x, A, G, w_out, r0,
                                              dd.pair(want[0::R + 1]) if with_seed_out else None)
        heat_kernels.dd_interval_affine(x, A, G, out, r0, seed_out)
        (packed, stream), = fn.calls
        assert stream == 9 and packed[0] == 2 and packed[23] == int(R == 1 and not with_seed_out)
        assert packed[1:11] == [p.data_ptr() for q in pairs for p in (q.hi, q.lo)] + \
            ([] if with_seed_out else [0, 0])
        assert torch.equal(_bits(tube), _bits(want))
    finally:
        checked.cache_clear()


def test_k23_repeat_call_hits_the_cache_and_new_strides_miss():
    x, A, G, out, seed_out, _ = _k23_ops()
    heat_kernels.dd_interval_affine(x, A, G, out, 0, seed_out)
    info = heat_kernels._dd_interval_checked.cache_info()
    heat_kernels.dd_interval_affine(x, A, G, out, 0, seed_out)
    after = heat_kernels._dd_interval_checked.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    other = dd.pair(torch.zeros((3, 2, 2, 37), **F32), None, 2)
    heat_kernels.dd_interval_affine(x, A, G, other, 0, seed_out)
    assert heat_kernels._dd_interval_checked.cache_info().misses == after.misses + 1


@pytest.mark.parametrize("change,match", [
    ("x float64", "float32 pairs"), ("out lo strides", "hi and lo"), ("r0", "outside"),
    ("out shape", "expected"), ("A strided", "contiguous"), ("seed_out shape", "shape of x"),
    ("not a pair", "DD pair")])
def test_k23_cached_checks_raise_on_every_call(change, match):
    """After a good call has cached its facts, a call whose dtype, strides,
    shape or rows changed raises, twice, with a good call between (the
    cache holds no failed check)."""
    x, A, G, out, seed_out, _ = _k23_ops()
    bad = dict(x=x, A=A, G=G, out=out, r0=0, seed_out=seed_out)
    if change == "x float64":
        bad["x"] = dd._raw(x.hi.double(), x.lo.double())
    elif change == "out lo strides":
        bad["out"] = dd._raw(out.hi, torch.zeros((3, 2, 37), **F32))
    elif change == "r0":
        bad["r0"] = 3
    elif change == "out shape":
        bad["out"] = dd.pair(torch.zeros((3, 2, 2, 36), **F32), None, 2)
    elif change == "A strided":
        bad["A"] = dd._raw(torch.zeros((37, 4), **F32).T, torch.zeros((37, 4), **F32).T)
    elif change == "seed_out shape":
        bad["seed_out"] = dd._raw(torch.zeros((2, 37), **F32), torch.zeros((2, 37), **F32))
    else:
        bad["x"] = x.hi
    for _ in range(2):
        heat_kernels.dd_interval_affine(x, A, G, out, 0, seed_out)
        with pytest.raises(ValueError, match=match):
            heat_kernels.dd_interval_affine(**bad)


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k13_plain_on_card_equals_plain_on_cpu(cuda, dtype):
    """The plain version at the level-0 F-relaxation's shape (32 chains of
    19 steps, + g) gives the CPU's bits on the card: its dt / 6 divides
    there too (a division by a Python scalar multiplies by the reciprocal
    on the card)."""
    make = _k13_inputs((BRUSS_NT - 1) // BRUSS_M, BRUSS_M - 1, BRUSS_M, True, dtype, 13)
    got = _k13_run(PLAIN, *make(cuda))
    want = _k13_run(PLAIN, *make("cpu"))
    assert torch.equal(got.cpu(), want)


K13_CARD_CASES = [
    # (J, L, with g, out rows off their 16-byte alignment)
    (32, 19, True, False),       # the Brusselator's level-0 F-relaxation
    (1, 32, False, False),       # its coarsest chain
    (512, 19, False, False),
    (32, 1, True, False),        # a C-relaxation step
    (1, 1, False, True),
    (5, 40, True, True),         # more steps than two chunks
    (33, 7, True, True),         # a second, partial warp
    (70, 4, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J,L,with_g,odd", K13_CARD_CASES)
def test_k13_on_card(cuda, dtype, J, L, with_g, odd):
    """The kernel against its plain version bit for bit, into the chain
    rows of a tube (odd: rows at an odd element offset, stored element by
    element), one launch a call; a second launch bit for bit."""
    seed, tp, tc, g = _k13_inputs(J, L, max(L, 1) + 1, with_g, dtype, J + L)(cuda)

    def run(ops):
        width = 2 * (L + 1) + int(odd)
        tube = torch.full((J * width + 1,), float("nan"), dtype=dtype, device=cuda)
        out = tube[int(odd):int(odd) + J * width].view(J, width)[:, 2:2 * L + 2].view(J, L, 2)
        ops.rk4_brusselator(seed, tp, tc, out, g)
        return tube

    before = runge_kutta.rk4_brusselator.launches
    got = run(DISPATCH)
    torch.cuda.synchronize()
    assert runge_kutta.rk4_brusselator.launches == before + 1
    want = run(PLAIN)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(run(DISPATCH)))


K23_CARD_CASES = [
    # (J, R, T, N, r0, packed, seed_out)
    (512, 31, 32, 16129, 0, True, True),      # dd_toms129's materialization
    (512, 1, 32, 16129, 31, True, False),     # its C-step
    (1, 1, 1, 16129, 0, True, True),          # J = 1, R = 1
    (3, 4, 5, 7, 1, True, True),              # N < 8, every row off its sector
    (5, 3, 3, 512, 0, False, True),           # one whole block, separate hi and lo
    (5, 3, 3, 513, 0, True, False),
    (20, 2, 4, 1031, 2, True, True),          # N odd, J not a multiple of JB
    (40, 1, 1, 3, 0, False, False),           # streamed seeds, N < 8
    (37, 1, 2, 1031, 1, True, False),         # streamed, J not a multiple of JB
    (17, 5, 6, 4099, 0, True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("J,R,T,N,r0,packed,with_seed_out", K23_CARD_CASES)
def test_k23_on_card(cuda, J, R, T, N, r0, packed, with_seed_out):
    """The kernel against its plain version bit for bit in hi and lo, into
    the solver's packed tube rows (an odd N puts the hi and lo rows at other
    sector offsets) or separate hi and lo tensors, the seeds copied to the
    C-rows when asked, one launch a call; a second launch bit for bit."""
    rng = np.random.default_rng(J + R + N)
    x = torch.tensor(rng.uniform(-1, 1, (J, 2, N)), dtype=torch.float32, device=cuda)
    A = dd.from_f64(rng.uniform(0, 1, (T, N)), cuda)
    G = dd.from_f64(rng.uniform(-1, 1, (T, N)), cuda)

    def run(ops):
        if packed:
            tube = torch.full((J * (R + 1) + 1, 2, N), float("nan"), dtype=torch.float32,
                              device=cuda)
            out = dd.pair(tube[1:].view(J, R + 1, 2, N)[:, 1:], ops, 2)
            seed_out = dd.pair(tube[1::R + 1], ops) if with_seed_out else None
            ops.dd_interval_affine(dd.pair(x, ops), A, G, out, r0, seed_out)
            return tube
        buf = torch.full((4, J, R + 1, N), float("nan"), dtype=torch.float32, device=cuda)
        out = dd._raw(buf[0, :, 1:], buf[1, :, 1:], ops)
        seed_out = dd._raw(buf[2, :, 0], buf[3, :, 0], ops) if with_seed_out else None
        ops.dd_interval_affine(dd._raw(x[:, 0], x[:, 1], ops), A, G, out, r0, seed_out)
        return buf

    before = heat_kernels.dd_interval_affine.launches
    got = run(DISPATCH)
    torch.cuda.synchronize()
    assert heat_kernels.dd_interval_affine.launches == before + 1
    want = run(PLAIN)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(run(DISPATCH)))
