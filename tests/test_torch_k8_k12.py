"""K8 ``affine_prefix`` (CUDA C++, ``csrc/affine_prefix.cu``: a wide regime,
a thread a column through a cp.async ring, and a narrow one, a block-wide
scan over time) and K12 ``dopri45_arenstorf`` (``csrc/dopri45_arenstorf.cu``,
a thread a lane), both on the one-call launch path, and the repairs of the
plain versions beside them: the correctly rounded square root
(``ops/ieee_sqrt.py``) and the DOPRI5 initial step's division.

On the CPU: K8's plan and packed arguments, the plain prefix against the
JAX package's ``affine_prefix_states``, numpy stand-ins of both launchers
(K8's models the kernel's segments, warp scans and carry-ins thread by
thread) reached through the cached checks, ``sqrt_rn`` bit for bit with
numpy's root, the plain ``_initial_step`` against the JAX package's.  On
the card (``cuda``): K8 against its plain version in each regime, K12 on
``chip_smoke.py``'s four cases with the plain version's attempt counts,
the card's plain ``_initial_step`` and ``sqrt_rn`` bit for bit with the
CPU's.  Run those with

    python -m pytest tests/test_torch_k8_k12.py -q -m cuda --noconftest

(the JAX package is imported by the tests that compare with it, never by
the ``cuda`` ones).

Tolerances.  K8 composes its steps in another order than the plain
doubling scan, and the plain scan in another order than JAX's associative
scan: held at 1e-13 (float64) and 1e-5 (float32) of the largest state, the
kernel tolerance of ``chip_smoke.py``; a second launch gives the same bits.
K12 contracts its stages into FMAs: held at ``chip_smoke.KERNEL_RTOL_BY_NAME``
(1e-12 float64, 1e-2 float32).  ``sqrt_rn`` is correctly rounded: bit for
bit with ``np.sqrt``.  The plain initial step's ``0.01 / max(d1, d2)``
equals JAX's bit for bit; the whole step, given the same right-hand side,
is held at 2 ulp: its ``** 0.2`` is PyTorch's pow against XLA's, which
differ in the last bit or two.
"""

import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, prefix, runge_kutta
from pymgrit_tpu_torch.ops.ieee_sqrt import sqrt_rn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
_CT = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float}
ARENSTORF_Y0 = [0.994, 0.0, 0.0, -2.00158510637908]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _close(got, want, dtype):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= RTOL[dtype] * max(scale, 1e-300)


# ---------------------------------------------------------------------------
# C7: the correctly rounded square root
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sqrt_rn_is_numpy_sqrt(dtype):
    """10^5 seeded values: uniform on [1e-3, 10], log-uniform over most of
    the exponent range, subnormals, random bit patterns, and the special
    values; every result bit for bit with ``np.sqrt`` (IEEE 754)."""
    rng = np.random.default_rng(7)
    info = np.finfo(dtype)
    span = 700 if dtype == np.float64 else 87
    itype = np.int64 if dtype == np.float64 else np.int32
    top = 0x7FF0000000000000 if dtype == np.float64 else 0x7F800000
    x = np.concatenate([
        rng.uniform(1e-3, 10, 40000), np.exp(rng.uniform(-span, span, 30000)),
        rng.uniform(0, 1, 10000) * info.tiny,
        rng.integers(0, top, 20000, dtype=np.int64).astype(itype).view(dtype).astype(np.float64),
        [0.0, -0.0, np.inf, -1.0, np.nan, float(info.max), float(info.smallest_subnormal), 2.0],
    ]).astype(dtype)
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = sqrt_rn(torch.from_numpy(x)).numpy()
    same = (got.view(itype) == want.view(itype)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:5], got[~same][:5], want[~same][:5])


def test_sqrt_rn_under_vmap():
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 5, (4, 9)))
    assert torch.equal(torch.vmap(sqrt_rn)(x), sqrt_rn(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sqrt_rn_on_card_equals_cpu(cuda, dtype):
    x = torch.from_numpy(np.exp(np.random.default_rng(5).uniform(-80, 80, 100000))).to(dtype)
    assert torch.equal(_bits(sqrt_rn(x.to(cuda)).cpu()), _bits(sqrt_rn(x)))


# ---------------------------------------------------------------------------
# C6: the plain DOPRI5 initial step
# ---------------------------------------------------------------------------


def _orbit_states(n=161):
    """Arenstorf states along the orbit (a plain march of n - 1 adaptive
    steps over one period), their times and right-hand sides."""
    f = runge_kutta.arenstorf_f()
    ts = np.linspace(0, chip_smoke.T_ORBIT, n)
    ys = [torch.tensor([ARENSTORF_Y0], dtype=torch.float64)]
    for k in range(n - 1):
        ys.append(runge_kutta.dopri45_integrate(f, ys[-1], torch.tensor(ts[k:k + 1]),
                                                torch.tensor(ts[k + 1:k + 2]))[0])
    y = torch.cat(ys)
    t0 = torch.as_tensor(ts)
    return f, t0, y, f(t0, y)


def test_initial_step_divides_as_jax():
    """``0.01 / max(d1, d2)`` of the plain initial step equals the JAX
    package's division bit for bit on the d1, d2 of orbit states (the
    reciprocal-times-0.01 PyTorch makes of ``0.01 / tensor`` does not);
    the whole plain step, with JAX's step given the port's right-hand
    side on the same batch (a ``pure_callback``), within 2 ulp: the two
    ``** 0.2`` are PyTorch's and XLA's pow."""
    import jax
    import jax.numpy as jnp
    from pymgrit_tpu.ops import runge_kutta as jrk
    f, t0, y, f0 = _orbit_states()
    rtol, atol = 1e-3, 1e-6
    scale = atol + torch.abs(y) * rtol
    d1 = runge_kutta._rms(f0 / scale)
    h0 = 0.01 * runge_kutta._rms(y / scale) / d1
    d2 = runge_kutta._rms((f(t0 + h0, y + h0[:, None] * f0) - f0) / scale) / h0
    d = torch.maximum(d1, d2)
    want = np.asarray(0.01 / jnp.maximum(jnp.asarray(d1.numpy()), jnp.asarray(d2.numpy())))
    assert np.array_equal(runge_kutta._hundredth_over(d).numpy().view(np.int64),
                          want.view(np.int64))
    assert not np.array_equal((0.01 / d).numpy(), want)   # the gate bites

    def f_shared(t, yy):
        return jax.pure_callback(
            lambda tt, v: f(torch.as_tensor(np.asarray(tt)), torch.as_tensor(np.asarray(v))).numpy(),
            jax.ShapeDtypeStruct(yy.shape, yy.dtype), t, yy, vmap_method="broadcast_all")

    step = jax.vmap(lambda t, yy, ff: jrk._initial_step(f_shared, t, yy, ff, rtol, atol))
    h_jax = np.asarray(step(jnp.asarray(t0.numpy()), jnp.asarray(y.numpy()),
                            jnp.asarray(f0.numpy())))
    h = runge_kutta._initial_step(f, t0, y, f0, rtol, atol).numpy()
    ulps = np.abs(h.view(np.int64) - h_jax.view(np.int64))
    assert ulps.max() <= 2, (ulps.max(), int((ulps > 0).sum()))


@pytest.mark.cuda
def test_initial_step_on_card_equals_cpu(cuda):
    """The card's plain initial step, ``0.01 / max(d1, d2)`` bit for bit
    with the CPU's on the same d1, d2; the whole step (PyTorch's CUDA pow
    in the right-hand side and in ``** 0.2`` against its CPU pow) within 2
    ulp where the right-hand sides agree bit for bit, and equal where the
    pows do."""
    f, t0, y, f0 = _orbit_states()
    d = torch.from_numpy(np.exp(np.random.default_rng(2).uniform(-5, 9, 4096)))
    assert torch.equal(_bits(runge_kutta._hundredth_over(d.to(cuda)).cpu()),
                       _bits(runge_kutta._hundredth_over(d)))
    h_cpu = runge_kutta._initial_step(f, t0, y, f0, 1e-3, 1e-6)
    h_card = runge_kutta._initial_step(f, t0.to(cuda), y.to(cuda), f0.to(cuda), 1e-3, 1e-6).cpu()
    rhs_same = torch.equal(_bits(f(t0.to(cuda), y.to(cuda)).cpu()), _bits(f(t0, y)))
    ulps = (_bits(h_card) - _bits(h_cpu)).abs()
    print(f"initial step: card vs CPU, {int((ulps > 0).sum())} of {ulps.numel()} lanes differ, "
          f"at most {int(ulps.max())} ulp; right-hand sides bit for bit: {rhs_same}")
    if rhs_same:
        assert int(ulps.max()) <= 2


# ---------------------------------------------------------------------------
# K8: plan, packed arguments, the plain version against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,N,streamed,es,want", [
    (2048, 16129, 1, 8, ("wide", 128, 128, 1, 2048, 127)),   # the TOMS width
    (16384, 1, 2, 8, ("narrow", 1024, 1, 1024, 8, 1)),       # Dahlquist: 2 tiles
    (16384, 1, 2, 4, ("narrow", 1024, 1, 1024, 16, 1)),      # ... float32: 1 tile
    (2048, 999, 1, 8, ("narrow", 1024, 8, 128, 16, 125)),    # a middle width
    (4096, 300, 2, 8, ("narrow", 1024, 4, 256, 8, 75)),      # one wave: W = 4
    (1, 1, 0, 8, ("narrow", 1024, 1, 1024, 1, 1)),
    (1, 16129, 3, 8, ("wide", 128, 128, 1, 1, 127)),
])
def test_k8_plan(n, N, streamed, es, want):
    assert prefix.affine_prefix_plan(n, N, 132, streamed, es) == want


def test_k8_plans_cover_every_shape():
    """Every n >= 1 and N >= 1 on 132 SMs, 0-3 streamed operands, float64
    and float32: the launcher's own checks of csrc/affine_prefix.cu
    ``launch`` hold (wide: 128 columns a block, the grid covers N; narrow:
    W a power of two up to 32, one wave where W < 32, S W = 1024, the grid
    covers N, the tile buffers within the shared memory; the tiles cover n,
    as few as fit)."""
    for n in (1, 2, 3, 31, 1024, 1025, 16383, 16384, 16385, 10 ** 6):
        for N in (1, 2, 7, 33, 999, 3167, 12544, 12545, 16129, 50000):
            for streamed in range(4):
                for es in (8, 4):
                    regime, threads, W, S, R, grid = prefix.affine_prefix_plan(n, N, 132,
                                                                               streamed, es)
                    if regime == "wide":
                        assert (threads, W, S, R, grid) == (128, 128, 1, n, -(-N // 128))
                        assert grid >= 99
                        continue
                    assert threads == 1024 and W & (W - 1) == 0 and 1 <= W <= 32
                    assert S * W == 1024 and R >= 1 and grid == -(-N // W)
                    assert grid <= 132 or W == 32
                    bufs = max(1, streamed)
                    assert bufs * prefix._tile_elements(R) * es <= prefix.K8_NARROW_SMEM
                    tiles = -(-n // (S * R))
                    assert tiles == 1 or bufs * prefix._tile_elements(
                        -(-n // ((tiles - 1) * S))) * es > prefix.K8_NARROW_SMEM


def test_k8_pack_layout():
    plan = prefix.affine_prefix_plan(2048, 999, 132)
    args = prefix.affine_prefix_pack(3, (0, 0, 999, 999), 2048, 999, plan)
    assert list(args) == [3, 0, 0, 0, 0, 0, 0, 0, 999, 999, 2048, 999, 1, 8, 128, 16, 125]


def _k8_inputs(n, N, dtype, A_rows, b_rows, with_g, seed):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype)

    A = t(rng.uniform(0.5, 1.0, (n if A_rows else 1, N))).expand(n, N)
    b = t(rng.uniform(-1, 1, (n if b_rows else 1, N))).expand(n, N)
    tube = t(rng.uniform(-1, 1, (n + 1, N)))
    g = t(rng.uniform(-0.1, 0.1, (n + 1, N)))[1:] if with_g else None
    return A, b, tube, g


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("A_rows,b_rows,with_g", [(True, False, True), (False, False, False),
                                                  (True, True, True), (False, True, False)])
def test_k8_plain_matches_jax(dtype, A_rows, b_rows, with_g):
    """The plain prefix against the JAX package's ``affine_prefix_states``
    with c = b (+ g): A and b with rows or broadcast (row stride 0), with
    and without g, the state a tube's row 0 and out its rows 1..n."""
    import jax.numpy as jnp
    from pymgrit_tpu.ops.prefix import affine_prefix_states
    n, N = 37, 5
    A, b, tube, g = _k8_inputs(n, N, dtype, A_rows, b_rows, with_g, 11)
    out = tube.clone()
    prefix.affine_prefix_plain(A, b, tube[0], out[1:], g)
    c = b if g is None else b + g
    want = np.asarray(affine_prefix_states(jnp.asarray(A.numpy()), jnp.asarray(c.numpy()),
                                           jnp.asarray(tube[0].numpy())))
    _close(out[1:], torch.from_numpy(want), dtype)
    assert torch.equal(out[0], tube[0])


# ---------------------------------------------------------------------------
# K8: the launch the cached checks build, run by a numpy stand-in
# ---------------------------------------------------------------------------


def _view(ptr, shape, strides, dtype):
    if ptr == 0:
        return None
    span = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = np.ctypeslib.as_array((_CT[dtype] * span).from_address(ptr))
    es = buf.itemsize
    return np.lib.stride_tricks.as_strided(buf, shape, [st * es for st in strides])


def _shift(v, d, lane, fill):
    """__shfl_up_sync(v, d) over threads grouped in warps of 32 (lanes below
    d keep ``fill``)."""
    out = np.full_like(v, fill)
    out[d:] = v[:-d]
    out[lane < d] = fill
    return out


def _k8_narrow_tile(A, c, carry, out, cols, W, R, rows):
    """One tile of a narrow block of csrc/affine_prefix.cu, thread by
    thread: thread t holds column t % W and the tile's rows (t / W) R ..
    (t / W) R + R - 1 (A, c, out: the tile's rows; carry: the columns' x
    before the tile, updated); the segment maps composed, the shuffle scan
    within each warp, the warps' aggregates scanned per column, the
    carry-in, the replay (every operation rounded once: the kernel
    contracts them into FMAs, so the two agree to rounding)."""
    t = np.arange(1024)
    w, seg, lane, warp = t % W, t // W, t & 31, t >> 5
    col = cols[w]
    valid = col >= 0
    P, C = np.ones(1024), np.zeros(1024)
    for u in range(R):
        r = seg * R + u
        live = valid & (r < rows)
        a = np.where(live, A[np.minimum(r, rows - 1), np.maximum(col, 0)], 1.0)
        cc = np.where(live, c[np.minimum(r, rows - 1), np.maximum(col, 0)], 0.0)
        P, C = a * P, a * C + cc
    d = W
    while d < 32:
        Pe, Ce = _shift(P, d, lane, 1.0), _shift(C, d, lane, 0.0)
        up = lane >= d
        C, P = np.where(up, P * Ce + C, C), np.where(up, P * Pe, P)
        d *= 2
    aggP, aggC = np.ones((32, 32)), np.zeros((32, 32))
    last = lane >= 32 - W
    aggP[warp[last], w[last]], aggC[warp[last], w[last]] = P[last], C[last]
    Pw, Cw = _shift(P, W, lane, 1.0), _shift(C, W, lane, 0.0)
    for v in range(W):
        Pa, Ca = aggP[:, v].copy(), aggC[:, v].copy()
        li = np.arange(32)
        for dd in (1, 2, 4, 8, 16):
            Pe, Ce = _shift(Pa, dd, li, 1.0), _shift(Ca, dd, li, 0.0)
            up = li >= dd
            Ca, Pa = np.where(up, Pa * Ce + Ca, Ca), np.where(up, Pa * Pe, Pa)
        aggP[:, v], aggC[:, v] = _shift(Pa, 1, li, 1.0), _shift(Ca, 1, li, 0.0)
    new_carry = carry.copy()
    for k in np.nonzero(valid)[0]:
        j = col[k]
        x = Pw[k] * (aggP[warp[k], w[k]] * carry[w[k]] + aggC[warp[k], w[k]]) + Cw[k]
        for r in range(seg[k] * R, min((seg[k] + 1) * R, rows)):
            x = A[r, j] * x + c[r, j]
            out[r, j] = x
            if r == rows - 1:
                new_carry[w[k]] = x
    carry[:] = new_carry


class _K8Launcher:
    """A numpy stand-in for ``pm_affine_prefix_f64`` / ``_f32``: reads the
    packed array as csrc/affine_prefix.cu ``launch`` does (and checks the
    plan as it does), then runs the regime on views of the memory its
    pointers and strides name: wide, each column's rows in order; narrow,
    ``_k8_narrow_tile`` for each tile of each block."""

    def __init__(self, dtype):
        self.dtype, self.calls = dtype, []

    def __call__(self, address, stream):
        a = list((ctypes.c_int64 * 17).from_address(address))
        self.calls.append((a, stream))
        n, N, narrow, W, S, R, grid = a[10:17]
        d = self.dtype
        A = _view(a[1], (n, N), (a[6], 1), d).astype(np.float64)
        B = _view(a[2], (n, N), (a[7], 1), d).astype(np.float64)
        g = _view(a[3], (n, N), (a[8], 1), d)
        x0 = _view(a[4], (N,), (1,), d).astype(np.float64)
        out = _view(a[5], (n, N), (a[9], 1), d)
        c = B if g is None else B + g
        if not narrow:
            assert (W, S, R, grid) == (128, 1, n, -(-N // 128))
            x = x0.copy()
            for r in range(n):
                x = A[r] * x + c[r]
                out[r] = x
            return 0
        assert S * W == 1024 and grid == -(-N // W)
        TR = S * R
        for blk in range(grid):
            cols = blk * W + np.arange(W)
            carry = x0[np.minimum(cols, N - 1)]
            for r0 in range(0, n, TR):
                rows = min(TR, n - r0)
                _k8_narrow_tile(A[r0:r0 + rows], c[r0:r0 + rows], carry, out[r0:r0 + rows],
                                np.where(cols < N, cols, -1), W, R, rows)
        return 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,N,sms,A_rows,b_rows,with_g", [
    (40, 300, 2, True, False, True),       # wide: 3 blocks of 128 columns
    (5000, 1, 132, True, False, True),     # narrow, Dahlquist's layout: W = 1, R = 5
    (25000, 1, 132, True, True, True),     # narrow, W = 1, 4 tiles, the last partial
    (2000, 21, 4, False, True, False),     # narrow, W = 8, the last block partial
    (33, 70, 4, True, True, True),         # narrow, W = 32, R = 2
])
def test_k8_launch_the_checks_would_make(monkeypatch, dtype, n, N, sms, A_rows, b_rows, with_g):
    """The launch the cached checks build for a CUDA call, made by the
    wrapper with the numpy stand-in of the launcher: every pointer, stride
    and plan slot reaches the kernel's walk; out is a tube's rows 1..n, x0
    its row 0; held against the plain version at the kernel tolerance."""
    A, b, tube, g = _k8_inputs(n, N, dtype, A_rows, b_rows, with_g, n + N)
    checked = prefix._prefix_checked
    monkeypatch.setattr(prefix, "_launcher", lambda nm, d: (nm, d))
    monkeypatch.setattr(prefix._build, "sm_count", lambda index: sms)
    checked.cache_clear()
    try:
        out = tube.clone()
        ops = (A, b, tube[0], out[1:]) if g is None else (A, b, tube[0], out[1:], g)
        facts = tuple((t.dtype, torch.device("cuda", 1), t.shape, t.stride()) for t in ops)
        on_cpu, (args, launcher, index) = checked(facts)
        assert not on_cpu and launcher == ("pm_affine_prefix", dtype) and index == 1
        strides = (A.stride(0), b.stride(0), 0 if g is None else g.stride(0), out.stride(0))
        plan = prefix.affine_prefix_plan(n, N, sms, A_rows + b_rows + with_g,
                                         tube.element_size())
        assert args == prefix.affine_prefix_pack(1, strides, n, N, plan)
        fn = _K8Launcher(dtype)
        monkeypatch.setattr(prefix, "_prefix_checked", lambda f: (False, (args, fn, index)))
        monkeypatch.setattr(prefix._build, "stream", lambda index: 5)
        launches = prefix.affine_prefix.launches
        prefix.affine_prefix(A, b, tube[0], out[1:], g)
        assert prefix.affine_prefix.launches == launches + 1
        (packed, stream), = fn.calls
        assert stream == 5 and packed[:6] == [1, A.data_ptr(), b.data_ptr(),
                                              0 if g is None else g.data_ptr(),
                                              tube[0].data_ptr(), out[1:].data_ptr()]
        want = tube.clone()
        prefix.affine_prefix_plain(A, b, tube[0], want[1:], g)
        _close(out, want, dtype)
    finally:
        checked.cache_clear()


def test_k8_repeat_call_hits_the_cache_and_new_strides_miss():
    A, b, tube, g = _k8_inputs(9, 4, torch.float64, True, False, True, 1)
    out = tube.clone()
    prefix.affine_prefix(A, b, tube[0], out[1:], g)
    info = prefix._prefix_checked.cache_info()
    prefix.affine_prefix(A, b, tube[0], out[1:], g)
    after = prefix._prefix_checked.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    prefix.affine_prefix(A, b, tube[0], out[1:], None)
    assert prefix._prefix_checked.cache_info().misses == after.misses + 1


# ---------------------------------------------------------------------------
# K12: packed arguments and the launch the cached checks build
# ---------------------------------------------------------------------------


def test_k12_pack_layout():
    args = runge_kutta.dopri45_arenstorf_pack(2, (4, 36, 4, 40, 4), 250, 8, 10000, 1e-3, 1e-6,
                                              0.012277471)
    bits = [runge_kutta._double_bits(v) for v in (1e-3, 1e-6, 0.012277471)]
    assert list(args) == [2, 0, 0, 0, 0, 0, 0, 4, 36, 4, 40, 4, 250, 8, 10000, *bits]


class _K12Launcher:
    """A numpy stand-in for ``pm_dopri45_arenstorf_f64`` / ``_f32``: reads
    the packed array as csrc/dopri45_arenstorf.cu ``launch`` does and runs
    the plain version on tensors over the memory its pointers and strides
    name."""

    def __init__(self, dtype):
        self.dtype, self.calls = dtype, []

    def __call__(self, address, stream):
        a = list((ctypes.c_int64 * 18).from_address(address))
        self.calls.append((a, stream))
        s_sj, o_sj, o_sk, g_sj, g_sk, J, L, max_steps = a[7:15]
        rtol, atol, aa = (np.array(a[15:18], dtype=np.int64).view(np.float64)).tolist()
        d = self.dtype

        def t(ptr, shape, strides):
            v = _view(ptr, shape, strides, d)
            return None if v is None else torch.from_numpy(v)

        att = None
        if a[6]:
            att = torch.from_numpy(np.ctypeslib.as_array((ctypes.c_int32 * (L * J)).from_address(
                a[6])).reshape(L, J))
        runge_kutta.dopri45_arenstorf_plain(
            t(a[1], (J, 4), (s_sj, 1)), t(a[2], (L, J), (J, 1)), t(a[3], (L, J), (J, 1)),
            t(a[4], (J, L, 4), (o_sj, o_sk, 1)), t(a[5], (J, L, 4), (g_sj, g_sk, 1)), rtol, atol,
            aa, max_steps, att)
        return 0


def _k12_inputs(J, L, dtype, with_g):
    rng = np.random.default_rng(J + L)
    seed = torch.tensor([ARENSTORF_Y0] * J, dtype=dtype) * (1 + 1e-3 * torch.from_numpy(
        rng.standard_normal((J, 4))).to(dtype))
    ts = np.linspace(0, 0.5, L + 1)
    tp = torch.tensor(np.stack([ts[:-1]] * J, 1), dtype=dtype)
    tc = torch.tensor(np.stack([ts[1:]] * J, 1), dtype=dtype)
    g = torch.from_numpy(rng.uniform(-1e-4, 1e-4, (J, L, 4))).to(dtype) if with_g else None
    return seed, tp, tc, g


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("with_g,with_att", [(False, True), (True, False)])
def test_k12_launch_the_checks_would_make(monkeypatch, dtype, with_g, with_att):
    """The launch the cached checks build for a CUDA call, made by the
    wrapper with a numpy stand-in of the launcher: every pointer, stride and
    scalar reaches the plain version, bit for bit; out a tube's rows 1..L."""
    J, L = 5, 3
    seed, tp, tc, g = _k12_inputs(J, L, dtype, with_g)
    seed = torch.cat([seed, seed], 1)[:, 2:6]       # a lane stride of 8
    rtol, atol, a = 2e-3, 3e-6, 0.0125
    checked = runge_kutta._dopri_checked
    monkeypatch.setattr(runge_kutta, "_launcher", lambda nm, d: (nm, d))
    checked.cache_clear()
    try:
        out = torch.full((J, L + 1, 4), float("nan"), dtype=dtype)[:, 1:]
        att = torch.zeros((L, J), dtype=torch.int32) if with_att else None
        facts = tuple(None if x is None else (x.dtype, torch.device("cuda", 1), x.shape,
                                              x.stride())
                      for x in (seed, tp, tc, out, g, att))
        on_cpu, (args, launcher, index) = checked(facts, rtol, atol, a, 500)
        assert not on_cpu and launcher == ("pm_dopri45_arenstorf", dtype) and index == 1
        fn = _K12Launcher(dtype)
        monkeypatch.setattr(runge_kutta, "_dopri_checked", lambda *x: (False, (args, fn, index)))
        monkeypatch.setattr(runge_kutta._build, "stream", lambda index: 3)
        launches = runge_kutta.dopri45_arenstorf.launches
        runge_kutta.dopri45_arenstorf(seed, tp, tc, out, g, rtol, atol, a, 500, att)
        assert runge_kutta.dopri45_arenstorf.launches == launches + 1
        (packed, stream), = fn.calls
        assert stream == 3 and packed[:7] == [
            1, seed.data_ptr(), tp.data_ptr(), tc.data_ptr(), out.data_ptr(),
            0 if g is None else g.data_ptr(), 0 if att is None else att.data_ptr()]
        want_att = torch.zeros((L, J), dtype=torch.int32)
        want = runge_kutta.dopri45_arenstorf_plain(seed, tp, tc, torch.empty_like(out), g, rtol,
                                                   atol, a, 500, want_att)
        assert torch.equal(_bits(out), _bits(want))
        if with_att:
            assert torch.equal(att, want_att) and int(att.min()) > 0
    finally:
        checked.cache_clear()


def test_k12_repeat_call_hits_the_cache():
    seed, tp, tc, g = _k12_inputs(2, 2, torch.float64, True)
    out = torch.empty((2, 2, 4), dtype=torch.float64)
    runge_kutta.dopri45_arenstorf(seed, tp, tc, out, g)
    info = runge_kutta._dopri_checked.cache_info()
    runge_kutta.dopri45_arenstorf(seed, tp, tc, out, g)
    assert runge_kutta._dopri_checked.cache_info().hits == info.hits + 1


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,N,A_rows,b_rows,with_g", [
    (2048, 16129, False, False, True),     # wide: the TOMS width
    (517, 12673, True, True, True),        # wide, odd N, every operand with rows
    (300, 13001, False, True, False),      # wide, no g
    (16384, 1, True, False, True),         # narrow: Dahlquist's column
    (2048, 999, False, False, True),       # narrow, 8 columns a block
    (1, 37, True, True, False),            # one row
    (5000, 301, True, False, False),       # narrow, no g, odd N
])
def test_k8_on_card(cuda, dtype, n, N, A_rows, b_rows, with_g):
    """K8 against its plain version in both regimes (out a tube's rows
    1..n, x0 its row 0), a second launch bit for bit, one launch a call."""
    A, b, tube, g = (None if x is None else x.to(cuda)
                     for x in _k8_inputs(n, N, dtype, A_rows, b_rows, with_g, n + 7))

    def run(ops):
        out = tube.clone()
        ops.affine_prefix(A, b, tube[0], out[1:], g)
        return out

    launches = prefix.affine_prefix.launches
    got = run(DISPATCH)
    torch.cuda.synchronize()
    assert prefix.affine_prefix.launches == launches + 1
    _close(got, run(PLAIN), dtype)
    assert torch.equal(_bits(got), _bits(run(DISPATCH)))


def _k12_cases(dtype, dev):
    stash = {}
    cases = chip_smoke.nonlinear_cases(dtype, dev, np.random.default_rng(chip_smoke.SEED), stash)
    return [(case, run, stash[("attempts", kernel, case)]) for kernel, case, run in cases
            if kernel == "dopri45_arenstorf"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k12_on_card_chip_smoke_cases(cuda, dtype):
    """K12 on ``chip_smoke.py``'s four cases (the level-0 F-relaxation J =
    250 L = 8, the coarsest chain, J = 512 and J = 1) against its plain
    version at the kernel tolerance, with the plain version's attempt
    counts (float64), a second launch bit for bit."""
    tol = chip_smoke.KERNEL_RTOL_BY_NAME["dopri45_arenstorf"][str(dtype).split(".")[-1]]
    cases = _k12_cases(dtype, cuda)
    assert len(cases) == 4
    for case, run, att in cases:
        got = run(DISPATCH)
        want = run(PLAIN)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        same = torch.equal(att[True], att[False])
        print(f"K12 {case} {dtype}: rel {rel:.3e}, attempts kernel {int(att[True].sum())} plain "
              f"{int(att[False].sum())} equal {same}")
        assert rel <= tol, (case, rel)
        assert same or dtype == torch.float32, case
        assert torch.equal(_bits(got), _bits(run(DISPATCH)))
