"""K20 ``sine_solve1d`` (its two products on the FP64 product tile,
``csrc/dmma_tile.cuh``) and K17 ``circulant_solve1d`` (a warp scan,
``csrc/circulant_solve1d.cu``), both on the one-call launch path: their
plain versions against the JAX package, a numpy model of K17's scan order
against the Fourier route, K20's product plans, both wrappers' cached
checks and packed arguments (read back by numpy stand-ins of the C
launchers), Heat1D's cached step sizes, and on the card the kernels
against their plain versions.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k17_k20.py -q -m cuda --noconftest

and the rest here with ``-m 'not cuda'`` (the JAX package is imported by
the tests that compare with it, never by the ``cuda`` ones).

Tolerances.  K20's products sum in the tile's order (DMMA's k4 groups, the
split's slices), the plain version in cuBLAS's or MKL's: they agree to
rounding, at ``KERNEL_RTOL`` of the largest entry (1e-13 float64, 1e-5
float32), and a second launch repeats the first bit for bit.  K17's scan
runs the recurrence in another order than the Fourier route: the same
tolerances.  The plain versions against the JAX package: 1e-12 of the
largest entry (both take length-n products or FFTs, rounded differently by
XLA and PyTorch).  The numpy model of K17's scan against the Fourier route:
1e-12.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, heat_kernels, periodic, product_tile
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis
from pymgrit_tpu_torch.ops.heat_kernels import fact

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
KERNEL_RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
JAX_RTOL = 1e-12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed, lo=-1.0, hi=1.0):
    a = np.random.default_rng(seed).uniform(lo, hi, shape)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _close(got, ref, rtol):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _cuda_facts(ops, index=0):
    """The facts of these tensors (None stays None) as if they lay on CUDA
    device ``index``."""
    dev = torch.device("cuda", index)
    return tuple(None if t is None else (t.dtype, dev, t.shape, t.stride()) for t in ops)


# ---------------------------------------------------------------------------
# K20: the plain modes against the JAX package
# ---------------------------------------------------------------------------


def _heat1d(mod, nx=33, nt=17):
    import jax.numpy as jnp
    xp = jnp if mod.__name__ == "pymgrit_tpu" else np
    kw = {} if mod.__name__ == "pymgrit_tpu" else {"device": "cpu"}
    return mod.Heat1D(x_start=0, x_end=1, nx=nx, a=1.0, init_cond=lambda x: np.sin(np.pi * x),
                      rhs=lambda x, t: -xp.sin(xp.pi * x) * (xp.sin(t) - xp.cos(t)),
                      t_interval=np.linspace(0, 1, nt), basis="physical", **kw)


@pytest.mark.parametrize("layout", ["rows", "in place", "blocks"])
def test_k20_plain_be_matches_jax_step_batched(layout):
    """K20's BE mode (the plain version, through the wrapper on the CPU)
    against JAX's physical ``Heat1D.step_batched``: per-lane dt, a rhs row
    per lane, x every second row of a tube; out a fresh (B, n) tensor, x
    itself (in place), or the strided (H, D, n) view of relax_interval's
    (interval, row) layout."""
    import jax.numpy as jnp
    import pymgrit_tpu as J
    import pymgrit_tpu_torch as P
    mj, mp = _heat1d(J), _heat1d(P)
    B, n = 6, mp.nx
    tube = _rand((2 * B, n), torch.float64, "cpu", 1)
    x = tube[::2]
    tp = mp.t[[0, 1, 3, 4, 8, 9]]
    tc = mp.t[[1, 3, 4, 8, 9, 16]]
    ref = np.asarray(mj.step_batched(jnp.asarray(x.numpy()), jnp.asarray(tp), jnp.asarray(tc)))
    dt = torch.as_tensor(tc - tp)
    rhs = mp._rhs_rows(tc)
    if layout == "rows":
        out = torch.empty((B, n), **F64)
        got = heat_kernels.sine_solve1d(x, out, mp.S, mp.lam, dt, rhs)
    elif layout == "in place":
        got = heat_kernels.sine_solve1d(x, x, mp.S, mp.lam, dt, rhs)
    else:
        base = torch.zeros((3, 4, n), **F64)           # (R, J, n) rows; out (J, R)[:, 1:3]
        out = base.transpose(0, 1)[:3, 1:3]
        heat_kernels.sine_solve1d(x, out, mp.S, mp.lam, dt, rhs)
        got = out.reshape(B, n)
    _close(got.numpy(), ref, JAX_RTOL)


@pytest.mark.parametrize("only_last,interval_major", [(False, False), (False, True),
                                                      (True, False)])
def test_k20_plain_transforms_match_jax_relax_interval(only_last, interval_major):
    """K20's transform mode on both sides of K1 in the physical
    ``relax_interval`` (the back transform into the (rows, J) layout's
    transposed view, an (H, D, n) out) against JAX's."""
    import jax.numpy as jnp
    import pymgrit_tpu as J
    import pymgrit_tpu_torch as P

    def build(mod):
        kw = {} if mod is J else {"device": "cpu"}
        return mod.Heat1D(x_start=0, x_end=1, nx=33, a=1.0, init_cond=lambda x: np.sin(np.pi * x),
                          rhs=lambda x, t: x * (1 - x) + 0 * t, t_interval=np.linspace(0, 1, 17),
                          basis="physical", **kw)

    mj, mp = build(J), build(P)
    seed = np.random.default_rng(2).standard_normal((4, mp.nx))
    starts = 3 * np.arange(4)                      # four intervals of m = 3 (two F-steps)
    tp = mp.t[starts[None] + np.arange(2)[:, None]]
    tc = mp.t[starts[None] + np.arange(1, 3)[:, None]]
    ref = np.asarray(mj.relax_interval(jnp.asarray(seed), tp, tc, only_last, interval_major))
    got = mp.relax_interval(torch.as_tensor(seed), tp, tc, only_last, interval_major)
    _close(got.numpy(), ref, JAX_RTOL)


@pytest.mark.parametrize("cls", ["Heat1DBDF1", "Heat1DBDF2"])
def test_k20_plain_bdf_steps_match_jax(cls):
    """K20's BE mode twice (BDF1) and BDF2 mode twice (BDF2) on the pair
    tube's strided slots, the second solve reading the first's output from
    the same tensor (``_pair_step``), against JAX's vmapped step."""
    import jax
    import jax.numpy as jnp
    import pymgrit_tpu as J
    import pymgrit_tpu_torch as P
    t = np.linspace(0, 2, 17)

    def build(mod):
        kw = {} if mod is J else {"device": "cpu"}
        xp = jnp if mod is J else np
        return getattr(mod, cls)(x_start=0, x_end=1, nx=33, a=1, dtau=(t[1] - t[0]) / 2,
                                 rhs=lambda x, s: -xp.sin(xp.pi * x) * xp.cos(s),
                                 init_cond=lambda x: np.sin(np.pi * x), t_interval=t, **kw)

    mj, mp = build(J), build(P)
    u = np.random.default_rng(3).standard_normal((5, 2, mp.nx))
    tp, tc = mp.t[[0, 2, 3, 7, 9]], mp.t[[2, 3, 6, 8, 12]]
    ref = jax.vmap(mj.step)(dict(first=jnp.asarray(u[:, 0]), second=jnp.asarray(u[:, 1])),
                           jnp.asarray(tp), jnp.asarray(tc))
    ref = np.stack([np.asarray(ref["first"]), np.asarray(ref["second"])], axis=1)
    got = mp.step_batched(torch.as_tensor(u), tp, tc)
    _close(got.numpy(), ref, JAX_RTOL)


# ---------------------------------------------------------------------------
# K17: the plain version against the JAX package; the scan's numpy model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [1.0, -1.0])
def test_k17_plain_matches_jax_advection_step(c):
    """K17's plain version (the Fourier route) against JAX's
    ``Advection1D.step`` lane by lane, two chained steps with g."""
    import jax.numpy as jnp
    import pymgrit_tpu as J
    mj = J.Advection1D(c=c, x_start=-1, x_end=1, nx=65, t_start=0, t_stop=2, nt=33)
    n = mj.nx
    rng = np.random.default_rng(4)
    seed, g = rng.standard_normal((3, n)), rng.standard_normal((3, 2, n)) * 1e-2
    dt = np.array([[0.0625, 0.03, 0.125], [0.0625, 0.25, 0.01]])
    out = torch.empty((3, 2, n), **F64)
    periodic.circulant_solve1d(torch.as_tensor(seed), torch.as_tensor(dt), out,
                               torch.as_tensor(g), mj.fac)
    for j in range(3):
        x = jnp.asarray(seed[j])
        for k in range(2):
            x = g[j, k] + mj.step(x, 0.0, dt[k, j])
            _close(out[j, k].numpy(), np.asarray(x), JAX_RTOL)


def _compose(e, l):
    """The affine map x -> l(e(x)) of maps (a, b): x -> a x + b."""
    return l[0] * e[0], l[0] * e[1] + l[1]


def _warp_scan(maps, up):
    """csrc/circulant_solve1d.cu ``warp_scan``: the inclusive Kogge-Stone
    scan of 32 lanes' maps in sequence order (up: lane 0 first)."""
    m = list(maps)
    d = 1
    while d < 32:
        prev = list(m)
        for lane in range(32):
            src = lane - d if up else lane + d
            if 0 <= src < 32:
                m[lane] = _compose(prev[src], prev[lane])
        d *= 2
    return m


def _k17_scan_step(b, c, threads):
    """One K17 solve of the row b in the kernel's order: ``threads`` chunks
    of ceil(n / threads) values (32: the warp route; 256: the block route,
    eight warps), each run serially from a zero start, the chunks' maps
    composed by warp scans and then across warps in sequence order, the
    closure, one multiply-add an entry, the mirrored branch's shift."""
    n = b.size
    c1 = 1.0 + c
    up = abs(c) <= abs(c1)
    base, scale = (c / c1, 1.0 / c1) if up else (c1 / c, -1.0 / c)
    per = -(-n // threads)
    chunks = [range(t * per, min(n, (t + 1) * per)) for t in range(threads)]
    seq = [list(ch) if up else list(ch)[::-1] for ch in chunks]
    w, maps = np.zeros(n), []
    for idx in seq:
        a, acc = 1.0, 0.0
        for i in idx:
            acc = base * acc + b[i]
            a *= base
            w[i] = acc
        maps.append((a, acc))
    inc = []
    for k in range(threads // 32):
        inc += _warp_scan(maps[32 * k:32 * k + 32], up)
    warps = threads // 32
    order = range(warps) if up else range(warps - 1, -1, -1)
    pre, total = {}, (1.0, 0.0)
    for v in order:
        pre[v] = total
        total = _compose(total, inc[32 * v + (31 if up else 0)])
    u = np.empty(n)
    last = total[1] / (1.0 - total[0])
    for t, idx in enumerate(seq):
        lane, warp = t % 32, t // 32
        src = lane - 1 if up else lane + 1
        ex = inc[32 * warp + src] if 0 <= src < 32 else (1.0, 0.0)
        a_in, b_in = _compose(pre[warp], ex)
        d = b_in + a_in * last
        pw = 1.0
        for i in idx:
            pw *= base
            u[i if up else (i - 1) % n] = scale * (w[i] + pw * d)
    return u


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 129, 4096])
@pytest.mark.parametrize("c", [0.3, 1.0, 40.0, -0.3, -1.0, -40.0])
def test_k17_scan_model_matches_the_fourier_route(n, c):
    """The numpy model of K17's scan (the warp route up to n = 512, the
    block route past it) against the plain version's Fourier route, both
    branches (c >= -1/2 forward, c < -1/2 mirrored)."""
    rng = np.random.default_rng(n)
    b = rng.standard_normal(n)
    threads = 32 if -(-n // 32) <= periodic.K17_WARP_CHUNK else periodic.K17_BLOCK
    got = _k17_scan_step(b, c, threads)
    out = torch.empty((1, 1, n), **F64)
    periodic.circulant_solve1d_plain(torch.as_tensor(b[None]), torch.ones((1, 1), **F64), out,
                                     fac=c)
    _close(got, out[0, 0].numpy(), 1e-12)


@pytest.mark.parametrize("n,want", [(1, (1, 1, 2)), (31, (1, 1, 2)), (33, (2, 2, 2)),
                                    (128, (4, 4, 2)), (129, (8, 5, 2)), (512, (16, 16, 2)),
                                    (513, (0, 3, 5)), (4096, (0, 16, 5))])
def test_k17_plan(n, want):
    """The warp route (a register chunk, a power of two, of ceil(n / 32)
    values; four lanes a block) up to 512, the block route past it."""
    assert periodic.circulant_plan(5, n) == want


# ---------------------------------------------------------------------------
# K20: product plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,n,comps,want", [
    # (regime, splits, k-tiles a slice, blocks, smem) at [bdf]'s and phase 3's
    # shapes: the coarsest march (BE's rhs staged: two components), 4 BDF2
    # lanes (three), a coarse level's 64 lanes and the BDF2 level 0's 128 (the
    # wide tile: the rhs from a first pass), the wide step, and [spatial1d]'s
    # example (n = 15: one skinny k-tile holds the inner index)
    (1, 999, 2, ("skinny", 8, 4, 128, 69120)),
    (4, 999, 3, ("skinny", 8, 4, 128, 76032)),
    (64, 999, 1, ("wide", 8, 4, 128, 110592)),
    (128, 999, 1, ("wide", 8, 4, 256, 110592)),
    (1024, 1023, 1, ("wide", 1, 32, 256, 110592)),
    (64, 15, 2, ("skinny", 1, 1, 8, 69120)),
])
def test_k20_plans(B, n, comps, want):
    """S on the tile's M side and the lanes on its N side at every count
    (never swapped), skinny up to 16 lanes; the inner index split where the
    tiles are fewer than a wave of resident blocks (the lanes' components
    and coefficients count in a block's shared memory; K20's wide tile is
    compiled for two blocks an SM)."""
    p = product_tile.lanes_plan(B, n, "float64", (8, True), (8, True), comps)
    assert not p.swap
    assert (p.regime, p.splits, p.kps, p.blocks, p.smem) == want
    assert p.tile == (product_tile.SKINNY if B <= 16 or n <= 32 else product_tile.K20_WIDE)[:3]
    assert p.kslices[0][0] == 0 and p.kslices[-1][1] == n
    assert p.workspace == (p.splits * n * B if p.splits > 1 else 0)


@pytest.mark.parametrize("mode,lanes_mods,want", [
    # x every second row of the pair tube (odd n: rows at 8 mod 16), r shared
    (3, (0, 0, 8), ((8, True), 3)),
    (2, (0, 0, None), ((16, True), 2)),
    (0, (8, None, None), ((8, True), 1)),
])
def test_k20_plan_takes_the_narrowest_lane_copy(mode, lanes_mods, want):
    """The lane components share one copy width (a thread forms the
    elements it copied itself): the narrowest any of them allows (up to
    16 lanes, where the first product forms the right-hand side)."""
    n, B = 998, 8
    x_mod, r_mod, x2_mod = lanes_mods
    strides = (2 * n, 0 if r_mod is not None else 0, 2 * n if x2_mod is not None else 0)
    first, second = heat_kernels.sine_solve1d_plan(B, n, torch.float64, mode,
                                                   (x_mod, r_mod, x2_mod, 0, strides))
    lanes, comps = want
    assert first.copy[1] == lanes[0]
    assert first == product_tile.lanes_plan(B, n, "float64", (16, True), lanes, comps)
    assert (second is None) == (mode == 0)
    # past 16 lanes a first pass writes the rhs into contiguous workspace rows
    first, _ = heat_kernels.sine_solve1d_plan(32, n, torch.float64, mode,
                                              (x_mod, r_mod, x2_mod, 0, strides))
    assert first == product_tile.lanes_plan(32, n, "float64", (16, True),
                                            (16, True) if mode else lanes, 1)


# ---------------------------------------------------------------------------
# K20: cached checks, the packed arguments, the launch
# ---------------------------------------------------------------------------


def _k20_ops(mode, B=5, n=9, dtype=torch.float64, layout="rows"):
    """(x, out, S, lam, dt, rhs, second, c2, c1, coeff) of a K20 call: x
    every second row of a tube, rhs one shared row (stride 0) in BE and a
    row a lane in BDF2, out (B, n) or an (H, D, n) view."""
    tube = _rand((2 * B + 1, n), dtype, "cpu", 5)
    S = torch.as_tensor(sine_eigenbasis(n, (n + 1.0) ** 2)[0], dtype=dtype)
    lam = _rand((n,), dtype, "cpu", 6, 0.0, 1e3)
    x = tube[:2 * B:2]
    if layout == "blocks":
        out = torch.zeros((3, B, n), dtype=dtype).transpose(0, 1)[:, 1:]
        out = out[:B // 2] if B % 2 == 0 else out
    else:
        out = torch.empty((B, n), dtype=dtype)
    if mode == "transform":
        return (x, out, S) + (None,) * 7
    if mode == "be":
        return (x, out, S, lam, _rand((B,), dtype, "cpu", 7, 1e-3, 1e-2),
                tube[-1].expand(B, n)) + (None,) * 4
    coef = _rand((3, B), dtype, "cpu", 8, 10.0, 100.0)
    return (x, out, S, lam, None, tube[1:2 * B:2], tube[2:2 * B + 1:2], coef[0], coef[1],
            coef[2])


def _k20_call(ops):
    return heat_kernels.sine_solve1d(*ops)


@pytest.mark.parametrize("mode", ["transform", "be", "bdf2"])
def test_k20_repeat_call_hits_the_cache_and_new_strides_miss(mode):
    """A second call with the same facts re-checks nothing (one cache hit,
    no miss); x at another row stride is checked anew (a miss)."""
    ops = _k20_ops(mode)
    _k20_call(ops)
    info = heat_kernels._solve1d_checked.cache_info()
    _k20_call((ops[0], torch.empty_like(ops[1])) + ops[2:])
    after = heat_kernels._solve1d_checked.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    tube = _rand((3 * 5, 9), torch.float64, "cpu", 9)
    _k20_call((tube[::3],) + ops[1:])
    assert heat_kernels._solve1d_checked.cache_info().misses == after.misses + 1


def test_k20_cached_checks_raise_on_every_call():
    """The cache holds no failed check: the same error twice, a good call
    between."""
    ops = _k20_ops("be")
    bad = ops[:4] + (torch.zeros(4, **F64),) + ops[5:]
    for _ in range(2):
        with pytest.raises(ValueError, match="dt must be"):
            _k20_call(bad)
        _k20_call(ops)


def test_k20_pack_layout():
    first = product_tile.lanes_plan(5, 9, "float64", (8, True), (8, True), 3)
    second = product_tile.lanes_plan(5, 9, "float64", (8, True), (8, True))
    args = heat_kernels.sine_solve1d_pack(2, (18, 9, 0), (1, 7, 0), 5, 9, 3, (first, second))
    assert list(args) == ([2] + [0] * 12 + [18, 9, 0, 1, 7, 0, 5, 9, 3]
                          + list(first.launch_args()) + list(second.launch_args()) + [0, 0, 1])
    args = heat_kernels.sine_solve1d_pack(0, (18, 0, 0), (2, 30, 9), 5, 9, 0, (first, None))
    assert list(args[32:]) == [0] * 13 and len(args) == 45
    args = heat_kernels.sine_solve1d_pack(0, (18, 0, 0), (2, 30, 9), 64, 99, 2, (first, second))
    assert list(args[42:]) == [1, 0, 0]          # the wide tile: the rhs in a first pass
    args = heat_kernels.sine_solve1d_pack(0, (18, 0, 0), (2, 30, 9), 64, 9, 2, (first, second))
    assert list(args[42:]) == [0, 0, 1]          # n = 9 in one skinny k-tile: staged, one launch


_CT = {torch.float64: ctypes.c_double, torch.float32: ctypes.c_float}


def _view(ptr, shape, strides, dtype):
    """A numpy view of the memory at ``ptr`` (a CPU tensor's), element
    strides."""
    if ptr == 0:
        return None
    span = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    buf = np.ctypeslib.as_array((_CT[dtype] * span).from_address(ptr))
    es = buf.itemsize
    return np.lib.stride_tricks.as_strided(buf, shape, [st * es for st in strides])


class _K20Launcher:
    """A numpy stand-in for ``pm_sine_solve1d``: reads the packed array as
    csrc/sine_solve1d.cu ``launch`` does (pointers, strides, the (hi, lo)
    rows, the mode) and computes what the kernel computes there, so that a
    slot the wrapper fills wrongly shows as a wrong result."""

    def __init__(self, dtype, ws_values):
        self.dtype, self.ws_values, self.calls = dtype, ws_values, []

    def __call__(self, address, stream):
        a = list((ctypes.c_int64 * 45).from_address(address))
        self.calls.append((a, stream))
        dt_ = self.dtype
        B, n, mode = a[19], a[20], a[21]
        es = torch.empty(0, dtype=dt_).element_size()
        v = lambda slot, shape, strides: _view(a[slot], shape, strides, dt_)
        x, S = v(1, (B, n), (a[13], 1)).astype(np.float64), v(7, (n, n), (n, 1))
        lam = v(8, (n,), (1,))
        if mode == 0:
            y = x @ S
        else:
            if mode == 3:
                r, x2 = v(2, (B, n), (a[14], 1)), v(3, (B, n), (a[15], 1))
                c2, c1, coeff = (v(k, (B,), (1,)) for k in (5, 6, 9))
                rhs = (r - c2[:, None] * x) + c1[:, None] * x2
                div = lam[None] + coeff[:, None]
            else:
                dt = v(4, (B,), (1,))
                rhs = x if mode == 1 else x + dt[:, None] * v(2, (B, n), (a[14], 1))
                div = 1.0 + dt[:, None] * lam[None]
            if a[42]:             # the first pass's rows, then the partials
                assert mode >= 2 and a[43] == a[10] + B * n * es
                v(43, (B, n), (n, 1))[...] = rhs
                rhs = v(43, (B, n), (n, 1)).astype(np.float64)
            if a[44]:             # one launch: the work rows stay in the kernel
                assert not a[42] and a[10] == a[11] == 0 and a[32:42] == [0] * 10
                y = ((rhs @ S) / div).astype(np.dtype(str(dt_)[6:])).astype(np.float64) @ S
            else:
                assert a[11] == a[10] + (2 if a[42] else 1) * B * n * es
                work = v(10, (B, n), (n, 1))
                work[...] = (rhs @ S) / div
                y = work.astype(np.float64) @ S
        plans = [a[22:32]] + ([a[32:42]] if mode and not a[44] else [])
        need = ((2 if a[42] else 0 if a[44] else 1) * B * n if mode else 0) + max(
            p[5] * n * B if p[5] > 1 else 0 for p in plans)
        assert need <= self.ws_values
        D, s_hi, s_lo = a[16:19]
        for b in range(B):
            row = _view(a[12] + ((b // D) * s_hi + (b % D) * s_lo) * es, (n,), (1,), dt_)
            row[...] = y[b]
        return 0


@pytest.mark.parametrize("n,prepass", [(40, False), (40, True), (9, False)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode,layout", [("transform", "rows"), ("transform", "blocks"),
                                         ("be", "rows"), ("be", "blocks"), ("be", "in place"),
                                         ("bdf2", "rows"), ("bdf2", "in place")])
def test_k20_launch_the_checks_would_make(monkeypatch, dtype, mode, layout, n, prepass):
    """A CUDA-free look at the launch the cached checks build for a CUDA
    call, made by the wrapper with a numpy stand-in of the launcher: its
    result equals the plain version's, with x every second row of a tube,
    a shared rhs row, an (H, D, n) out or out = x; the rhs staged or from a
    first pass, and at n = 9 both products in one launch."""
    B = 6
    ops = _k20_ops(mode, B, n, dtype, "blocks" if layout == "blocks" else "rows")
    if layout == "in place":
        ops = (ops[0], ops[0]) + ops[2:]
    checked = heat_kernels._solve1d_checked
    monkeypatch.setattr(heat_kernels, "_launcher", lambda nm, dt: (nm, dt))
    monkeypatch.setattr(heat_kernels, "k20_prepass", lambda B, n, mode: prepass and mode >= 2)
    checked.cache_clear()
    try:
        mods = (ops[0].data_ptr() & 15, None if ops[5] is None else ops[5].data_ptr() & 15,
                None if ops[6] is None else ops[6].data_ptr() & 15, ops[2].data_ptr() & 15)
        on_cpu, (args, launcher, index, size, key) = checked(_cuda_facts(ops, 1), mods)
        assert not on_cpu and launcher == ("pm_sine_solve1d", dtype) and index == 1
        assert key == mode and args[0] == 1 and list(args[1:13]) == [0] * 12
        assert args[43] == 0 and args[42] == (prepass and mode != "transform")
        ws = torch.empty(size, dtype=dtype)
        fn = _K20Launcher(dtype, size)
        monkeypatch.setattr(heat_kernels, "_solve1d_checked",
                            lambda *a: (False, (args, fn, index, size, key)))
        monkeypatch.setattr(heat_kernels, "_solve1d_workspace", lambda *a: ws)
        monkeypatch.setattr(heat_kernels._build, "stream", lambda index: 4242)
        want = heat_kernels.sine_solve1d_plain(*[None if t is None else t.clone() for t in ops])
        before = heat_kernels.sine_solve1d.launches
        got = heat_kernels.sine_solve1d(*ops)
        assert got is ops[1] and heat_kernels.sine_solve1d.launches == before + 1
        (packed, stream), = fn.calls
        assert stream == 4242 and packed[13:43] == list(args[13:43])
        _close(got.numpy(), want.numpy(), KERNEL_RTOL[dtype] * 10)
    finally:
        checked.cache_clear()


def test_k20_cpu_checks_carry_no_launch():
    ops = _k20_ops("be")
    facts = tuple(None if t is None else fact(t) for t in ops)
    assert heat_kernels._solve1d_checked(facts, ()) == (True, None)


# ---------------------------------------------------------------------------
# K17: cached checks, the packed arguments, the launch
# ---------------------------------------------------------------------------


def _k17_ops(J=3, L=2, n=40, with_g=True):
    seed = _rand((J, n), torch.float64, "cpu", 10)
    dt = _rand((L, J), torch.float64, "cpu", 11, 1e-3, 0.5)
    out = torch.zeros((J, L + 1, n), **F64)[:, 1:]
    g = _rand((J, L, n), torch.float64, "cpu", 12, -1e-3, 1e-3) if with_g else None
    return seed, dt, out, g


def test_k17_repeat_call_hits_the_cache_and_new_strides_miss():
    seed, dt, out, g = _k17_ops()
    periodic.circulant_solve1d(seed, dt, out, g, 3.0)
    info = periodic._circulant_checked.cache_info()
    periodic.circulant_solve1d(seed, dt, out, g, -3.0)
    after = periodic._circulant_checked.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    periodic.circulant_solve1d(seed, dt, torch.zeros((3, 2, 40), **F64), g, 3.0)
    assert periodic._circulant_checked.cache_info().misses == after.misses + 1


def test_k17_cached_checks_raise_on_every_call():
    seed, dt, out, g = _k17_ops()
    for _ in range(2):
        with pytest.raises(ValueError, match="dt must be"):
            periodic.circulant_solve1d(seed, dt.T, out, g, 1.0)
        periodic.circulant_solve1d(seed, dt, out, g, 1.0)


class _K17Launcher:
    """A numpy stand-in for ``pm_circulant_solve1d``: reads the packed
    array as csrc/circulant_solve1d.cu ``launch`` does and runs the scan's
    model (``_k17_scan_step``) lane by lane and step by step."""

    def __init__(self):
        self.calls = []

    def __call__(self, address, fac, stream):
        a = list((ctypes.c_int64 * 16).from_address(address))
        self.calls.append((a, fac, stream))
        J, L, n, per, chunk, grid = a[10:16]
        threads = 32 if chunk else periodic.K17_BLOCK
        assert per == -(-n // threads) and grid == (-(-J // 4) if chunk else J)
        dt = _view(a[2], (L, J), (J, 1), torch.float64)
        for j in range(J):
            x = _view(a[1] + j * a[5] * 8, (n,), (1,), torch.float64).copy()
            for k in range(L):
                x = _k17_scan_step(x, dt[k, j] * fac, threads)
                if a[4]:
                    x = _view(a[4] + (j * a[8] + k * a[9]) * 8, (n,), (1,), torch.float64) + x
                _view(a[3] + (j * a[6] + k * a[7]) * 8, (n,), (1,), torch.float64)[...] = x
        return 0


@pytest.mark.parametrize("n,with_g,fac", [(40, True, 3.0), (40, False, -30.0), (600, True, 5.0)])
def test_k17_launch_the_checks_would_make(monkeypatch, n, with_g, fac):
    """The launch the cached checks build for a CUDA call, made by the
    wrapper with a numpy stand-in of the launcher running the scan's model:
    its result equals the plain version's (warp and block routes, both
    branches, with and without g)."""
    seed, dt, out, g = _k17_ops(n=n, with_g=with_g)
    ops = (seed, dt, out) if g is None else (seed, dt, out, g)
    checked = periodic._circulant_checked
    monkeypatch.setattr(periodic, "_launcher", lambda nm, d: (nm, d))
    checked.cache_clear()
    try:
        on_cpu, (args, launcher, index) = checked(_cuda_facts(ops, 2))
        assert not on_cpu and launcher == ("pm_circulant_solve1d", torch.float64) and index == 2
        assert list(args[:10]) == [2, 0, 0, 0, 0, n, 3 * n, n, *((2 * n, n) if with_g else (0, 0))]
        fn = _K17Launcher()
        monkeypatch.setattr(periodic, "_circulant_checked", lambda f: (False, (args, fn, index)))
        monkeypatch.setattr(periodic._build, "stream", lambda index: 77)
        want = periodic.circulant_solve1d_plain(seed, dt, torch.zeros_like(out), g, fac)
        got = periodic.circulant_solve1d(seed, dt, out, g, fac)
        (packed, f, stream), = fn.calls
        assert (f, stream) == (fac, 77) and packed[:5] == [
            2, seed.data_ptr(), dt.data_ptr(), out.data_ptr(), 0 if g is None else g.data_ptr()]
        _close(got.numpy(), want.numpy(), 1e-12)
    finally:
        checked.cache_clear()


# ---------------------------------------------------------------------------
# Heat1D's step sizes: a device table made once per set of step times
# ---------------------------------------------------------------------------


def test_heat1d_second_solve_makes_no_new_dt_tensor():
    """The physical Heat1D's step_batched reads its step sizes from
    ``StepTimes``: a second solve of the same hierarchy makes no new dt
    tensor (every cached table is the same object) and gives the same
    history."""
    import pymgrit_tpu_torch as P

    def solve(problem):
        mg = P.Mgrit(problem=problem, tol=1e-10, max_iter=4, logging_lvl=30)
        mg.solve()
        return np.array(mg.conv[1:mg.solve_iter + 1])

    problem = [_heat1d(P, nx=17, nt=nt) for nt in (33, 9)]
    h1 = solve(problem)
    tables = [dict(p._times._cache) for p in problem]
    assert any(k[0] == "dt" for k in tables[0])
    h2 = solve(problem)
    np.testing.assert_array_equal(h2, h1)
    for p, before in zip(problem, tables):
        after = p._times._cache
        assert after.keys() == before.keys()
        assert all(after[k] is before[k] for k in before)


# ---------------------------------------------------------------------------
# on the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


K20_CARD_CASES = [
    # (mode, B, n, layout): skinny (B <= 16 or n <= 32) and wide, split and not
    ("be", 1, 999, "rows"), ("be", 5, 150, "in place"), ("be", 64, 300, "rows"),
    ("be", 40, 70, "blocks"), ("be", 1030, 130, "rows"), ("be nr", 7, 61, "rows"),
    ("bdf2", 4, 999, "rows"), ("bdf2", 128, 201, "in place"), ("bdf2", 33, 64, "rows"),
    ("transform", 8, 999, "rows"), ("transform", 6, 33, "blocks"),
    ("transform", 200, 97, "rows"),
    # n within one k-tile: both products in one launch
    ("be", 5, 31, "blocks"), ("be nr", 64, 15, "rows"), ("bdf2", 20, 17, "in place"),
    ("bdf2", 9, 32, "rows"), ("be", 1030, 7, "rows"),
]


def _k20_card(mode, B, n, layout, dtype, dev):
    """run() -> the output of one K20 call on ``dev``: x every second row
    of a tube (BDF2: the pair tube's second slot), a shared rhs row (BE) or
    a row a lane (BDF2), out a fresh tensor, x itself or an (H, D, n)
    view; "be nr" is BE without a rhs."""
    tube = _rand((2 * B + 2, n), dtype, dev, 20 + n)
    S = torch.as_tensor(sine_eigenbasis(n, (n + 1.0) ** 2)[0], dtype=dtype, device=dev)
    lam = torch.as_tensor(sine_eigenbasis(n, (n + 1.0) ** 2)[1], dtype=dtype, device=dev)
    dt = _rand((B,), dtype, dev, 21, 1e-4, 1e-2)
    coef = _rand((3, B), dtype, dev, 22, 100.0, 300.0)

    def run(ops):
        t = tube.clone()
        x = t[1:2 * B + 1:2]
        if layout == "blocks":
            H = B // 2 if B % 2 == 0 else B
            out = torch.zeros((3, H, n), dtype=dtype, device=dev).transpose(0, 1)[:, 1:]
            out = out[:, :B // H]
        elif layout == "in place":
            out = x
        else:
            out = torch.zeros((B, n), dtype=dtype, device=dev)
        if mode == "transform":
            ops.sine_solve1d(x, out, S)
        elif mode == "bdf2":
            ops.sine_solve1d(x, out, S, lam, rhs=t[0].expand(B, n), second=t[2:2 * B + 2:2],
                             c2=coef[0], c1=coef[1], coeff=coef[2])
        else:
            ops.sine_solve1d(x, out, S, lam, dt, None if mode == "be nr" else t[0].expand(B, n))
        return out.clone()
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode,B,n,layout", K20_CARD_CASES)
def test_k20_on_card(cuda, dtype, mode, B, n, layout):
    """The kernel against its plain version at KERNEL_RTOL of the largest
    entry, and a second launch bit for bit with the first."""
    run = _k20_card(mode, B, n, layout, dtype, cuda)
    before = heat_kernels.sine_solve1d.launches
    got = run(DISPATCH)
    torch.cuda.synchronize()
    assert heat_kernels.sine_solve1d.launches == before + 1
    want = run(PLAIN)
    assert torch.isfinite(got).all()
    _close(got.cpu().numpy(), want.cpu().numpy(), KERNEL_RTOL[dtype])
    assert torch.equal(got, run(DISPATCH))


K17_CARD_CASES = [(n, c) for n in (1, 31, 33, 100, 129, 500, 513, 4096)
                  for c in (0.3, 1.0, 40.0, -0.3, -1.0, -40.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,c", K17_CARD_CASES)
def test_k17_on_card(cuda, dtype, n, c):
    """Both routes (the warp route's five register chunks, the block route
    past 512) and both branches, chained steps with g into a strided view,
    against the plain version at KERNEL_RTOL; a second launch bit for bit."""
    J, L = 6, 3
    seed = _rand((J, n), dtype, cuda, 30 + n)
    dt = _rand((L, J), dtype, cuda, 31, 0.5, 1.5)
    g = _rand((J, L, n), dtype, cuda, 32, -1e-3, 1e-3)

    def run(ops):
        out = torch.zeros((J, L + 1, n), dtype=dtype, device=cuda)[:, 1:]
        return ops.circulant_solve1d(seed, dt, out, g, c).clone()

    before = periodic.circulant_solve1d.launches
    got = run(DISPATCH)
    torch.cuda.synchronize()
    assert periodic.circulant_solve1d.launches == before + 1
    want = run(PLAIN)
    assert torch.isfinite(got).all()
    _close(got.cpu().numpy(), want.cpu().numpy(), KERNEL_RTOL[dtype])
    assert torch.equal(got, run(DISPATCH))


@pytest.mark.cuda
def test_k17_coarsest_march_on_card(cuda):
    """One lane of 256 chained steps (the deep grid's coarsest march)."""
    n, L = 128, 256
    seed = _rand((1, n), torch.float64, cuda, 40)
    dt = torch.full((L, 1), 1.0 / 128, dtype=torch.float64, device=cuda)

    def run(ops):
        out = torch.zeros((1, L, n), dtype=torch.float64, device=cuda)
        return ops.circulant_solve1d(seed, dt, out, None, 64.0).clone()

    got, want = run(DISPATCH), run(PLAIN)
    _close(got.cpu().numpy(), want.cpu().numpy(), KERNEL_RTOL[torch.float64])
    assert torch.equal(got, run(DISPATCH))
