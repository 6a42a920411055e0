"""K6 ``sine_affine2d`` (float64 on the FP64 tensor cores, float32 on the
FFMA cores) and K7 ``theta_rhs2d`` (a CUDA C++ stencil) against their plain
PyTorch versions, and their wrappers' cached checks and packed arguments.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k6_k7.py -q -m cuda --noconftest

and the rest here with ``-m 'not cuda'``.

Tolerance on the card: normwise, max|kernel - plain| <= RTOL * max|plain|
with RTOL = 1e-13 (float64) and 1e-5 (float32), as chip_smoke.py's
KERNEL_RTOL.  K6 sums its length-n products in DMMA's k4 groups (float64)
or one FMA at a time (float32), cuBLAS in its own order
(``tests/test_torch_kernels.py`` explains the bound), so it agrees with
the plain version to rounding.  K7 rounds each of the plain version's
operations once, in its order, so in float64 it equals the plain version
bit for bit; in float32 it is held at the tolerance.  Each kernel repeats
itself bit for bit from call to call.

The CPU tests: a CPU tensor goes to the plain version without a launch,
the cached checks raise the same errors on every call, and the launch
arguments are packed as the C launchers read them.
"""

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, heat_kernels, theta_rhs
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis
from pymgrit_tpu_torch.ops.heat_kernels import fact

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed):
    a = np.random.default_rng(seed).standard_normal(shape)
    if a.size == 0:                 # (numpy's empty arrays come with strides 0)
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _agree(k, p, dtype):
    err = float((k - p).abs().max()) if k.numel() else 0.0
    scale = float(p.abs().max()) if p.numel() else 0.0
    assert err <= RTOL[dtype] * scale, (err, scale)


def _basis(n, dtype, dev):
    return torch.as_tensor(sine_eigenbasis(n, (n + 1.0) ** 2)[0], dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# K6 sine_affine2d
# ---------------------------------------------------------------------------


def _k6_run(dtype, dev, J, R, r, c, r0, mode, seed=0):
    """run(ops) -> the tensor one K6 case writes into.  mode holds the
    layout ('rows': a (R, J) row-major output; 'intervals': (J, R);
    'tube': the (J, R + 1) blocks of a tube, row 0 the seeds' copies),
    'CN' (the ring correction), '+seed' (seed_out, 'tube' only) and
    'noring' (interior states, no ring)."""
    T = r0 + R
    N = r * c
    Sx, Sy = _basis(r, dtype, dev), _basis(c, dtype, dev)
    xhat = _rand((2 * J, N), dtype, dev, seed + 1)[::2]          # rows at stride 2N
    A = _rand((T, N), dtype, dev, seed + 2).abs() / 2
    G = _rand((T, N), dtype, dev, seed + 3)
    ring = None
    if "noring" not in mode:
        ring = _rand((r + 2, c + 2), dtype, dev, seed + 4)
        ring[1:-1, 1:-1] = 0.0
    P, Q = (r, c) if ring is None else (r + 2, c + 2)
    dhat = dscale = None
    if "CN" in mode:
        dhat = _rand((J, N), dtype, dev, seed + 5)
        dscale = _rand((N,), dtype, dev, seed + 6) * 1e-2
    seeds = _rand((J + 1, P, Q), dtype, dev, seed + 7)

    def run(ops):
        seed_in = seed_out = None
        if "rows" in mode:
            buf = torch.full((R, J, P, Q), float("nan"), dtype=dtype, device=dev)
            out = buf.transpose(0, 1)
        elif "intervals" in mode:
            buf = torch.full((J, R, P, Q), float("nan"), dtype=dtype, device=dev)
            out = buf
        else:
            buf = torch.full((J * (R + 1) + 1, P, Q), float("nan"), dtype=dtype, device=dev)
            blocks = buf[:J * (R + 1)].view(J, R + 1, P, Q)
            out = blocks[:, 1:]
            if "+seed" in mode:
                seed_in, seed_out = seeds[:J], blocks[:, 0]
        ops.sine_affine2d(xhat, A, G, out, Sx, Sy, r0, ring, dhat, dscale, seed_in, seed_out)
        return buf
    return run


# (J, R, r, c, r0, mode): every tile side of the DMMA one-tile kernel (16,
# 32, 64, 128: sides 15, 31, 63, 127) with 2-8 states a block sharing
# intervals, the band products past 128 (129, 255; one chunk and past the
# 512-state chunk), rectangular states on both sides of 64 and 128, every
# layout, BE and CN, r0 > 0 (CN's A[r0 - 1]) and r0 = 0 (A[-1] = 1), seeds
# copied or not, no ring
K6_CASES = (
    (5, 3, 15, 15, 0, "tube+seed"), (9, 3, 15, 15, 1, "rows CN"), (3, 1, 1, 1, 0, "intervals"),
    (7, 3, 31, 31, 0, "tube+seed CN"), (33, 1, 31, 31, 3, "rows"), (5, 2, 31, 31, 0, "noring intervals"),
    (5, 3, 63, 63, 0, "tube+seed"), (9, 1, 63, 63, 3, "rows CN"), (4, 3, 63, 63, 1, "intervals CN"),
    (3, 3, 127, 127, 0, "tube+seed"), (40, 1, 127, 127, 31, "rows CN"),
    (4, 2, 127, 127, 2, "intervals"), (2, 2, 128, 128, 0, "noring tube"),
    (3, 2, 129, 129, 0, "tube+seed CN"), (2, 1, 129, 129, 5, "rows"),
    (3, 2, 255, 255, 1, "tube+seed"), (260, 2, 255, 255, 0, "rows"),
    (4, 3, 255, 255, 0, "intervals CN"), (3, 2, 40, 70, 1, "tube+seed CN"),
    (3, 2, 70, 40, 0, "rows"), (3, 2, 100, 130, 0, "tube+seed"), (3, 2, 130, 100, 2, "intervals CN"),
    (5, 2, 20, 9, 0, "noring rows"), (4, 2, 3, 200, 0, "tube+seed"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("J,R,r,c,r0,mode", K6_CASES)
def test_k6_matches_plain_on_card(cuda, dtype, J, R, r, c, r0, mode):
    run = _k6_run(dtype, cuda, J, R, r, c, r0, mode)
    before = DISPATCH.sine_affine2d.launches
    k = run(DISPATCH)
    torch.cuda.synchronize()
    assert DISPATCH.sine_affine2d.launches == before + 1
    p = run(PLAIN)
    assert torch.equal(torch.isnan(k), torch.isnan(p))   # gaps and seeds left alone / written
    w = ~torch.isnan(p)
    _agree(k[w], p[w], dtype)
    assert torch.equal(k[w], run(DISPATCH)[w])          # a fixed order


@pytest.mark.parametrize("J,R,r,c,r0,mode", [(3, 2, 5, 7, 1, "tube+seed CN"),
                                             (4, 1, 6, 4, 2, "rows"),
                                             (0, 2, 5, 5, 0, "intervals"),
                                             (2, 2, 3, 3, 0, "noring intervals CN")])
def test_k6_cpu_takes_the_plain_version(J, R, r, c, r0, mode):
    run = _k6_run(torch.float64, "cpu", J, R, r, c, r0, mode)
    before = heat_kernels.sine_affine2d.launches
    got = run(DISPATCH)
    assert heat_kernels.sine_affine2d.launches == before
    ref = run(PLAIN)
    assert torch.equal(got.isnan(), ref.isnan())
    w = ~got.isnan()
    torch.testing.assert_close(got[w], ref[w], rtol=0, atol=0)


@pytest.mark.parametrize("r0", [0, 2])
def test_k6_plain_matches_numpy(r0):
    """The oracle itself: Sx (xhat A[r0+k] + G[r0+k] + (dhat dscale)
    A[r0+k-1]) Sy with A[-1] = 1, the ring around it, the seeds copied."""
    rng = np.random.default_rng(17)
    J, R, r, c = 3, 2, 5, 4
    N, T = r * c, r0 + R
    Sx, Sy = sine_eigenbasis(r, 36.0)[0], sine_eigenbasis(c, 25.0)[0]
    xhat, dhat = rng.standard_normal((J, N)), rng.standard_normal((J, N))
    A, G, dscale = rng.uniform(0, 1, (T, N)), rng.standard_normal((T, N)), rng.standard_normal(N)
    ring = rng.standard_normal((r + 2, c + 2))
    seeds = rng.standard_normal((J, r + 2, c + 2))
    A_ext = np.concatenate([np.ones((1, N)), A])
    ref = np.empty((J, R, r + 2, c + 2))
    for j in range(J):
        for k in range(R):
            y = xhat[j] * A[r0 + k] + G[r0 + k] + (dhat[j] * dscale) * A_ext[r0 + k]
            ref[j, k] = ring
            ref[j, k, 1:-1, 1:-1] = Sx @ y.reshape(r, c) @ Sy
    t = torch.as_tensor
    out = torch.empty((J, R, r + 2, c + 2), dtype=torch.float64)
    seed_out = torch.empty((J, r + 2, c + 2), dtype=torch.float64)
    heat_kernels.sine_affine2d_plain(t(xhat), t(A), t(G), out, t(Sx), t(Sy), r0, t(ring), t(dhat),
                                     t(dscale), t(seeds), seed_out)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-13, atol=1e-14)
    assert np.array_equal(seed_out.numpy(), seeds)


def _k6_args(**over):
    f = dict(dtype=torch.float64)
    n = 4
    args = dict(xhat=torch.zeros((3, n * n), **f), A=torch.zeros((4, n * n), **f),
                G=torch.zeros((4, n * n), **f), out=torch.empty((3, 2, n + 2, n + 2), **f),
                Sx=torch.zeros((n, n), **f), Sy=torch.zeros((n, n), **f), r0=1,
                ring=torch.zeros((n + 2, n + 2), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(r0=3), "outside"),
    (dict(xhat=torch.zeros((3, 17), dtype=torch.float64)), "xhat has shape"),
    (dict(out=torch.empty((3, 2, 4, 4), dtype=torch.float64)), "out has shape"),
    (dict(dhat=torch.zeros((3, 16), dtype=torch.float64)), "dhat and dscale"),
    (dict(dhat=torch.zeros((2, 16), dtype=torch.float64),
          dscale=torch.zeros(16, dtype=torch.float64)), "dhat must be"),
    (dict(seed=torch.zeros((3, 6, 6), dtype=torch.float64)), "seed and seed_out"),
    (dict(seed=torch.zeros((3, 6, 6), dtype=torch.float64),
          seed_out=torch.zeros((3, 5, 6), dtype=torch.float64)), "seed_out has shape"),
    (dict(A=torch.zeros((16, 4), dtype=torch.float64).t()), "contiguous"),
    (dict(Sx=torch.zeros((4, 5), dtype=torch.float64)), "square bases"),
    (dict(ring=torch.zeros((6, 5), dtype=torch.float64)), "ring must be"),
    (dict(G=torch.zeros((4, 16), dtype=torch.float32)), "dtype"),
    (dict(out=torch.empty((3, 2, 6, 6), dtype=torch.float64, device="meta")), "is on meta"),
])
def test_k6_cached_checks_raise_on_every_call(over, match):
    """The same error on every call with the same shapes (the cache holds
    no failed check), and a good call between them still runs."""
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            heat_kernels.sine_affine2d(**_k6_args(**over))
        heat_kernels.sine_affine2d(**_k6_args())


def test_k6_pack_layout():
    args = heat_kernels.affine_pack(1, (16129, 16129), (508032, 16641, 129), (16641, 129),
                                    (541632, 129), 0, 31, 512, 127, 127, 0)
    assert list(args) == [1] + [0] * 12 + [16129, 16129, 508032, 16641, 129, 16641, 129,
                                           541632, 129, 0, 31, 512, 127, 127, 0]


def test_k6_cpu_checks_carry_no_launch():
    a = _k6_args()
    ops = [a[k] for k in ("xhat", "A", "G", "out", "Sx", "Sy", "ring")]
    present = (True,) * 7 + (False,) * 4
    assert heat_kernels._affine_checked(tuple(map(fact, ops)), present, 1) == (True, None)


def _cuda_facts(ops, index=0):
    """The facts of these tensors as if they lay on CUDA device ``index``."""
    dev = torch.device("cuda", index)
    return tuple((t.dtype, dev, t.shape, t.stride()) for t in ops)


@pytest.mark.parametrize("dtype,J,R,n,want_chunk", [(torch.float64, 512, 31, 127, 0),
                                                    (torch.float64, 128, 1, 255, 128),
                                                    (torch.float64, 40, 31, 129, 512),
                                                    (torch.float32, 128, 1, 255, 128)])
def test_k6_launch_the_checks_would_make(monkeypatch, dtype, J, R, n, want_chunk):
    """A CUDA-free look at the launch the cached checks build for a CUDA
    call: the tube's block view with the seeds, packed in the launcher's
    order, the chunk past the one-tile side at most TILED_CHUNK, and K5's
    workspace layout (float64: the bases' copies and the band products'
    two buffers)."""
    monkeypatch.setattr(heat_kernels, "_launcher", lambda name, dt: (name, dt))
    heat_kernels._affine_checked.cache_clear()
    try:
        f = dict(dtype=dtype)
        N, P = n * n, n + 2
        xhat, A = torch.zeros((J, N), **f), torch.zeros((32, N), **f)
        S, ring = torch.zeros((n, n), **f), torch.zeros((P, P), **f)
        tube = torch.empty((J * (R + 1) + 1, P, P), **f)
        blocks = tube[:J * (R + 1)].view(J, R + 1, P, P)
        seeds = torch.empty((J + 1, P, P), **f)
        ops = (xhat, A, A, blocks[:, 1:], S, S, ring, seeds[:J], blocks[:, 0])
        present = (True,) * 7 + (False, False, True, True)
        on_cpu, (args, fn, index, ws) = heat_kernels._affine_checked(_cuda_facts(ops), present,
                                                                     32 - R)
        assert not on_cpu and fn == ("pm_sine_affine2d", dtype) and index == 0
        bs = (R + 1) * P * P
        assert list(args[13:]) == [N, 0, bs, P * P, P, P * P, P, bs, P, 32 - R, R, J, n, n,
                                   want_chunk]
        assert ws == heat_kernels.solve_workspace(dtype, n, n, want_chunk)
    finally:
        heat_kernels._affine_checked.cache_clear()


# ---------------------------------------------------------------------------
# K7 theta_rhs2d
# ---------------------------------------------------------------------------


def _k7_run(dtype, dev, B, r, c, mode, seed=0):
    """run(ops) -> the tensor one K7 case writes into: u read from every
    second state of a tube (strided views), written into a strided view of
    a fresh tube.  mode: 'BE', 'CN' or 'FE'; '+dt' (a dt tensor), '+g' (FE),
    '+rows' (a time-dependent rhs: one row a state, else one row at stride
    0)."""
    P, Q, N = r + 2, c + 2, r * c
    fx, fy = (r + 1.0) ** 2, (c + 1.0) ** 2
    theta = {"BE": 1.0, "CN": 0.5, "FE": 0.0}[mode[:2]]
    tube = _rand((2 * B + 1, P, Q), dtype, dev, seed + 1)
    u = tube[1::2]
    if "+rows" in mode:
        rows = _rand((2 * B, N), dtype, dev, seed + 2)
        r1, r0 = rows[:B], rows[B:]
    else:
        rows = _rand((2, N), dtype, dev, seed + 2)
        r1, r0 = rows[0].expand(B, N), rows[1].expand(B, N)
    lift = _rand((r, c), dtype, dev, seed + 3)
    ring = _rand((P, Q), dtype, dev, seed + 4)
    ring[1:-1, 1:-1] = 0.0
    g = _rand((2 * B, P, Q), dtype, dev, seed + 5)[0::2] * 1e-2 if "+g" in mode else None
    dt = 1.0 / 4096
    if "+dt" in mode:
        dt = torch.as_tensor(np.random.default_rng(seed + 6).uniform(0.5, 1.0, B) / 4096,
                             dtype=dtype, device=dev)
    fe = theta == 0.0

    def run(ops):
        shape = (2 * B + 1, P, Q) if fe else (2 * B + 1, r, c)
        buf = torch.full(shape, float("nan"), dtype=dtype, device=dev)
        ops.theta_rhs2d(u, buf[:-1:2], dt, theta, fx, fy, r1, r0,
                        lift=None if fe else lift, ring=ring if fe else None, g=g)
        return buf
    return run


# (B, r, c, mode): the three modes at every side the physical models use
# (15, 31, 63, 127 and 255, B of the solve's levels) and odd ones, a dt
# tensor, time-dependent rhs rows, FE's g, rectangular states, one column
# band and many, interiors wider than one block of threads
K7_CASES = (
    (512, 127, 127, "BE"), (512, 127, 127, "CN"), (512, 127, 127, "FE+g"),
    (512, 127, 127, "CN+dt"), (32, 127, 127, "BE"), (32, 127, 127, "CN+rows"),
    (8, 127, 127, "FE+dt+rows"), (2, 127, 127, "CN"), (514, 63, 63, "BE+dt"),
    (256, 31, 31, "CN+rows"), (64, 15, 15, "FE"), (3, 1, 1, "CN"), (5, 1, 7, "FE+g"),
    (128, 255, 255, "BE"), (5, 255, 255, "CN+dt+rows"), (3, 255, 300, "FE+g+rows"),
    (4, 40, 70, "CN"), (4, 70, 40, "BE+rows"), (4, 129, 17, "FE+dt"), (6, 9, 20, "CN+dt+rows"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,r,c,mode", K7_CASES)
def test_k7_matches_plain_on_card(cuda, dtype, B, r, c, mode):
    run = _k7_run(dtype, cuda, B, r, c, mode)
    before = DISPATCH.theta_rhs2d.launches
    k = run(DISPATCH)
    torch.cuda.synchronize()
    assert DISPATCH.theta_rhs2d.launches == before + 1
    p = run(PLAIN)
    assert torch.equal(torch.isnan(k), torch.isnan(p))   # the views' gaps are left alone
    w = ~torch.isnan(p)
    if dtype == torch.float64:
        assert torch.equal(k[w], p[w])                   # the plain version's roundings
    else:
        _agree(k[w], p[w], dtype)
    assert torch.equal(k[w], run(DISPATCH)[w])


@pytest.mark.parametrize("B,r,c,mode", [(3, 5, 5, "BE"), (3, 4, 6, "CN+dt+rows"),
                                        (2, 5, 3, "FE+g"), (0, 5, 5, "CN")])
def test_k7_cpu_takes_the_plain_version(B, r, c, mode):
    run = _k7_run(torch.float64, "cpu", B, r, c, mode)
    before = theta_rhs.theta_rhs2d.launches
    got = run(DISPATCH)
    assert theta_rhs.theta_rhs2d.launches == before
    ref = run(PLAIN)
    assert torch.equal(got.isnan(), ref.isnan())
    w = ~got.isnan()
    torch.testing.assert_close(got[w], ref[w], rtol=0, atol=0)


def _k7_args(**over):
    f = dict(dtype=torch.float64)
    args = dict(u=torch.zeros((3, 6, 7), **f), out=torch.empty((3, 4, 5), **f),
                dt=1e-3, theta=0.5, fx=1.0, fy=1.0, rhs1=torch.zeros(20, **f).expand(3, 20),
                rhs0=torch.zeros(20, **f).expand(3, 20), lift=torch.zeros((4, 5), **f))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(out=torch.empty((3, 6, 7), dtype=torch.float64)), "out has shape"),
    (dict(theta=0.0, out=torch.empty((3, 6, 7), dtype=torch.float64)), "ring field"),
    (dict(lift=None), "lift"),
    (dict(lift=torch.zeros((5, 4), dtype=torch.float64).t()), "contiguous"),
    (dict(rhs0=torch.zeros((3, 20), dtype=torch.float64)), "equal strides"),
    (dict(theta=-0.5), "theta"),
    (dict(dt=torch.zeros(2, dtype=torch.float64)), "dt tensor"),
    (dict(g=torch.zeros((3, 4, 5), dtype=torch.float64)), "FE steps only"),
    (dict(u=torch.zeros((3, 2, 7), dtype=torch.float64)), "interior"),
    (dict(u=torch.zeros((6, 7), dtype=torch.float64)), "u has shape"),
    (dict(rhs1=torch.zeros(20).expand(3, 20), rhs0=torch.zeros(20).expand(3, 20)), "dtype"),
])
def test_k7_cached_checks_raise_on_every_call(over, match):
    """The same error on every call with the same shapes (the cache holds
    no failed check), and a good call between them still runs."""
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            theta_rhs.theta_rhs2d(**_k7_args(**over))
        theta_rhs.theta_rhs2d(**_k7_args())


def test_k7_pack_layout():
    args = theta_rhs.pack(3, (16641, 129), (16129, 127), 0, (0, 0), 512, 129, 129, 1)
    # the halo rows' pointer slots and batch stride last
    assert list(args) == [3] + [0] * 8 + [16641, 129, 16129, 127, 0, 0, 0, 512, 129, 129, 1,
                                          0, 0, 0]


def test_k7_cpu_checks_carry_no_launch():
    a = _k7_args()
    ops = [a[k] for k in ("u", "out", "rhs1", "rhs0", "lift")]
    present = (True,) * 5 + (False,) * 3
    assert theta_rhs._checked(tuple(map(fact, ops)), present, 0.5) == (True, None)


@pytest.mark.parametrize("theta,mode", [(1.0, 0), (0.5, 1), (0.25, 1), (0.0, 2)])
def test_k7_launch_the_checks_would_make(monkeypatch, theta, mode):
    """A CUDA-free look at the launch the cached checks build for a CUDA
    call on tube views: the mode from theta, strides in the launcher's
    order, g's strides with FE."""
    monkeypatch.setattr(theta_rhs, "_launcher", lambda name, dt: (name, dt))
    theta_rhs._checked.cache_clear()
    try:
        f = dict(dtype=torch.float64)
        B, P, Q = 32, 9, 11
        N = (P - 2) * (Q - 2)
        tube = torch.zeros((2 * B, P, Q), **f)
        fe = theta == 0.0
        out = torch.empty((B, 2, P, Q) if fe else (B, 2, P - 2, Q - 2), **f)[:, 1]
        rows = torch.zeros((B, 2 * N), **f)[:, :N]
        side = torch.zeros((P, Q) if fe else (P - 2, Q - 2), **f)
        g = tube[1::2] if fe else None
        ops = (tube[0::2], out, rows, rows, None if fe else side, side if fe else None, g, None)
        present = tuple(t is not None for t in ops)
        on_cpu, (args, fn, index) = theta_rhs._checked(
            _cuda_facts([t for t in ops if t is not None], 1), present, theta)
        assert not on_cpu and fn == ("pm_theta_rhs2d", torch.float64) and index == 1
        o_sb, o_sr = out.stride()[:2]
        assert list(args[9:]) == [2 * P * Q, Q, o_sb, o_sr, 2 * N,
                                  2 * P * Q if fe else 0, Q if fe else 0, B, P, Q, mode, 0, 0, 0]
    finally:
        theta_rhs._checked.cache_clear()
