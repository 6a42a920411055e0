"""K3 ``residual_row_norms`` (CUDA C++ row reduction) and K5
``sine_solve2d`` (float64 on the FP64 tensor cores, float32 on the FFMA
cores) against their plain PyTorch versions, and their wrappers' cached
checks.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k3_k5.py -q -m cuda --noconftest

Tolerance on the card: normwise, max|kernel - plain| <= RTOL * max|plain|
with RTOL = 1e-13 (float64) and 1e-5 (float32), as chip_smoke.py's
KERNEL_RTOL.  K3 sums its squares in a fixed order of its own (a partial a
thread, a warp butterfly, the warps in order), PyTorch's sum in another; K5
sums its length-n products in DMMA's k4 groups (float64) or one FMA at a
time (float32), cuBLAS in its own order, so both agree with the plain
versions to rounding, and each repeats itself bit for bit.

The CPU tests: a CPU tensor goes to the plain version without a launch, the
cached checks raise the same errors on every call, and the launch
arguments are packed as the C launchers read them.
"""

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, heat_kernels, row_norms
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
    return torch.as_tensor(a, dtype=dtype, device=device)


def _agree(k, p, dtype):
    err = float((k - p).abs().max()) if k.numel() else 0.0
    scale = float(p.abs().max()) if p.numel() else 0.0
    assert err <= RTOL[dtype] * scale, (err, scale)


# ---------------------------------------------------------------------------
# K3 residual_row_norms
# ---------------------------------------------------------------------------


def _k3_case(case, dtype, dev):
    """(s, u) row views of a K3 case."""
    if case == "tube rows odd N":           # rows of a tube, alternating 16-byte alignment
        tube = _rand((19, 1001), dtype, dev, 1)
        return tube[1:19:2], tube[0:18:2]
    if case == "disagreeing rows":          # the solver's a[1:], b[:J]: every row disagrees
        a, b = _rand((65, 16129), dtype, dev, 2), _rand((65, 16129), dtype, dev, 3)
        return a[1:], b[:64]
    if case == "aligned rows":
        a, b = _rand((33, 4096), dtype, dev, 4), _rand((33, 4096), dtype, dev, 5)
        return a, b
    if case == "u stride 0":                # the DD path: a zero row expanded
        s = _rand((40, 3969), dtype, dev, 6)
        return s, torch.zeros(3969, dtype=dtype, device=dev).expand(40, 3969)
    if case == "R = 0":
        return (torch.empty((0, 7), dtype=dtype, device=dev),
                torch.empty((0, 7), dtype=dtype, device=dev))
    if case == "N = 1":
        t = _rand((9, 1), dtype, dev, 7)
        return t[1:], t[:8]
    if case == "N < vector":
        t = _rand((6, 3), dtype, dev, 8)
        return t[1:], t[:5]
    if case == "one long row":
        t = _rand((2, 300001), dtype, dev, 9)
        return t[1:], t[:1]
    raise KeyError(case)


K3_CASES = ("tube rows odd N", "disagreeing rows", "aligned rows", "u stride 0", "R = 0",
            "N = 1", "N < vector", "one long row")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", K3_CASES)
def test_k3_matches_plain_on_card(cuda, dtype, case):
    s, u = _k3_case(case, dtype, cuda)
    before = DISPATCH.residual_row_norms.launches
    k = DISPATCH.residual_row_norms(s, u)
    torch.cuda.synchronize()
    assert DISPATCH.residual_row_norms.launches == before + (1 if s.shape[0] else 0)
    assert k.shape == (s.shape[0],) and k.dtype == dtype and k.device.type == "cuda"
    _agree(k, PLAIN.residual_row_norms(s, u), dtype)
    assert torch.equal(k, DISPATCH.residual_row_norms(s, u))      # a fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k3_nan_and_inf_rows_on_card(cuda, dtype):
    """A NaN in a row gives NaN, an inf inf, inf - inf NaN, squares that
    overflow inf: as the plain version."""
    s = _rand((6, 1001), dtype, cuda, 10)
    u = torch.zeros_like(s)
    s[1, 7], s[2, 500] = float("nan"), float("inf")
    s[3, 5], s[3, 990] = float("inf"), float("nan")
    s[4, 3] = u[4, 3] = float("inf")
    s[5, 0] = torch.finfo(dtype).max
    k, p = DISPATCH.residual_row_norms(s, u), PLAIN.residual_row_norms(s, u)
    assert torch.equal(torch.isnan(k), torch.isnan(p)) and torch.equal(torch.isinf(k),
                                                                      torch.isinf(p))
    assert torch.isnan(k[1]) and torch.isinf(k[2]) and torch.isnan(k[3]) and torch.isnan(k[4])
    assert torch.isinf(k[5]) and torch.isfinite(k[0])


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_cpu_takes_the_plain_version(case):
    s, u = _k3_case(case, torch.float64, "cpu")
    before = row_norms.residual_row_norms.launches
    got = row_norms.residual_row_norms(s, u)
    assert row_norms.residual_row_norms.launches == before
    ref = np.sqrt(np.sum((s.numpy() - u.numpy()) ** 2, axis=1))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=0)


def test_k3_plain_on_a_stride_0_u():
    s = _rand((4, 9), torch.float64, "cpu", 11)
    row = _rand((9,), torch.float64, "cpu", 12)
    got = row_norms.residual_row_norms_plain(s, row.expand(4, 9))
    np.testing.assert_allclose(got.numpy(), np.linalg.norm(s.numpy() - row.numpy(), axis=1),
                               rtol=1e-14)


@pytest.mark.parametrize("make,match", [
    (lambda: (torch.zeros((4, 5)), torch.zeros((3, 5))), "must be equal"),
    (lambda: (torch.zeros(5, dtype=torch.float64), torch.zeros(5, dtype=torch.float64)),
     "must be equal"),
    (lambda: (torch.zeros((4, 5), dtype=torch.float64), torch.zeros((4, 5))), "dtype"),
    (lambda: (torch.zeros((5, 4), dtype=torch.float64).t(),) * 2, "contiguous"),
    (lambda: (torch.zeros((4, 5), dtype=torch.int64),) * 2, "dtype"),
])
def test_k3_cached_checks_raise_on_every_call(make, match):
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            row_norms.residual_row_norms(*make())


def test_k3_pack_layout():
    assert list(row_norms.pack(1, 512, 16129, 16129, 0)) == [1, 512, 16129, 16129, 0]


def test_k3_cpu_checks_carry_no_launch():
    s = torch.zeros((3, 4), dtype=torch.float64)
    assert row_norms._checked((fact(s), fact(s))) == (True, None)


# ---------------------------------------------------------------------------
# K5 sine_solve2d
# ---------------------------------------------------------------------------


def _k5_run(dtype, dev, B, r, c, mode, seed=0):
    """run(ops) -> output of one K5 case: states read from a tube's strided
    rows, written into a strided view of a fresh tube (with the ring: the
    full states; g: a strided view of its own tube).  mode: 'solve' (a
    float shift), 'tensor' (a shift a state), 'transform'; '+ring', '+g'."""
    Sx = torch.as_tensor(sine_eigenbasis(r, (r + 1.0) ** 2)[0], dtype=dtype, device=dev)
    Sy = torch.as_tensor(sine_eigenbasis(c, (c + 1.0) ** 2)[0], dtype=dtype, device=dev)
    rng = np.random.default_rng(seed)
    lam = torch.as_tensor(rng.uniform(0, 4.0 * (max(r, c) + 1) ** 2, (r, c)), dtype=dtype,
                          device=dev)
    tube = _rand((2 * B + 1, r + 2, c + 2), dtype, dev, seed + 1)
    b = tube[1::2, 1:-1, 1:-1]
    ring = g = shift = None
    if "+ring" in mode:
        ring = _rand((r + 2, c + 2), dtype, dev, seed + 2)
        ring[1:-1, 1:-1] = 0.0
    P, Q = (r + 2, c + 2) if ring is not None else (r, c)
    if "+g" in mode:
        g = _rand((2 * B, P, Q), dtype, dev, seed + 3)[0::2] * 1e-2
    if mode.startswith("solve"):
        shift = 1.0 / 4096
    elif mode.startswith("tensor"):
        shift = torch.as_tensor(rng.uniform(0.5, 1.0, B) / 4096, dtype=dtype, device=dev)
    solve = shift is not None

    def run(ops):
        out = torch.full((2 * B + 1, P, Q), float("nan"), dtype=dtype, device=dev)
        ops.sine_solve2d(b, out[:-1:2], Sx, Sy, lam if solve else None, shift, ring, g)
        return out
    return run


# (B, r, c, mode): every tile side of the one-tile core (16, 32, 64, 128),
# the tile's edges (64, 128), the tiled path past 128 (one chunk and past
# the 512-state chunk), rectangular states on both sides of 64 and 128,
# 1 / 5 / 512 / 513 states, solve and transform, scalar and tensor shift,
# ring and g
K5_CASES = (
    (5, 1, 1, "solve+ring"), (5, 15, 15, "solve+ring+g"), (513, 15, 15, "tensor"),
    (5, 31, 31, "tensor+ring+g"), (512, 31, 31, "solve+ring+g"), (5, 63, 63, "solve+ring"),
    (514, 63, 63, "solve+ring"), (5, 64, 64, "tensor+ring+g"), (1, 64, 64, "transform"),
    (5, 127, 127, "solve+ring+g"), (512, 127, 127, "solve+ring"), (512, 127, 127, "transform"),
    (5, 128, 128, "tensor+ring"), (1, 128, 128, "solve"), (5, 129, 129, "solve+ring+g"),
    (1, 129, 129, "transform"), (5, 255, 255, "tensor+ring+g"), (513, 255, 255, "solve+ring"),
    (5, 40, 70, "solve+ring+g"), (5, 70, 40, "tensor"), (5, 100, 130, "solve+ring"),
    (5, 130, 100, "tensor+ring+g"), (5, 20, 9, "transform"), (5, 3, 200, "solve+ring"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,r,c,mode", K5_CASES)
def test_k5_matches_plain_on_card(cuda, dtype, B, r, c, mode):
    run = _k5_run(dtype, cuda, B, r, c, mode)
    before = DISPATCH.sine_solve2d.launches
    k = run(DISPATCH)
    torch.cuda.synchronize()
    assert DISPATCH.sine_solve2d.launches == before + 1
    p = run(PLAIN)
    assert torch.equal(torch.isnan(k), torch.isnan(p))   # the views' gaps are left alone
    w = ~torch.isnan(p)
    _agree(k[w], p[w], dtype)
    assert torch.equal(k[w], run(DISPATCH)[w])          # a fixed order


@pytest.mark.parametrize("B,r,c,mode", [(3, 7, 7, "solve+ring+g"), (4, 5, 9, "tensor"),
                                        (2, 6, 4, "transform"), (0, 5, 5, "solve+ring")])
def test_k5_cpu_takes_the_plain_version(B, r, c, mode):
    run = _k5_run(torch.float64, "cpu", B, r, c, mode)
    before = heat_kernels.sine_solve2d.launches
    got = run(DISPATCH)
    assert heat_kernels.sine_solve2d.launches == before
    assert torch.equal(got.isnan(), run(PLAIN).isnan())
    w = ~got.isnan()
    torch.testing.assert_close(got[w], run(PLAIN)[w], rtol=0, atol=0)


def test_k5_plain_matches_numpy():
    """The oracle itself: Sx ((Sx b Sy) / (1 + s lam)) Sy with the ring and
    g, against numpy."""
    rng = np.random.default_rng(13)
    r, c, B = 5, 7, 3
    Sx, Sy = sine_eigenbasis(r, 36.0)[0], sine_eigenbasis(c, 64.0)[0]
    b, lam = rng.standard_normal((B, r, c)), rng.uniform(0, 100, (r, c))
    ring, g = rng.standard_normal((r + 2, c + 2)), rng.standard_normal((B, r + 2, c + 2))
    x = Sx @ ((Sx @ b @ Sy) / (1 + 0.01 * lam)) @ Sy
    ref = np.broadcast_to(ring, g.shape).copy()
    ref[:, 1:-1, 1:-1] = x
    out = torch.empty(g.shape, dtype=torch.float64)
    t = torch.as_tensor
    heat_kernels.sine_solve2d_plain(t(b), out, t(Sx), t(Sy), t(lam), 0.01, t(ring), t(g))
    np.testing.assert_allclose(out.numpy(), g + ref, rtol=1e-13, atol=1e-14)


def test_k5_cached_checks_raise_on_every_call():
    """The same error on a second call with the same shapes (the cache
    holds no failed check)."""
    f = dict(dtype=torch.float64)
    args = dict(b=torch.zeros((3, 4, 4), **f), out=torch.empty((3, 4, 4), **f),
                Sx=torch.zeros((4, 4), **f), Sy=torch.zeros((4, 4), **f),
                lam=torch.zeros((4, 4), **f), shift=1e-3, ring=torch.zeros((6, 6), **f))
    for _ in range(2):
        with pytest.raises(ValueError, match="out has shape"):
            heat_kernels.sine_solve2d(**args)
    args["out"] = torch.empty((3, 6, 6), **f)
    heat_kernels.sine_solve2d(**args)
    for _ in range(2):
        with pytest.raises(ValueError, match="lam and shift"):
            heat_kernels.sine_solve2d(**{**args, "shift": None})


def test_k5_cpu_checks_carry_no_launch():
    f = dict(dtype=torch.float64)
    b, S = torch.zeros((2, 3, 3), **f), torch.zeros((3, 3), **f)
    present = (True, True, True, True, False, False, False, False)
    assert heat_kernels._solve_checked((fact(b), fact(b), fact(S), fact(S)), present,
                                       False) == (True, None)


def test_k5_solve_pack_layout():
    args = heat_kernels.solve_pack(2, (70000, 257), (66049, 257), (0, 0), 600, 255, 130, 512)
    assert list(args) == [2] + [0] * 9 + [70000, 257, 66049, 257, 0, 0, 600, 255, 130, 512]


@pytest.mark.parametrize("dtype,r,c,chunk,want", [
    (torch.float64, 127, 127, 0, 0),                   # the one-tile core: none
    (torch.float64, 255, 255, 128, 255 * 256 * 2 + 128 * 2 * 255 * 256),
    (torch.float64, 3, 200, 5, 3 * 4 + 200 * 200 + 5 * (200 * 4 + 3 * 200)),
    (torch.float32, 255, 255, 128, 2 * 128 * 255 * 255),
])
def test_k5_workspace(dtype, r, c, chunk, want):
    """Past the one-tile side, float64: the bases' copies and the band
    products' two buffers, every row of even length (16-byte copies);
    float32: the tiled path's two buffers."""
    assert heat_kernels.solve_workspace(dtype, r, c, chunk) == want


@pytest.mark.parametrize("B,r,c", [(1, 129, 129), (513, 255, 255), (5, 3, 200)])
def test_k5_checks_size_the_chunk(B, r, c):
    """A CUDA-free check of the launch the cached checks would make: the
    chunk of states past 128 is at most TILED_CHUNK."""
    chunk = min(B, heat_kernels.TILED_CHUNK)
    args = heat_kernels.solve_pack(0, (1, 1), (1, 1), (0, 0), B, r, c, chunk)
    assert args[16:20].tolist() == [B, r, c, chunk] and 1 <= args[19] <= 512
