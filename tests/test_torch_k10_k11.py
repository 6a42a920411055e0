"""K10 ``periodic_solve2d`` (float64 on the FP64 tensor cores through K5's
DMMA core, float32 on the FFMA cores) and K11 ``allen_cahn_pointwise`` (a
CUDA C++ stencil) against their plain PyTorch versions, their wrappers'
cached checks, plans and packed arguments.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k10_k11.py -q -m cuda --noconftest

and the rest here with ``-m 'not cuda'``.

Tolerance on the card: K10 normwise, max|kernel - plain| <= RTOL * max|plain|
with RTOL = 1e-13 (float64) and 1e-5 (float32), as the K5 tests
(``tests/test_torch_k3_k5.py``): its products sum in DMMA's k4 groups
(float64) or one FMA at a time (float32), cuBLAS in its own order.  K11
rounds each operation of its plain version once, in its order, so it
equals the plain version bit for bit in float64 and float32, NaN
included.  Each kernel repeats itself bit for bit from call to call.
K5 and K6, which share K10's float64 core, are held against their plain
versions in ``tests/test_torch_k3_k5.py`` and ``test_torch_k6_k7.py``.  The
plain versions are held against the JAX package in
``tests/test_torch_allen_cahn*.py``, ``test_torch_gray_scott.py`` and
``test_torch_burgers.py``.

The CPU tests: a CPU tensor goes to the plain version without a launch,
the cached checks raise the same errors on every call and hit the cache on
a repeat, and the plans and packed arguments are those the C launchers
read at chip_smoke.py's phase-3 shapes.
"""

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, periodic, pointwise
from pymgrit_tpu_torch.ops.heat_kernels import fact
from pymgrit_tpu_torch.ops.periodic import hartley_basis, periodic_lap_eigs

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
F64 = dict(dtype=torch.float64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, dtype, device, seed, lo=-1.0, hi=1.0):
    a = np.random.default_rng(seed).uniform(lo, hi, shape)
    if a.size == 0:                 # (numpy's empty arrays come with strides 0)
        return torch.empty(shape, dtype=dtype, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _agree(k, p, dtype):
    err = float((k - p).abs().max()) if k.numel() else 0.0
    scale = float(p.abs().max()) if p.numel() else 0.0
    assert err <= RTOL[dtype] * scale, (err, scale)


def _cuda_facts(ops, index=0):
    """The facts of these tensors as if they lay on CUDA device ``index``."""
    dev = torch.device("cuda", index)
    return tuple((t.dtype, dev, t.shape, t.stride()) for t in ops)


# ---------------------------------------------------------------------------
# K10 periodic_solve2d
# ---------------------------------------------------------------------------


def _k10_run(dtype, dev, B, S, n, mode, seed=0):
    """run(ops) -> the tensor one K10 case writes into.  The states are
    every second lane of a (2 B, L = 2, S, n, n) tube (a chain's slice:
    lane stride 2 L S n^2, species stride n^2), written into the slice
    out[:, 1] of a fresh tube (the gaps stay NaN).  mode: 'AC' (the
    Allen-Cahn prologue), 'GS' (Gray-Scott, S = 2), else none; '+g' (g a
    strided slice too), '+coef' (one coefficient a species); 'flat' reads
    and writes (B, n, n) batches instead (S = 1)."""
    dx = 1.0 / n
    H = torch.as_tensor(hartley_basis(n), dtype=dtype, device=dev)
    lam = torch.as_tensor(-periodic_lap_eigs(n, dx), dtype=dtype, device=dev)
    lo, hi = (0.0, 1.0) if "GS" in mode else (-1.0, 1.0)
    if "flat" in mode:
        b = _rand((2 * B, n, n), dtype, dev, seed + 1, lo, hi)[1::2]
        g = _rand((B, n, n), dtype, dev, seed + 2) * 1e-2 if "+g" in mode else None
    else:
        tube = _rand((2 * B, 2, S, n, n), dtype, dev, seed + 1, lo, hi)
        b = tube[::2, 0]
        g = tube[1::2, 1] * 1e-2 if "+g" in mode else None
    shift = torch.as_tensor(np.random.default_rng(seed + 3).uniform(0.5, 1.0, B) * 1e-3,
                            dtype=dtype, device=dev)
    coef = (torch.as_tensor([1.0, 0.5][:S] if S <= 2 else np.linspace(1, 2, S), dtype=dtype,
                            device=dev) if "+coef" in mode or "GS" in mode else None)
    kw = dict(g=g, coef=coef)
    if "AC" in mode:
        kw.update(nu=2, inv_eps2=625.0)
    if "GS" in mode:
        kw.update(gray_scott=(0.024, 0.084))

    def run(ops):
        if "flat" in mode:
            buf = torch.full((B, n, n), float("nan"), dtype=dtype, device=dev)
            out = buf
        else:
            buf = torch.full((B, 3, S, n, n), float("nan"), dtype=dtype, device=dev)
            out = buf[:, 1]
        ops.periodic_solve2d(b, out, H, lam, shift, **kw)
        return buf
    run.inputs = dict(b=b, shift=shift, **kw)
    return run


# (B, S, n, mode): every tile side of the one-tile kernel (n = 16, 17, 32,
# 64, 65, 127, 128: tiles of 16-128, 1-8 states a block, blocks of mixed
# lanes and species), the band route past 128 (256, and 129: an odd side's
# basis copy), the Allen-Cahn and Gray-Scott prologues, g, one coefficient
# a species, flat and tube-slice layouts, batches of 1-512 lanes
K10_CASES = (
    (5, 1, 16, "AC flat"), (9, 2, 17, "GS +g"), (512, 1, 17, "AC flat"), (3, 3, 17, "+coef +g"),
    (3, 2, 17, "GS"), (7, 2, 32, "+coef"), (5, 2, 64, "GS +g"), (4, 2, 64, "+coef"),
    (33, 1, 65, "flat"), (2, 1, 127, "AC"), (512, 1, 128, "AC flat"), (64, 1, 128, "AC +g"),
    (1, 1, 128, "AC +g"), (8, 1, 128, "flat"), (8, 2, 128, "+coef"), (8, 2, 128, "GS +g"),
    (40, 2, 128, "GS"), (3, 2, 100, "GS +g"), (64, 1, 256, "AC flat"), (3, 2, 256, "GS +g"),
    (5, 1, 129, "+coef +g"), (2, 2, 130, "AC +g"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,S,n,mode", K10_CASES)
def test_k10_matches_plain_on_card(cuda, dtype, B, S, n, mode):
    run = _k10_run(dtype, cuda, B, S, n, mode)
    before = DISPATCH.periodic_solve2d.launches
    k = run(DISPATCH)
    torch.cuda.synchronize()
    assert DISPATCH.periodic_solve2d.launches == before + 1
    p = run(PLAIN)
    assert torch.equal(torch.isnan(k), torch.isnan(p))   # the gaps are left alone
    w = ~torch.isnan(p)
    _agree(k[w], p[w], dtype)
    assert torch.equal(k[w], run(DISPATCH)[w])          # a fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [17, 128, 256])
def test_k10_nan_stays_in_its_state_on_card(cuda, dtype, n):
    """A NaN in one state's input gives NaN in that whole state's output
    (every product mixes every point) and in no other state."""
    B = 6
    H = torch.as_tensor(hartley_basis(n), dtype=dtype, device=cuda)
    lam = torch.as_tensor(-periodic_lap_eigs(n, 1.0 / n), dtype=dtype, device=cuda)
    b = _rand((B, n, n), dtype, cuda, 5)
    b[2, n // 3, n // 2] = float("nan")
    shift = torch.full((B,), 1e-3, dtype=dtype, device=cuda)
    out = DISPATCH.periodic_solve2d(b, torch.empty_like(b), H, lam, shift, nu=2, inv_eps2=625.0)
    nan = torch.isnan(out).flatten(1)
    assert bool(nan[2].all()) and not bool(nan[[0, 1, 3, 4, 5]].any())


@pytest.mark.parametrize("B,S,n,mode", [(3, 1, 6, "AC +g"), (2, 2, 5, "GS +g"),
                                        (4, 3, 4, "+coef"), (3, 1, 7, "flat"), (0, 2, 4, "GS")])
def test_k10_cpu_takes_the_plain_version(B, S, n, mode):
    run = _k10_run(torch.float64, "cpu", B, S, n, mode)
    before = periodic.periodic_solve2d.launches
    got = run(DISPATCH)
    assert periodic.periodic_solve2d.launches == before
    ref = run(PLAIN)
    assert torch.equal(got.isnan(), ref.isnan())
    w = ~got.isnan()
    torch.testing.assert_close(got[w], ref[w], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["AC +g", "GS +g", "+coef"])
def test_k10_plain_matches_numpy(mode):
    """The oracle itself on a tube slice: the IMEX right-hand side, then
    H ((H r H) / (1 + dt coef lam)) H per lane and species, plus g."""
    B, n = 3, 6
    S = 1 if "AC" in mode else 2
    run = _k10_run(torch.float64, "cpu", B, S, n, mode)
    got = run(PLAIN)[:, 1].numpy()
    kw = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in run.inputs.items()}
    Hn, lamn = hartley_basis(n), -periodic_lap_eigs(n, 1.0 / n)
    coef = kw["coef"] if kw["coef"] is not None else np.ones(S)
    ref = np.empty((B, S, n, n))
    for i in range(B):
        dt, r = kw["shift"][i], kw["b"][i].copy()
        if "AC" in mode:
            r = r + dt * ((625.0 * r) * (1.0 - r * r))
        if "GS" in mode:
            u, v = r[0].copy(), r[1].copy()
            r = r + dt * np.stack([-u * v * v + 0.024 * (1 - u), u * v * v - 0.084 * v])
        for c in range(S):
            x = Hn @ r[c] @ Hn
            ref[i, c] = Hn @ (x / (1.0 + dt * coef[c] * lamn)) @ Hn
    if kw["g"] is not None:
        ref = ref + kw["g"]
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)


def _k10_args(**over):
    args = dict(b=torch.zeros((3, 2, 8, 8), **F64), out=torch.empty((3, 2, 8, 8), **F64),
                H=torch.zeros((8, 8), **F64), lam=torch.zeros((8, 8), **F64),
                shift=torch.zeros(3, **F64), coef=torch.ones(2, **F64))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(b=torch.zeros((3, 2, 8, 7), **F64)), "expected \\(B, n, n\\)"),
    (dict(out=torch.empty((3, 2, 9, 9), **F64)), "out has shape"),
    (dict(g=torch.zeros((2, 2, 8, 8), **F64)), "g has shape"),
    (dict(H=torch.zeros((7, 7), **F64)), "H and lam"),
    (dict(lam=torch.zeros((8, 16), **F64)[:, ::2]), "contiguous"),
    (dict(shift=torch.zeros(2, **F64)), "shift must be"),
    (dict(coef=torch.zeros(3, **F64)), "coef must be"),
    (dict(nu=-1), "nu must be"),
    (dict(nu=2, gray_scott=(0.02, 0.08)), "Gray-Scott prologue"),
    (dict(lam=torch.zeros((8, 8), dtype=torch.float32)), "dtype"),
    (dict(shift=torch.zeros(6, **F64)[::2]), "shift must be"),
    (dict(out=torch.empty((3, 2, 8, 8), **F64, device="meta")), "is on meta"),
])
def test_k10_cached_checks_raise_on_every_call(over, match):
    """The same error on every call with the same facts (the cache holds
    no failed check), and a good call between them still runs."""
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            periodic.periodic_solve2d(**_k10_args(**over))
        periodic.periodic_solve2d(**_k10_args())


def test_k10_gray_scott_out_must_not_be_b():
    a = _k10_args()
    for _ in range(2):
        with pytest.raises(ValueError, match="out must not be b"):
            periodic.periodic_solve2d(**dict(a, out=a["b"], gray_scott=(0.02, 0.08)))


def test_k10_repeat_call_hits_the_cache():
    a = _k10_args()
    periodic.periodic_solve2d(**a)
    hits = periodic._checked.cache_info().hits
    periodic.periodic_solve2d(**dict(a, out=torch.empty_like(a["out"])))
    assert periodic._checked.cache_info().hits == hits + 1


@pytest.mark.parametrize("B,S,n,chunk", [
    # the workspace's chunk at chip_smoke.py's phase-3 shapes (0: the
    # one-tile kernel; past 128 the band products, float32 tiled2d)
    (512, 1, 128, 0),        # Allen-Cahn IMEX
    (64, 1, 128, 0),         # its level-1 F-step
    (64, 1, 256, 64),        # past the one-tile side
    (1024, 2, 128, 0),       # Gray-Scott IMEX
    (512, 1, 17, 0),         # n = 17
    (8, 1, 128, 0),          # the preconditioner
    (8, 2, 128, 0),          # Gray-Scott's
    (4, 2, 64, 0),           # Burgers2D's
    (8, 2, 17, 0),
    (1024, 2, 256, 512),     # chunks of 512 states
    (600, 1, 256, 512),
    (3, 2, 255, 6),
    (1, 1, 129, 1),          # the first side past the one-tile kernel
])
def test_k10_plan(B, S, n, chunk):
    assert periodic.periodic_plan(B, S, n) == chunk


@pytest.mark.parametrize("dtype,n,chunk,want", [(torch.float64, 256, 64, 256 * 256 * 129 + 64),
                                                (torch.float64, 129, 3, 129 * 130 * 7 + 3),
                                                (torch.float64, 128, 0, 0),
                                                (torch.float32, 256, 64, 2 * 64 * 256 * 256)])
def test_k10_workspace(dtype, n, chunk, want):
    assert periodic.periodic_workspace(dtype, n, chunk) == want


def test_k10_pack_layout():
    args = periodic.periodic_pack(1, (65536, 16384, 128), (49152, 16384, 128), (0, 0, 0), 512, 2,
                                  128, 2, 0, 0)
    assert list(args) == [1] + [0] * 8 + [65536, 16384, 128, 49152, 16384, 128, 0, 0, 0, 512, 2,
                                          128, 2, 0, 0]


def test_k10_cpu_checks_carry_no_launch():
    a = _k10_args()
    ops = [a[k] for k in ("b", "out", "H", "lam", "shift", "coef")]
    present = (True,) * 6 + (False,)
    assert periodic._checked(tuple(map(fact, ops)), present, 0, False) == (True, None)


@pytest.mark.parametrize("B,S,n,mode,want_mode,want_chunk", [
    (512, 1, 128, "AC flat", 1, 0),
    (64, 1, 256, "AC flat", 1, 64),
    (1024, 2, 128, "GS +g", 2, 0),
    (512, 1, 17, "AC +g", 1, 0),
    (8, 1, 128, "flat", 0, 0),
    (8, 2, 128, "+coef", 0, 0),
])
def test_k10_launch_the_checks_would_make(monkeypatch, B, S, n, mode, want_mode, want_chunk):
    """A CUDA-free look at the launch the cached checks build for a CUDA
    call: the (lane, species, row) strides of the tube slices, the mode,
    the plan and the workspace, packed in the launcher's order."""
    monkeypatch.setattr(periodic, "_launcher", lambda name, dt: (name, dt))
    periodic._checked.cache_clear()
    try:
        nn = n * n
        if "flat" in mode:
            b = torch.empty((2 * B, n, n), **F64)[1::2]
            out = torch.empty((B, n, n), **F64)
            bs, os = (2 * nn, 0, n), (nn, 0, n)
        else:
            b = torch.empty((2 * B, 2, S, n, n), **F64)[::2, 0]
            out = torch.empty((B, 3, S, n, n), **F64)[:, 1]
            bs, os = (4 * S * nn, nn, n), (3 * S * nn, nn, n)
        g = out if "+g" in mode else None
        H, shift = torch.empty((n, n), **F64), torch.empty(B, **F64)
        coef = torch.empty(S, **F64) if "+coef" in mode or "GS" in mode else None
        ops = (b, out, H, H, shift, coef, g)
        present = tuple(t is not None for t in ops)
        on_cpu, (args, fn, index, ws) = periodic._checked(
            _cuda_facts([t for t in ops if t is not None], 1), present,
            2 if "AC" in mode else 0, "GS" in mode)
        assert not on_cpu and fn == ("pm_periodic_solve2d", torch.float64) and index == 1
        gs = os if g is not None else (0, 0, 0)
        assert list(args[9:]) == [*bs, *os, *gs, B, S, n, want_mode, 2 if "AC" in mode else 0,
                                  want_chunk]
        assert ws == periodic.periodic_workspace(torch.float64, n, want_chunk)
    finally:
        periodic._checked.cache_clear()


# ---------------------------------------------------------------------------
# K11 allen_cahn_pointwise
# ---------------------------------------------------------------------------


def _k11_run(dtype, dev, mode, B, n, seed=0, nan_lane=None, layout=""):
    """run(ops) -> the tensor (or residual and max, concatenated) one K11
    case gives: u from every second state of a tube (a strided batch), x
    and rhs their own; nan_lane puts a NaN (and an inf) in that lane's rhs
    (residual) or x.  layout 'rows' gives u rows at a stride past n (no
    16-byte vectors); 'odd' offsets u by one element."""
    if layout == "rows":
        u = _rand((2 * B, n, n + 3), dtype, dev, seed + 1)[::2, :, :n]
    elif layout == "odd":
        u = _rand((B * n * n + 1,), dtype, dev, seed + 1)[1:].view(B, n, n)
    else:
        u = _rand((2 * B, n, n), dtype, dev, seed + 1)[::2]
    other = _rand((B, n, n), dtype, dev, seed + 2)
    if nan_lane is not None:
        other[nan_lane, n // 2, n // 3] = float("nan")
        other[nan_lane, 0, n - 1] = float("inf")
    fac = torch.as_tensor(np.random.default_rng(seed + 3).uniform(0.5, 1.0, B) * 1e-3,
                          dtype=dtype, device=dev)
    dx2 = (1.0 / n) ** 2

    def run(ops):
        out = torch.full((B, n, n), float("nan"), dtype=dtype, device=dev)
        r = ops.allen_cahn_pointwise(mode, u, out, fac, 625.0, dx2, 2, x=other, rhs=other)
        return torch.cat([r[0].flatten(), r[1]]) if mode == "residual" else r
    return run


def _same_bits(a, b):
    """Bit for bit, NaN for NaN (a NaN's payload aside)."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    w = ~torch.isnan(a)
    assert torch.equal(a[w], b[w])


# (mode, B, n, layout, nan_lane): the three modes at the sides of phase 3
# (128: 16-byte vectors; 17: scalars), one and many states, strided rows,
# a misaligned base, lanes holding a NaN
K11_CASES = (
    ("jacobian", 8, 128, "", None), ("residual", 8, 128, "", None), ("rhs", 8, 128, "", None),
    ("residual", 512, 17, "", None), ("jacobian", 3, 17, "", None), ("rhs", 1, 17, "", None),
    ("residual", 5, 128, "", 2), ("residual", 4, 17, "", 0), ("jacobian", 4, 32, "", 1),
    ("jacobian", 2, 64, "rows", None), ("residual", 3, 64, "odd", None), ("rhs", 2, 300, "", None),
    ("residual", 2, 1024, "", 1), ("residual", 1, 1, "", None), ("jacobian", 6, 2, "", None),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode,B,n,layout,nan_lane", K11_CASES)
def test_k11_bit_for_bit_on_card(cuda, dtype, mode, B, n, layout, nan_lane):
    run = _k11_run(dtype, cuda, mode, B, n, nan_lane=nan_lane, layout=layout)
    before = DISPATCH.allen_cahn_pointwise.launches
    k = run(DISPATCH)
    torch.cuda.synchronize()
    assert DISPATCH.allen_cahn_pointwise.launches == before + 1   # one launch, max included
    _same_bits(k, run(PLAIN))
    _same_bits(k, run(DISPATCH))
    if nan_lane is not None and mode == "residual":
        assert bool(torch.isnan(k[-B:][nan_lane]))


@pytest.mark.cuda
def test_k11_residual_max_on_card_after_a_larger_batch(cuda):
    """The workspace the residual's max folds through is left zeroed: a
    small batch after a large one (and after a NaN lane) gets its own
    maxima."""
    for B, nan_lane in ((600, 7), (3, None), (600, None), (2, 1)):
        run = _k11_run(torch.float64, cuda, "residual", B, 16, seed=B, nan_lane=nan_lane)
        _same_bits(run(DISPATCH), run(PLAIN))


@pytest.mark.parametrize("mode,B,n,nan_lane", [("jacobian", 3, 6, None), ("residual", 4, 5, 1),
                                               ("rhs", 2, 7, None), ("residual", 0, 4, None)])
def test_k11_cpu_takes_the_plain_version(mode, B, n, nan_lane):
    run = _k11_run(torch.float64, "cpu", mode, B, n, nan_lane=nan_lane)
    before = pointwise.allen_cahn_pointwise.launches
    got = run(DISPATCH)
    assert pointwise.allen_cahn_pointwise.launches == before
    _same_bits(got, run(PLAIN))
    if nan_lane is not None:
        assert bool(torch.isnan(got[-B:][nan_lane])) and not bool(torch.isnan(got[-B:][0]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k11_laplacian_divides_by_dx2(dtype):
    """periodic_lap_plain divides by dx^2 (the kernel's __ddiv_rn), which on
    the CPU is Python's division by the scalar."""
    x = _rand((2, 9, 9), dtype, "cpu", 3)
    d = 1.0 / 81
    want = ((((torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) + torch.roll(x, 1, 2))
             + torch.roll(x, -1, 2)) - 4.0 * x) / d
    assert torch.equal(pointwise.periodic_lap_plain(x, d), want)


def _k11_args(**over):
    args = dict(mode="residual", u=torch.zeros((3, 8, 8), **F64),
                out=torch.empty((3, 8, 8), **F64), fac=torch.zeros(3, **F64), inv_eps2=625.0,
                dx2=1.0, nu=2, rhs=torch.zeros((3, 8, 8), **F64))
    args.update(over)
    return args


@pytest.mark.parametrize("over,match", [
    (dict(mode="lap"), "mode must be"),
    (dict(mode="jacobian"), "needs x"),
    (dict(rhs=None), "needs rhs"),
    (dict(fac=torch.zeros(2, **F64)), "fac must be"),
    (dict(fac=torch.zeros(6, **F64)[::2]), "fac must be"),
    (dict(nu=0), "nu must be"),
    (dict(rhs=torch.zeros((3, 8, 9), **F64)), "rhs has shape"),
    (dict(out=torch.zeros((3, 9, 8), **F64)), "out has shape"),
    (dict(u=torch.zeros((3, 8, 9), **F64)), "expected \\(B, n, n\\)"),
    (dict(rhs=torch.zeros((3, 8, 8))), "dtype"),
    (dict(u=torch.zeros((3, 8, 16), **F64)[:, :, ::2]), "contiguous"),
    (dict(u=torch.zeros((3, 0, 0), **F64), out=torch.empty((3, 0, 0), **F64),
          rhs=torch.zeros((3, 0, 0), **F64)), "side n >= 1"),
])
def test_k11_cached_checks_raise_on_every_call(over, match):
    """The same error on every call with the same facts, and a good call
    between them still runs."""
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            pointwise.allen_cahn_pointwise(**_k11_args(**over))
        pointwise.allen_cahn_pointwise(**_k11_args())


def test_k11_repeat_call_hits_the_cache():
    a = _k11_args()
    pointwise.allen_cahn_pointwise(**a)
    hits = pointwise._checked.cache_info().hits
    pointwise.allen_cahn_pointwise(**dict(a, out=torch.empty_like(a["out"])))
    assert pointwise._checked.cache_info().hits == hits + 1


@pytest.mark.parametrize("B,n,itemsize,strides,want", [
    # (vector width, TX, TY, units a block, grid) on 132 SMs; past 1056
    # units a block walks several (n = 17: two units of 8 rows)
    (8, 128, 8, (32768, 128, 16384, 128, 0, 0, 16384, 128), (2, 64, 4, 1, 256)),
    (512, 17, 8, (578, 17, 0, 0, 289, 17, 289, 17), (1, 32, 8, 2, 768)),
    (8, 128, 4, (32768, 128, 16384, 128, 0, 0, 16384, 128), (4, 32, 8, 1, 128)),
    (2, 64, 8, (8192, 67, 4096, 64, 0, 0, 4096, 64), (1, 64, 4, 1, 32)),
    (2, 1024, 8, (2 ** 20, 1024) * 4, (2, 256, 1, 2, 1024)),
    (1, 1, 8, (1, 1) * 4, (1, 32, 8, 1, 1)),
    (2, 300, 8, (180000, 300, 0, 0, 0, 0, 90000, 300), (2, 256, 1, 1, 600)),
    (2, 300, 4, (180000, 300, 0, 0, 0, 0, 90000, 300), (4, 128, 2, 1, 300)),
])
def test_k11_plan(B, n, itemsize, strides, want):
    assert pointwise.plan(B, n, itemsize, strides, 132) == want


def test_k11_pack_layout():
    args = pointwise.pack(2, (32768, 128, 16384, 128, 0, 0, 16384, 128), 8, 128, 2, 2,
                          (2, 64, 4, 1, 256))
    assert list(args) == [2] + [0] * 7 + [32768, 128, 16384, 128, 0, 0, 16384, 128, 8, 128, 2,
                                          2, 2, 64, 4, 1, 256]


@pytest.mark.parametrize("mode", ["rhs", "residual", "jacobian"])
def test_k11_launch_the_checks_would_make(monkeypatch, mode):
    """A CUDA-free look at the launch the cached checks build for a CUDA
    call on the phase-3 shapes (B = 8 of 128^2, u every second state of a
    tube): the strides in the launcher's order (x's for the Jacobian,
    rhs's for the residual), the mode and the plan."""
    monkeypatch.setattr(pointwise, "_launcher", lambda name, dt: (name, dt))
    monkeypatch.setattr(pointwise._build, "sm_count", lambda index: 132)
    pointwise._checked.cache_clear()
    try:
        B, n = 8, 128
        u = torch.empty((2 * B, n, n), **F64)[::2]
        out, other, fac = torch.empty((B, n, n), **F64), torch.empty((B, n, n), **F64), \
            torch.empty(B, **F64)
        ops = (u, out, fac) if mode == "rhs" else (u, out, fac, other)
        on_cpu, (args, fn, index, gmax) = pointwise._checked(mode, _cuda_facts(ops, 1), 2)
        assert not on_cpu and fn == ("pm_allen_cahn_pointwise", torch.float64) and index == 1
        assert gmax == (B, torch.float64, torch.device("cuda", 1))
        xs = (n * n, n) if mode == "jacobian" else (0, 0)
        rs = (n * n, n) if mode == "residual" else (0, 0)
        assert list(args[8:]) == [2 * n * n, n, *xs, *rs, n * n, n, B, n, 2,
                                  pointwise.AC_MODES.index(mode), 2, 64, 4, 1, 256]
    finally:
        pointwise._checked.cache_clear()
