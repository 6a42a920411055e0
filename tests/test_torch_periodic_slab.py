"""The kernel modes of the periodic models' space slabs: K11, K14 and K15 in
their halo modes, K11's and K14's IMEX prologue modes, and K20
``sine_solve1d`` on the Hartley basis (the pencil's passes).

Held on the CPU (the plain versions and the wrappers' checks, plans,
packed arguments and launches, with numpy-free stand-ins of the launchers):

* each halo mode's plain version on every slab of a state (n_space 2 and
  4), given the neighbouring slabs' edge rows, equals the whole-state plain
  version's rows bit for bit (the same operations on the same values), and
  the slabs' residual maxima reduce to the whole state's;
* each prologue mode's plain version equals ``periodic_solve2d_plain``'s
  prologue bit for bit (K10 with H = I and lam = 0 returns its prologue
  exactly);
* K20's transform and BE x-pass with a lam table on the Hartley basis
  (odd and even n) against numpy products, to rounding.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  On the card

    python -m pytest tests/test_torch_periodic_slab.py -q -m cuda --noconftest

holds each new mode against its plain version on the card: the halo and
prologue modes bit for bit (NaN included), K20 on H within 1e-13 of the
largest entry.
"""

import ctypes

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, heat_kernels, periodic, pointwise
from pymgrit_tpu_torch.ops.periodic import hartley_basis, periodic_lap_eigs

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
AC = dict(inv_eps2=625.0, dx2=1.0 / 256, nu=2)
GS = dict(du=2e-2, dv=1e-2, a=0.024, b=0.084, dx2=(2.0 / 16) ** 2)
NU, DX = 0.05, 1.0 / 16
# the modes with a stencil, by kernel ("ac" K11, "gs" K14, "b2" K15)
STENCIL_MODES = {"ac": ("rhs", "residual", "jacobian"), "gs": ("expl", "residual", "jacobian"),
                 "b2": ("residual", "jacobian")}
CASES = [(k, m) for k, modes in STENCIL_MODES.items() for m in modes]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rand(shape, dtype=torch.float64, device="cpu", seed=0, lo=-1.0, hi=1.0):
    return torch.as_tensor(np.random.default_rng(seed).uniform(lo, hi, shape), dtype=dtype,
                           device=device)


def _operands(kernel, mode, B, n, dtype, device, seed):
    """Whole-state operands of one call: (state, the other operand or
    None, the per-lane steps); the Laplacian's operand is the other one in
    the Jacobian (and s too in K15's)."""
    shape = (B, n, n) if kernel == "ac" else (B, 2, n, n)
    lo = 0.0 if kernel == "gs" else -1.0
    s = _rand(shape, dtype, device, seed, lo)
    other = _rand(shape, dtype, device, seed + 1) if mode != "rhs" or kernel != "ac" else None
    if mode == "expl":
        other = None
    dt = _rand((B,), dtype, device, seed + 2, 0.01, 0.1)
    return s, other, dt


def _call(ops, kernel, mode, s, other, dt, halo=None, w_halo=None, g=None):
    """One call of a kernel's wrapper (or plain version) in ``ops``; the
    residual's output and per-lane max as a pair, else the output."""
    out = torch.empty_like(s)
    if kernel == "ac":
        return ops.allen_cahn_pointwise(mode, s, out, dt, AC["inv_eps2"], AC["dx2"], AC["nu"],
                                        x=other if mode == "jacobian" else None,
                                        rhs=other if mode == "residual" else None, halo=halo)
    if kernel == "gs":
        return ops.gray_scott_pointwise(mode, s, out, dt, GS["du"], GS["dv"], GS["a"], GS["b"],
                                        GS["dx2"], r=other if mode == "residual" else None,
                                        w=other if mode == "jacobian" else None, g=g, halo=halo)
    return ops.burgers2d_pointwise(mode, s, out, dt, NU, DX,
                                   r=other if mode == "residual" else None,
                                   w=other if mode == "jacobian" else None, halo=halo,
                                   w_halo=w_halo)


def _slab(x, s, n_space):
    """Slab s of n_space of x's rows (axis -2), and its halo: the rows
    above and below it (periodic)."""
    n = x.shape[-2]
    R = n // n_space
    rows = x.narrow(-2, s * R, R).contiguous()
    return rows, (x.select(-2, (s * R - 1) % n).contiguous(),
                  x.select(-2, (s + 1) * R % n).contiguous())


def _slab_call(ops, kernel, mode, s_, other, dt, k, n_space, g=None):
    """The call on slab k of n_space: its halo rows those of the Laplacian's
    operand (K15: s's, and w's in the Jacobian)."""
    ss, s_halo = _slab(s_, k, n_space)
    os_, o_halo = _slab(other, k, n_space) if other is not None else (None, None)
    gs_ = _slab(g, k, n_space)[0] if g is not None else None
    halo = o_halo if (mode == "jacobian" and kernel != "b2") else s_halo
    w_halo = o_halo if (kernel == "b2" and mode == "jacobian") else None
    return _call(ops, kernel, mode, ss, os_, dt, halo, w_halo, gs_)


@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("kernel,mode", CASES)
def test_halo_mode_plain_equals_whole_state(kernel, mode, n_space):
    """Each slab's plain halo call equals the whole-state plain call's rows
    bit for bit; the slabs' residual maxima's max is the whole state's."""
    B, n = 3, 16
    s_, other, dt = _operands(kernel, mode, B, n, torch.float64, "cpu", 7)
    g = _rand(s_.shape, seed=9) if mode == "expl" else None
    want = _call(PLAIN, kernel, mode, s_, other, dt, g=g)
    R = n // n_space
    maxima = []
    for k in range(n_space):
        got = _slab_call(PLAIN, kernel, mode, s_, other, dt, k, n_space, g)
        if mode == "residual":
            got, gmax = got
            maxima.append(gmax)
        w = want[0] if mode == "residual" else want
        assert torch.equal(got, w.narrow(-2, k * R, R)), k
    if mode == "residual":
        assert torch.equal(torch.stack(maxima).amax(0), want[1])


@pytest.mark.parametrize("kernel,mode", CASES)
def test_halo_mode_dispatch_runs_plain_on_the_cpu(kernel, mode):
    """On CPU tensors the wrapper's halo call is the plain version's, and it
    counts no launch."""
    s_, other, dt = _operands(kernel, mode, 2, 8, torch.float64, "cpu", 3)
    fn = getattr(pointwise, {"ac": "allen_cahn_pointwise", "gs": "gray_scott_pointwise",
                             "b2": "burgers2d_pointwise"}[kernel])
    before = dict(fn.mode_launches)
    got = _slab_call(DISPATCH, kernel, mode, s_, other, dt, 1, 2)
    want = _slab_call(PLAIN, kernel, mode, s_, other, dt, 1, 2)
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        assert torch.equal(a, b)
    assert fn.mode_launches == before


@pytest.mark.parametrize("kernel", ["ac", "gs"])
def test_prologue_plain_equals_k10_prologue(kernel):
    """The prologue mode's plain version is K10's plain prologue bit for
    bit: K10 with H = I and lam = 0 returns its right-hand side exactly."""
    B, n = 3, 12
    s_, _, dt = _operands(kernel, "prologue", B, n, torch.float64, "cpu", 5)
    eye, zero = torch.eye(n, **F64), torch.zeros((n, n), **F64)
    if kernel == "ac":
        want = periodic.periodic_solve2d_plain(s_, torch.empty_like(s_), eye, zero, dt,
                                               nu=AC["nu"], inv_eps2=AC["inv_eps2"])
    else:
        want = periodic.periodic_solve2d_plain(s_, torch.empty_like(s_), eye, zero, dt,
                                               coef=torch.tensor([GS["du"], GS["dv"]], **F64),
                                               gray_scott=(GS["a"], GS["b"]))
    got = _call(PLAIN, kernel, "prologue", s_, None, dt)
    assert torch.equal(got, want)
    # pointwise: a slab of rows is the state's rows
    rows = s_.narrow(-2, 4, 5)
    assert torch.equal(_call(DISPATCH, kernel, "prologue", rows, None, dt), want.narrow(-2, 4, 5))


def test_halo_checks():
    """A halo row of the wrong shape, a prologue with a halo, a slab
    without one, and K15's Jacobian on a slab without w's halo raise."""
    u, dt = torch.zeros((2, 4, 8), **F64), torch.ones(2, **F64)
    row = torch.zeros((2, 8), **F64)
    pw = pointwise
    with pytest.raises(ValueError, match="expected \\(B, n, n\\)"):
        pw.allen_cahn_pointwise("rhs", u, torch.empty_like(u), dt, 1.0, 1.0, 2)
    with pytest.raises(ValueError, match="halo row below"):
        pw.allen_cahn_pointwise("rhs", u, torch.empty_like(u), dt, 1.0, 1.0, 2,
                                halo=(row, torch.zeros((2, 7), **F64)))
    with pytest.raises(ValueError, match="takes no halo"):
        pw.allen_cahn_pointwise("prologue", u, torch.empty_like(u), dt, 1.0, 1.0, 2,
                                halo=(row, row))
    s = torch.zeros((2, 2, 4, 8), **F64)
    prow = torch.zeros((2, 2, 8), **F64)
    with pytest.raises(ValueError, match="needs w's halo"):
        pw.burgers2d_pointwise("jacobian", s, torch.empty_like(s), dt, NU, DX, w=s,
                               halo=(prow, prow))
    with pytest.raises(ValueError, match="contiguous"):
        pw.gray_scott_pointwise("residual", s, torch.empty_like(s), dt, 1.0, 1.0, 0.0, 0.0, 1.0,
                                r=s, halo=(prow, torch.zeros((2, 8, 2), **F64).transpose(1, 2)))
    with pytest.raises(ValueError, match="w's halo belongs"):
        pw.burgers2d_pointwise("residual", s, torch.empty_like(s), dt, NU, DX, r=s,
                               halo=(prow, prow), w_halo=(prow, prow))


def _cuda_facts(ops, index=0):
    dev = torch.device("cuda", index)
    return tuple(None if t is None else (t.dtype, dev, t.shape, t.stride()) for t in ops)


def test_slab_plan_and_pack():
    """A slab of R rows is cut into units of its rows, not n's; the packed
    arrays end in R and the halo pointer slots."""
    # (B, n) = (8, 128), 64 rows a slab: 8 * 16 units of 4 rows on 132 SMs
    strides = (64 * 128, 128) * 4
    assert pointwise.plan(8, 128, 8, strides, 132, rows=64) == (2, 64, 4, 1, 128)
    assert pointwise.plan(8, 128, 8, strides, 132) == (2, 64, 4, 1, 256)
    args = pointwise.pack(0, strides, 8, 128, 2, 1, (2, 64, 4, 1, 128), 64)
    assert list(args[-8:]) == [2, 64, 4, 1, 128, 64, 0, 0]
    args = pointwise.pair_pack(0, (1,) * 15, 8, 128, 2, (2, 64, 4, 1, 128), 64)
    assert len(args) == 37 and list(args[-5:]) == [64, 0, 0, 0, 0]


class _Launcher:
    """A stand-in for a C launcher: records the packed array."""

    def __init__(self, slots):
        self.slots, self.calls = slots, []

    def __call__(self, address, *rest):
        self.calls.append(list((ctypes.c_int64 * self.slots).from_address(address)))
        return 0


@pytest.mark.parametrize("kernel,mode", CASES + [("ac", "prologue"), ("gs", "prologue")])
def test_halo_launch_the_checks_would_make(monkeypatch, kernel, mode):
    """A CUDA-free look at the launch of a halo (or prologue) call on a
    slab of 4 of 16 rows: the rows R in the plan's units and the packed
    array, and the halo rows' pointers in their slots (K11 26-27, K14 and
    K15 33-34, K15's w 35-36)."""
    monkeypatch.setattr(pointwise, "_launcher", lambda name, dt: (name, dt))
    monkeypatch.setattr(pointwise._build, "sm_count", lambda index: 132)
    monkeypatch.setattr(pointwise._build, "stream", lambda index: 0)
    ws = torch.zeros(64, dtype=torch.int64)
    monkeypatch.setattr(pointwise, "_workspace", lambda index, stream, B: ws)
    B, n, R = 3, 16, 4
    s_, other, dt = _operands(kernel, mode, B, n, torch.float64, "cpu", 1)
    prologue = mode == "prologue"
    ss, sh = _slab(s_, 1, 4)
    os_, oh = _slab(other, 1, 4) if other is not None else (None, None)
    halo = None if prologue else (oh if mode == "jacobian" and kernel != "b2" else sh)
    w_halo = oh if kernel == "b2" and mode == "jacobian" else None
    fn = _Launcher(28 if kernel == "ac" else 37)
    if kernel == "ac":
        real = pointwise._checked.__wrapped__
        ops = (ss, ss, dt) + ((os_,) if mode in ("jacobian", "residual") else ())
        ops += tuple(halo) if halo is not None else ()
        on_cpu, (args, _, index, _) = real(mode, _cuda_facts(ops), 2, halo is not None)
        launch = (args, fn, index, (B, torch.float64, torch.device("cpu")))
        monkeypatch.setattr(pointwise, "_checked", lambda *key: (False, launch))
    else:
        name = "gray_scott_pointwise" if kernel == "gs" else "burgers2d_pointwise"
        real = pointwise._pair_checked.__wrapped__
        r = os_ if mode == "residual" else None
        w = os_ if mode == "jacobian" else None
        on_cpu, (args, _, index, _) = real(name, mode, _cuda_facts(
            (ss, ss, dt, r, w, None) + tuple(halo or (None, None))
            + tuple(w_halo or (None, None))))
        launch = (args, fn, index, (B, torch.float64, torch.device("cpu")))
        monkeypatch.setattr(pointwise, "_pair_checked", lambda *key: (False, launch))
    assert not on_cpu
    plan = pointwise.plan(B, n, 8, [0] * 8, 132, rows=R)
    _call(DISPATCH, kernel, mode, ss, os_, dt, halo, w_halo)
    packed, = fn.calls
    if kernel == "ac":
        assert packed[20:25] == list(plan) and packed[25] == R
        slots = packed[26:28]
        want = [0, 0] if halo is None else [halo[0].data_ptr(), halo[1].data_ptr()]
    else:
        assert packed[27:32] == list(plan) and packed[32] == R
        slots = packed[33:37]
        want = [t.data_ptr() if t is not None else 0
                for t in tuple(halo or (None, None)) + tuple(w_halo or (None, None))]
    assert slots == want


@pytest.mark.parametrize("n", [15, 16, 33])
def test_k20_on_the_hartley_basis_plain(n):
    """K20's transform (x H) and BE x-pass with a lam table on the Hartley
    basis H (real, symmetric, orthogonal; odd and even n), against numpy
    products: row b divided by 1 + dt_b table[b % D]."""
    rng = np.random.default_rng(n)
    H_np = hartley_basis(n)
    np.testing.assert_allclose(H_np @ H_np, np.eye(n), atol=1e-13)
    np.testing.assert_array_equal(H_np, H_np.T)
    D, B = 3, 12
    lam_np = -periodic_lap_eigs(n, 1.0 / n)[:, :D].T.copy()
    x_np = rng.uniform(-1, 1, (B, n))
    dt_np = rng.uniform(1e-3, 1e-2, B)
    H, lam, x, dt = (torch.as_tensor(a) for a in (H_np, lam_np, x_np, dt_np))
    y = heat_kernels.sine_solve1d(x, torch.empty_like(x), H)
    np.testing.assert_allclose(y.numpy(), x_np @ H_np, rtol=0, atol=1e-14 * n)
    z = heat_kernels.sine_solve1d(x, torch.empty_like(x), H, lam, dt)
    want = ((x_np @ H_np) / (1 + dt_np[:, None] * lam_np[np.arange(B) % D])) @ H_np
    np.testing.assert_allclose(z.numpy(), want, rtol=0, atol=1e-14 * n)
    # the plans take the basis as any (n, n) table: the two products of a
    # solve, one of a transform
    first, second = heat_kernels.sine_solve1d_plans(x, H, lam)
    assert first is not None and (second is not None) == (not heat_kernels.k20_fused(n, 1))
    assert heat_kernels.sine_solve1d_plans(x, H)[1] is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _same_bits(a, b):
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    w = ~torch.isnan(a)
    assert torch.equal(a[w], b[w])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,n_space", [(128, 2), (16, 4), (17, 1)])
@pytest.mark.parametrize("kernel,mode", CASES)
def test_halo_mode_bit_for_bit_on_card(cuda, dtype, n, n_space, kernel, mode):
    """Each halo mode on the card against its plain version on the card, on
    one slab (n = 17: a slab of the whole side with its own edge rows as
    halo, scalar loads), and a NaN in one lane's halo row reaching that
    lane's residual max."""
    B = 4
    s_, other, dt = _operands(kernel, mode, B, n, dtype, cuda, 21)
    g = _rand(s_.shape, dtype, cuda, 23) if mode == "expl" else None
    if mode == "residual":
        s_[1].view(-1)[0] = float("nan")       # row 0 of lane 1: the halo of slab n_space - 1
    for k in sorted({0, n_space - 1}):
        got = _slab_call(DISPATCH, kernel, mode, s_, other, dt, k, n_space, g)
        want = _slab_call(PLAIN, kernel, mode, s_, other, dt, k, n_space, g)
        torch.cuda.synchronize()
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["ac", "gs"])
@pytest.mark.parametrize("R,n", [(64, 128), (5, 17), (16, 16)])
def test_prologue_bit_for_bit_on_card(cuda, dtype, kernel, R, n):
    B = 6
    s_, _, dt = _operands(kernel, "prologue", B, n, dtype, cuda, 31)
    rows = s_.narrow(-2, 0, R)
    got = _call(DISPATCH, kernel, "prologue", rows, None, dt)
    want = _call(PLAIN, kernel, "prologue", rows, None, dt)
    torch.cuda.synchronize()
    _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,D", [(128, 2 * 8 * 64, 64), (128, 128, 64), (16, 96, 8),
                                   (17, 34, 17)])
def test_k20_hartley_on_card(cuda, n, B, D):
    """K20's transform and lam-table x-pass on H on the card against the
    plain version on the card, within 1e-13 of the largest entry."""
    rng = np.random.default_rng(n + B)
    H = torch.as_tensor(hartley_basis(n), device=cuda)
    lam = torch.as_tensor(-periodic_lap_eigs(n, 1.0 / n)[:, :D].T.copy(), device=cuda)
    x = torch.as_tensor(rng.uniform(-1, 1, (B, n)), device=cuda)
    dt = torch.as_tensor(rng.uniform(1e-4, 1e-3, B), device=cuda)
    for args in ((H,), (H, lam, dt)):
        got = heat_kernels.sine_solve1d(x, torch.empty_like(x), *args)
        want = heat_kernels.sine_solve1d_plain(x, torch.empty_like(x), *args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-13, (args[1:] and "x-pass", err)
