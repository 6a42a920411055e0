"""K14 ``gray_scott_pointwise`` and K15 ``burgers2d_pointwise`` (CUDA C++
stencils on ``csrc/periodic_pointwise.cuh``, K11's one-call launch path)
against their plain PyTorch versions; their wrappers' cached checks,
plans, packed arguments and launches; the plain central differences; and
the plain Burgers2D operators against the JAX package.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k14_k15.py -q -m cuda --noconftest

and the rest here with ``-m 'not cuda'`` (the JAX package is imported by
the test that compares with it, never by the ``cuda`` ones).

Tolerances.  K14 and K15 round each operation of their plain versions
once, in their order, so the kernels equal the plain versions bit for bit
in float64 and float32, NaN included, and each call repeats itself.  The
plain Burgers2D residual and Jacobian are held against the JAX package's
``g_of`` and ``jac_mv`` at rtol 1e-12 against the largest entry, as
``tests/test_torch_gray_scott.py`` holds Gray-Scott's (XLA may contract or
reorder the same expressions).  On the card the plain Burgers2D operators
equal their CPU runs bit for bit (true divisions by 2 dx on both).
"""

import ctypes

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, pointwise
from pymgrit_tpu_torch.ops.heat_kernels import fact

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64)
GS = dict(du=2e-2, dv=1e-2, a=0.024, b=0.084)   # du, dv large enough that L matters
NU = 0.05


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


def _same_bits(a, b):
    """Bit for bit, NaN for NaN (a NaN's payload aside)."""
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    w = ~torch.isnan(a)
    assert torch.equal(a[w], b[w])


def _cuda_facts(ops, index=0):
    """The facts of these tensors (None stays None) as if they lay on CUDA
    device ``index``."""
    dev = torch.device("cuda", index)
    return tuple(None if t is None else (t.dtype, dev, t.shape, t.stride()) for t in ops)


def _pair_run(kernel, dtype, dev, mode, B, n, seed=0, nan_lane=None, layout="", with_g=False):
    """run(ops) -> the tensor (or residual and max, concatenated) one K14
    ("gs") or K15 ("b2") case gives.  s is every second pair of a tube (a
    strided batch); w, r and g are slices of one other tube; nan_lane puts
    a NaN in that lane and an inf in the next of r (residual), w (Jacobian)
    or s (EXPL).  layout 'rows' gives s rows at a stride past n (no 16-byte
    vectors); 'odd' offsets s by one element."""
    lo = 0.0 if kernel == "gs" else -1.0
    if layout == "rows":
        s = _rand((2 * B, 2, n, n + 3), dtype, dev, seed + 1, lo)[::2, :, :, :n]
    elif layout == "odd":
        s = _rand((B * 2 * n * n + 1,), dtype, dev, seed + 1, lo)[1:].view(B, 2, n, n)
    else:
        s = _rand((2 * B, 2, n, n), dtype, dev, seed + 1, lo)[::2]
    tube = _rand((B, 3, 2, n, n), dtype, dev, seed + 2)
    w, r, g = tube[:, 0], tube[:, 1], tube[:, 2] * 1e-3
    if nan_lane is not None:
        x = {"residual": r, "jacobian": w}.get(mode, s)
        x[nan_lane, 0, n // 2, n // 3] = float("nan")
        x[(nan_lane + 1) % B, 1, 0, n - 1] = float("inf")
    dt = torch.as_tensor(np.random.default_rng(seed + 3).uniform(0.5, 1.0, B)
                         * (0.5 if kernel == "gs" else 1e-2), dtype=dtype, device=dev)

    def run(ops):
        out = torch.full((B, 2, n, n), float("nan"), dtype=dtype, device=dev)
        kw = dict(r=r if mode == "residual" else None, w=w if mode == "jacobian" else None)
        if kernel == "gs":
            res = ops.gray_scott_pointwise(mode, s, out, dt, GS["du"], GS["dv"], GS["a"],
                                           GS["b"], (2.0 / n) ** 2, g=g if with_g else None, **kw)
        else:
            res = ops.burgers2d_pointwise(mode, s, out, dt, NU, 1.0 / n, **kw)
        return torch.cat([res[0].flatten(), res[1]]) if mode == "residual" else res
    return run


def _counter(kernel):
    return getattr(pointwise, {"gs": "gray_scott_pointwise", "b2": "burgers2d_pointwise"}[kernel])


# (kernel, mode, B, n, layout, nan_lane, with_g): every mode at chip_smoke's
# phase-3 shapes (K14: 8 pairs of 128^2, 128 + g, 1024 of 17^2; K15: 4 of
# 64^2 and 17^2), odd and even sides (16-byte vectors or scalars), one and
# many lanes, strided rows, a misaligned base, lanes holding a NaN and an inf
PAIR_CASES = (
    ("gs", "jacobian", 8, 128, "", None, False), ("gs", "residual", 8, 128, "", None, False),
    ("gs", "expl", 128, 128, "", None, True), ("gs", "residual", 1024, 17, "", None, False),
    ("gs", "expl", 3, 17, "", None, False), ("gs", "expl", 5, 32, "", None, True),
    ("gs", "jacobian", 3, 17, "", 1, False), ("gs", "residual", 5, 64, "", 2, False),
    ("gs", "residual", 4, 17, "", 0, False), ("gs", "jacobian", 2, 64, "rows", None, False),
    ("gs", "residual", 3, 64, "odd", None, False), ("gs", "expl", 2, 300, "", None, True),
    ("gs", "residual", 2, 1024, "", 1, False), ("gs", "residual", 1, 1, "", None, False),
    ("gs", "jacobian", 6, 2, "", None, False), ("gs", "expl", 4, 16, "odd", 3, True),
    ("b2", "jacobian", 4, 64, "", None, False), ("b2", "residual", 4, 64, "", None, False),
    ("b2", "residual", 4, 17, "", None, False), ("b2", "jacobian", 3, 17, "", 1, False),
    ("b2", "residual", 5, 32, "", 2, False), ("b2", "jacobian", 2, 64, "rows", None, False),
    ("b2", "residual", 3, 64, "odd", None, False), ("b2", "residual", 2, 300, "", 0, False),
    ("b2", "jacobian", 1, 1, "", None, False), ("b2", "residual", 6, 2, "", 5, False),
    ("b2", "jacobian", 2, 1024, "", None, False),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel,mode,B,n,layout,nan_lane,with_g", PAIR_CASES)
def test_pair_bit_for_bit_on_card(cuda, dtype, kernel, mode, B, n, layout, nan_lane, with_g):
    run = _pair_run(kernel, dtype, cuda, mode, B, n, nan_lane=nan_lane, layout=layout,
                    with_g=with_g)
    before = _counter(kernel).launches
    k = run(DISPATCH)
    torch.cuda.synchronize()
    assert _counter(kernel).launches == before + 1   # one launch, max included
    _same_bits(k, run(PLAIN))
    _same_bits(k, run(DISPATCH))                      # a call repeats its bits
    if nan_lane is not None and mode == "residual":
        gmax = k[-B:]
        assert bool(torch.isnan(gmax[nan_lane]))
        if B > 1:
            assert float(gmax[(nan_lane + 1) % B]) == float("inf")


@pytest.mark.cuda
def test_pair_residual_max_on_card_after_a_larger_batch(cuda):
    """The workspace the residual's max folds through (shared with K11 on
    the stream) is left zeroed: a small batch after a large one (and after
    a NaN lane) gets its own maxima."""
    for kernel, B, nan_lane in (("gs", 600, 7), ("b2", 3, None), ("b2", 600, None),
                                ("gs", 2, 1), ("gs", 600, None), ("b2", 5, 0)):
        run = _pair_run(kernel, torch.float64, cuda, "residual", B, 16, seed=B,
                        nan_lane=nan_lane)
        _same_bits(run(DISPATCH), run(PLAIN))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["residual", "jacobian"])
def test_k15_plain_on_card_equals_plain_on_cpu(cuda, mode):
    """The repaired fault: the plain central differences divide by 2 dx on
    the card as on the CPU (a division by a Python scalar would multiply by
    its reciprocal there), so the plain K15 gives the CPU's bits."""
    got = _pair_run("b2", torch.float64, cuda, mode, 4, 64, seed=11)(PLAIN)
    want = _pair_run("b2", torch.float64, "cpu", mode, 4, 64, seed=11)(PLAIN)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kernel,mode,nan_lane,with_g", [
    ("gs", "expl", None, True), ("gs", "expl", 1, False), ("gs", "residual", 2, False),
    ("gs", "jacobian", None, False), ("b2", "residual", 0, False), ("b2", "jacobian", 1, False),
])
def test_pair_cpu_takes_the_plain_version(kernel, mode, nan_lane, with_g):
    run = _pair_run(kernel, torch.float64, "cpu", mode, 3, 7, nan_lane=nan_lane, with_g=with_g)
    before = _counter(kernel).launches
    got = run(DISPATCH)
    assert _counter(kernel).launches == before
    _same_bits(got, run(PLAIN))
    if nan_lane is not None and mode == "residual":
        assert bool(torch.isnan(got[-3:][nan_lane]))
        assert float(got[-3:][(nan_lane + 1) % 3]) == float("inf")


@pytest.mark.parametrize("kernel", ["gs", "b2"])
def test_pair_no_lanes_on_cpu(kernel):
    run = _pair_run(kernel, torch.float64, "cpu", "residual", 0, 4)
    assert run(DISPATCH).numel() == 0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("axis", [-2, -1])
def test_k15_central_difference_divides_by_two_dx(dtype, axis):
    """_ddx and _ddy divide by 2 dx (the kernel's __ddiv_rn), which on the
    CPU is Python's division by the scalar; a multiplication by the
    reciprocal (what PyTorch's CUDA division by a Python scalar does)
    gives other bits on these inputs."""
    x = _rand((2, 9, 9), dtype, "cpu", 3)
    two_dx = 2.0 / 9
    h = torch.full((), two_dx, dtype=dtype)
    diff = torch.roll(x, -1, axis) - torch.roll(x, 1, axis)
    got = (pointwise._ddx if axis == -2 else pointwise._ddy)(x, h)
    assert torch.equal(got, diff / two_dx)
    assert not torch.equal(got, diff * (1.0 / h))


def _burgers_jax_ops(bj, s0, dt):
    """The JAX package's g_of and jac_mv closures of one Burgers2D step
    from s0 with step dt (``jax.lax.while_loop`` stubbed to hand its body
    back without running it)."""
    import jax
    import jax.numpy as jnp

    seen = {}

    def capture(cond, body, init):
        seen.update(zip(body.__code__.co_freevars, (c.cell_contents for c in body.__closure__)))
        return init

    loop = jax.lax.while_loop
    jax.lax.while_loop = capture
    try:
        bj.step(jnp.asarray(s0), 0.0, dt)
    finally:
        jax.lax.while_loop = loop
    return seen["g_of"], seen["jac_mv"]


def test_burgers2d_operators_match_jax_closures():
    """K15's plain residual, its per-lane max and its Jacobian matvec (the
    wrapper on CPU tensors) against the JAX package's own g_of and jac_mv
    (pymgrit_tpu/models/burgers.py:124-132) on three lanes of 12^2."""
    import jax.numpy as jnp
    from pymgrit_tpu.models.burgers import Burgers2D as JBurgers2D

    nx = 12
    bj = JBurgers2D(nx=nx, nu=NU, t_start=0, t_stop=1, nt=11)
    rng = np.random.default_rng(21)
    s0 = np.asarray(bj.vector_t_start)
    ss = np.stack([s0, 0.5 * s0, s0 + 0.05 * rng.standard_normal(s0.shape)])
    starts = ss + 0.01 * rng.standard_normal(ss.shape)
    w = rng.standard_normal(ss.shape)
    dts = np.array([0.02, 0.05, 0.01])

    def t(a):
        return torch.tensor(a, **F64)
    g, gmax = pointwise.burgers2d_pointwise("residual", t(ss), torch.empty(ss.shape, **F64),
                                            t(dts), NU, 1.0 / nx, r=t(starts))
    jw = pointwise.burgers2d_pointwise("jacobian", t(ss), torch.empty(ss.shape, **F64), t(dts),
                                       NU, 1.0 / nx, w=t(w))
    gj, jj = [], []
    for i in range(3):
        g_of, jac_mv = _burgers_jax_ops(bj, starts[i], float(dts[i]))
        gj.append(np.asarray(g_of(jnp.asarray(ss[i]))))
        jj.append(np.asarray(jac_mv(jnp.asarray(ss[i]), jnp.asarray(w[i]))))
    gj, jj = np.stack(gj), np.stack(jj)
    for got, want in ((g, gj), (gmax, np.max(np.abs(gj), axis=(1, 2, 3))), (jw, jj)):
        want_max = np.max(np.abs(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * want_max)


def _pair_args(kernel, **over):
    args = dict(mode="residual", s=torch.zeros((3, 2, 8, 8), **F64),
                out=torch.empty((3, 2, 8, 8), **F64), dt=torch.zeros(3, **F64),
                r=torch.zeros((3, 2, 8, 8), **F64))
    args.update(du=1e-4, dv=1e-4, a=0.02, b=0.08, dx2=1.0) if kernel == "gs" else \
        args.update(nu=0.05, dx=0.1)
    args.update(over)
    return args


def _call(kernel, args):
    return _counter(kernel)(**args)


@pytest.mark.parametrize("kernel", ["gs", "b2"])
@pytest.mark.parametrize("over,match", [
    (dict(mode="lap"), "mode must be"),
    (dict(mode="jacobian"), "needs w"),
    (dict(r=None), "needs r"),
    (dict(dt=torch.zeros(2, **F64)), "dt must be"),
    (dict(dt=torch.zeros(6, **F64)[::2]), "dt must be"),
    (dict(s=torch.zeros((3, 3, 8, 8), **F64)), "expected \\(B, 2, n, n\\)"),
    (dict(s=torch.zeros((3, 2, 8, 9), **F64)), "expected \\(B, 2, n, n\\)"),
    (dict(out=torch.zeros((3, 2, 9, 9), **F64)), "out has shape"),
    (dict(r=torch.zeros((3, 2, 8, 9), **F64)), "r has shape"),
    (dict(w=torch.zeros((2, 2, 8, 8), **F64)), "w has shape"),
    (dict(r=torch.zeros((3, 2, 8, 8))), "dtype"),
    (dict(s=torch.zeros((3, 2, 8, 16), **F64)[..., ::2]), "contiguous"),
    (dict(out=torch.empty((3, 2, 8, 8), **F64, device="meta")), "is on meta"),
    (dict(s=torch.zeros((3, 2, 0, 0), **F64), out=torch.empty((3, 2, 0, 0), **F64),
          r=torch.zeros((3, 2, 0, 0), **F64)), "side n >= 1"),
])
def test_pair_cached_checks_raise_on_every_call(kernel, over, match):
    """The same error on every call with the same facts (the cache holds
    no failed check), and a good call between them still runs."""
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            _call(kernel, _pair_args(kernel, **over))
        _call(kernel, _pair_args(kernel))


def test_k14_g_is_for_expl_only_on_every_call():
    z = torch.zeros((2, 2, 8, 8), **F64)
    for mode in ("jacobian", "residual", "jacobian"):
        with pytest.raises(ValueError, match="EXPL steps only"):
            pointwise.gray_scott_pointwise(mode, z, torch.empty_like(z), torch.zeros(2, **F64),
                                           1e-4, 1e-4, 0.02, 0.08, 1.0, r=z, w=z, g=z)


@pytest.mark.parametrize("kernel", ["gs", "b2"])
def test_pair_repeat_call_hits_the_cache(kernel):
    a = _pair_args(kernel)
    _call(kernel, a)
    hits = pointwise._pair_checked.cache_info().hits
    _call(kernel, dict(a, out=torch.empty_like(a["out"])))
    assert pointwise._pair_checked.cache_info().hits == hits + 1


def _tube_strides(B, n, every=1):
    """(batch, species, row) strides of every ``every``-th pair of a
    contiguous (B, 2, n, n) tube."""
    return (every * 2 * n * n, n * n, n)


@pytest.mark.parametrize("B,n,itemsize,strides,want", [
    # (vector width, TX, TY, units a block, grid) on 132 SMs at
    # chip_smoke's phase-3 shapes: K14 jacobian B=8 n=128 (s every second
    # pair, w, out)
    (8, 128, 8, (*_tube_strides(8, 128, 2), *_tube_strides(8, 128), 0, 0, 0, 0, 0, 0,
                 *_tube_strides(8, 128)), (2, 64, 4, 1, 256)),
    (8, 128, 4, (*_tube_strides(8, 128, 2), *_tube_strides(8, 128), 0, 0, 0, 0, 0, 0,
                 *_tube_strides(8, 128)), (4, 32, 8, 1, 128)),
    # K14 EXPL B=128 n=128 + g: 4096 units of 4 rows, four a block
    (128, 128, 8, (*_tube_strides(128, 128, 2), 0, 0, 0, 0, 0, 0, *_tube_strides(128, 128),
                   *_tube_strides(128, 128)), (2, 64, 4, 4, 1024)),
    # K14 residual B=1024 n=17 (scalars): a lane's three units a block
    (1024, 17, 8, (*_tube_strides(1024, 17, 2), 0, 0, 0, *_tube_strides(1024, 17), 0, 0, 0,
                   *_tube_strides(1024, 17)), (1, 32, 8, 3, 1024)),
    # K15 jacobian B=4 n=64: 32 blocks of 8 rows; residual n=17
    (4, 64, 8, (*_tube_strides(4, 64), *_tube_strides(4, 64), 0, 0, 0, 0, 0, 0,
                *_tube_strides(4, 64)), (2, 32, 8, 1, 32)),
    (4, 17, 8, (*_tube_strides(4, 17), 0, 0, 0, *_tube_strides(4, 17), 0, 0, 0,
                *_tube_strides(4, 17)), (1, 32, 8, 1, 12)),
    # a species stride that is not a multiple of the vector: scalars
    (4, 64, 8, (8194, 4097, 64) * 5, (1, 64, 4, 1, 64)),
])
def test_pair_plan(B, n, itemsize, strides, want):
    assert pointwise.plan(B, n, itemsize, strides, 132) == want


def test_pair_pack_layout():
    strides = (*_tube_strides(8, 128, 2), *_tube_strides(8, 128), 0, 0, 0, 0, 0, 0,
               *_tube_strides(8, 128))
    args = pointwise.pair_pack(3, strides, 8, 128, 2, (2, 64, 4, 1, 256))
    assert list(args) == [3] + [0] * 8 + list(strides) + [8, 128, 2, 2, 64, 4, 1, 256]


class _Launcher:
    """A stand-in for a C launcher: records the packed array (read at its
    address during the call) and the other arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, address, *rest):
        self.calls.append((list((ctypes.c_int64 * 32).from_address(address)), rest))
        return 0


@pytest.mark.parametrize("kernel,mode,with_g", [("gs", "expl", True), ("gs", "expl", False),
                                                ("gs", "residual", False),
                                                ("gs", "jacobian", False),
                                                ("b2", "residual", False),
                                                ("b2", "jacobian", False)])
def test_pair_launch_the_checks_would_make(monkeypatch, kernel, mode, with_g):
    """A CUDA-free look at the launch the cached checks build for a CUDA
    call on the phase-3 shapes (s every second pair of a tube), and at the
    one call the wrapper makes with it: the strides of the operands the
    mode reads in the launcher's order, the mode, the plan, the pointer
    slots, the scalars (as doubles) and the stream."""
    name = "gray_scott_pointwise" if kernel == "gs" else "burgers2d_pointwise"
    fn = _Launcher()
    checked = pointwise._pair_checked
    monkeypatch.setattr(pointwise, "_launcher", lambda nm, dt: (nm, dt))
    monkeypatch.setattr(pointwise._build, "sm_count", lambda index: 132)
    monkeypatch.setattr(pointwise._build, "stream", lambda index: 4242)
    ws = torch.zeros(64, dtype=torch.int64)
    monkeypatch.setattr(pointwise, "_workspace", lambda index, stream, B: ws)
    checked.cache_clear()
    try:
        B, n = (8, 128) if kernel == "gs" else (4, 64)
        s = torch.empty((2 * B, 2, n, n), **F64)[::2]
        out, other, dt = (torch.empty((B, 2, n, n), **F64), torch.empty((B, 2, n, n), **F64),
                          torch.empty(B, **F64))
        r = other if mode == "residual" else None
        w = other if mode != "residual" else None       # w given to an EXPL step is left alone
        g = other if with_g else None
        on_cpu, (args, launcher, index, gm) = checked(
            name, mode, _cuda_facts((s, out, dt, r, w, g if kernel == "gs" else None), 1))
        assert not on_cpu and launcher == ("pm_" + name, torch.float64) and index == 1
        assert gm == (B, torch.float64, torch.device("cuda", 1))
        modes = pointwise.GS_MODES if kernel == "gs" else pointwise.BURGERS_MODES
        reads = {"jacobian": "w", "residual": "r", "expl": "g" if with_g else None}[mode]
        want = [*_tube_strides(B, n, 2)]
        for key in ("w", "r", "g"):
            want += list(_tube_strides(B, n)) if key == reads else [0, 0, 0]
        plan = (2, 64, 4, 1, 256) if kernel == "gs" else (2, 32, 8, 1, 32)
        assert list(args[9:]) == [*want, *_tube_strides(B, n), B, n, modes.index(mode), *plan]

        # the wrapper's call with that launch (its residual max made on the CPU)
        launch = (args, fn, index, (B, torch.float64, torch.device("cpu")))
        monkeypatch.setattr(pointwise, "_pair_checked", lambda *key: (False, launch))
        if kernel == "gs":
            dx2 = (2.0 / n) ** 2
            res = pointwise.gray_scott_pointwise(mode, s, out, dt, GS["du"], GS["dv"], GS["a"],
                                                 GS["b"], dx2, r=r, w=w, g=g)
            scalars = (GS["du"], GS["dv"], GS["a"], GS["b"], dx2)
        else:
            res = pointwise.burgers2d_pointwise(mode, s, out, dt, NU, 1.0 / n, r=r, w=w)
            scalars = (NU, 2 * (1.0 / n), (1.0 / n) ** 2)
        (packed, rest), = fn.calls
        assert rest == (*scalars, 4242)
        ptr = {1: s, 5: dt, 6: out, 2: w if mode == "jacobian" else None, 3: r, 4: g,
               8: ws if mode == "residual" else None}
        for slot, t in ptr.items():
            assert packed[slot] == (0 if t is None else t.data_ptr()), slot
        if mode == "residual":
            assert packed[7] == res[1].data_ptr() and res[0] is out
        else:
            assert packed[7] == 0 and res is out
        assert packed[9:] == list(args[9:])
    finally:
        checked.cache_clear()


def test_pair_cpu_checks_carry_no_launch():
    a = _pair_args("gs")
    facts = tuple(fact(a[k]) for k in ("s", "out", "dt", "r")) + (None, None)
    assert pointwise._pair_checked("gray_scott_pointwise", "residual", facts) == (True, None)
