"""K25 ``dd_arith`` (the one-call launch path and the op-specialised vector
kernel) and K16 ``burgers1d_newton`` (a lane's Newton loop in shared
memory) against their plain PyTorch versions; their plans, packed
arguments and cached checks; and the plain versions against the JAX
package.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) with ``nvcc``; they skip
without one.  Run them on the card with

    python -m pytest tests/test_torch_k16_k25.py -q -m cuda --noconftest

and the rest here with ``-m 'not cuda'`` (the JAX package is imported by
the tests that compare with it, never by the ``cuda`` ones).

Tolerances.  K25 rounds every float32 operation of its plain version once,
in its order (``csrc/dd.cuh``), so the two agree bit for bit in hi and lo,
and the plain version equals the JAX package's eager DD operations bit for
bit (``tests/test_torch_dd.py``).  K16 runs LAPACK's pivot order with
dgetf2's reciprocal on the entries of the periodic tridiagonal Jacobian
that can be nonzero; the plain version solves the dense system with
``torch.linalg.solve``: both are held at 1e-10 of the largest entry in
float64 (the Newton iterates agree; the two LUs round differently) and
1e-4 in float32 (four iterations at float32 rounding), with equal
iteration counts for every lane and step.
"""

import ctypes
import zlib

import numpy as np
import pytest
import torch

from pymgrit_tpu_torch.ops import (DISPATCH, PLAIN, dd, dense_newton, launch_counts,
                                   reset_launch_counts)

torch.set_num_threads(1)

CUDA0 = torch.device("cuda", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _parts(x):
    return (x.hi, x.lo) if isinstance(x, dd.DD) else (x,)


def _bits(a):
    return a.detach().contiguous().cpu().view(torch.int32)


def _same_bits(x, y):
    for a, b in zip(_parts(x), _parts(y)):
        assert a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# K25 cases: each run(ops) returns what a call writes
# ---------------------------------------------------------------------------


def _dd(a, dev):
    return dd.from_f64(np.ascontiguousarray(a), dev)


def _packed(a, dev):
    x = _dd(a, dev)
    return torch.stack([x.hi, x.lo], 1)


def _wild(rng, shape):
    return rng.standard_normal(shape) * 10.0 ** rng.uniform(-8, 8, shape)


def _k25_case(name, dev):
    """run(ops) for the K25 case ``name`` on ``dev`` (fresh outputs each
    call; inputs made once from a seed)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    R, N = 5, 37
    x, y = _dd(_wild(rng, (R, N)), dev), _dd(np.abs(_wild(rng, (R, N))) + 1e-8, dev)
    if name in ("add", "sub", "mul", "div", "resid"):
        return lambda ops: ops.dd_arith(name, x, y)
    if name in ("sqrt", "neg"):
        return lambda ops: ops.dd_arith(name, y if name == "sqrt" else x)
    if name.startswith("combine"):          # "combine k": k terms, every coefficient kind
        k = int(name.split()[1])
        xs = [_dd(rng.standard_normal((R, N)), dev) for _ in range(k)]
        coeffs = [(1.0, -1.0, 1.3, -0.25, 1e-3, 1.0, -1.0, 7.0)[i] for i in range(k)]
        return lambda ops: ops.dd_arith("combine", *xs, coeffs=coeffs)
    if name == "broadcast":                 # (R, 1, N) against (1, 3, N) and a row (N,)
        a, b = _dd(rng.standard_normal((R, 1, N)), dev), _dd(rng.standard_normal((3, N)), dev)
        c = _dd(rng.standard_normal(N), dev)
        return lambda ops: ops.dd_arith("combine", a, b, c, coeffs=[1.0, -2.5, 1.0])
    if name == "0-d operands":              # immediates (0-d CPU) and 0-d device pairs
        c0 = dd.from_f64(np.float64(1.1))
        d0 = _dd(np.float64(-0.3), dev)
        return lambda ops: ops.dd_arith("div", ops.dd_arith("sub", x, c0), d0)
    if name == "0-d alone":
        a0, b0 = dd.from_f64(np.float64(0.7371)), _dd(np.float64(1.05), dev)
        return lambda ops: ops.dd_arith("div", a0, b0)
    if name == "mixed immediate":           # a float32 tensor at face value: lo a 0-d CPU zero
        t = torch.as_tensor(rng.standard_normal((R, N)).astype(np.float32), device=dev)
        face = dd._raw(t, torch.zeros((), dtype=torch.float32))
        return lambda ops: ops.dd_arith("mul", x, face)
    if name == "packed rows":               # the solver's (rows, 2, N) tube rows, N odd
        terms = [_packed(rng.standard_normal((R, N)), dev) for _ in range(3)]

        def run(ops):
            out = torch.full((R, 2, N), float("nan"), dtype=torch.float32, device=dev)
            ops.dd_arith("combine", *[dd.pair(t, ops) for t in terms], coeffs=[1.0, -1.0, 1.0],
                         out=dd.pair(out, ops))
            return out
        return run
    if name in ("aligned rows", "misaligned rows"):   # rows of 64: float4, or offset by one
        off = 1 if name.startswith("mis") else 0
        buf = [torch.as_tensor(rng.standard_normal(2 * R * 64 + 8).astype(np.float32), device=dev)
               for _ in range(4)]
        a = dd._raw(buf[0][off:off + R * 64].view(R, 64), buf[1][off:off + R * 64].view(R, 64))
        b = dd._raw(buf[2][:R * 64].view(R, 64), buf[3][:R * 64].view(R, 64))

        def run(ops):
            o = torch.zeros(2 * R * 64 + 8, dtype=torch.float32, device=dev)
            out = dd._raw(o[off:off + R * 64].view(R, 64), o[R * 64 + 4:2 * R * 64 + 4].view(R, 64))
            ops.dd_arith("sub", a, b, out=out)
            return o
        return run
    if name == "61-wide rows":              # dd65-like interior views, 61 of 63
        u = dd.pair(_packed(rng.standard_normal((3, 63, 63)), dev))
        v = [u[:, 1:-1, 1:-1], u[:, 1:-1, :-2], u[:, 1:-1, 2:], u[:, :-2, 1:-1], u[:, 2:, 1:-1]]
        return lambda ops: ops.dd_arith("combine", *v, coeffs=[4.0, -1.0, -1.0, -1.0, -1.0])
    if name == "out is an operand":
        def run(ops):
            a = dd._raw(x.hi.clone(), x.lo.clone())
            ops.dd_arith("add", a, y, out=a)
            return a
        return run
    if name == "strided out":               # out a strided view (every other column)
        def run(ops):
            o = torch.zeros((2, R, 2 * N), dtype=torch.float32, device=dev)
            ops.dd_arith("mul", x, y, out=dd._raw(o[0, :, ::2], o[1, :, ::2]))
            return o
        return run
    if name == "resid into a row":
        def run(ops):
            o = torch.zeros((R + 1, N), dtype=torch.float32, device=dev)
            ops.dd_arith("resid", x, y, out=o[1:])
            return o
        return run
    if name == "long row":                  # one coalesced row of 70001: several segments
        a, b = _dd(rng.standard_normal(70001), dev), _dd(rng.standard_normal(70001), dev)
        return lambda ops: ops.dd_arith("combine", a, b, coeffs=[1.0, 1.3])
    if name == "empty":
        e = _dd(np.zeros((0, 4)), dev)
        return lambda ops: ops.dd_arith("add", e, e)
    raise KeyError(name)


K25_CASES = ("add", "sub", "mul", "div", "sqrt", "neg", "resid",
             *(f"combine {k}" for k in range(1, 9)), "broadcast", "0-d operands", "0-d alone",
             "mixed immediate", "packed rows", "aligned rows", "misaligned rows", "61-wide rows",
             "out is an operand", "strided out", "resid into a row", "long row", "empty")


@pytest.mark.cuda
@pytest.mark.parametrize("name", K25_CASES)
def test_k25_bit_for_bit_on_card(cuda, name):
    run = _k25_case(name, cuda)
    reset_launch_counts()
    k = run(DISPATCH)
    torch.cuda.synchronize()
    assert launch_counts()["dd_arith"] >= (0 if name == "empty" else 1)
    _same_bits(k, run(PLAIN))
    _same_bits(k, run(DISPATCH))


@pytest.mark.cuda
def test_k25_rejects_vmapped_operands_on_card(cuda):
    x = _dd(np.ones((3, 4)), cuda)
    with pytest.raises(ValueError, match="vmapped"):
        torch.vmap(lambda h, l: DISPATCH.dd_arith("neg", dd._raw(h, l)).hi)(x.hi, x.lo)


@pytest.mark.parametrize("name", K25_CASES)
def test_k25_cpu_takes_the_plain_version(name):
    run = _k25_case(name, torch.device("cpu"))
    reset_launch_counts()
    _same_bits(run(DISPATCH), run(PLAIN))
    assert launch_counts()["dd_arith"] == 0


def test_k25_vmapped_cpu_operands_take_the_plain_version():
    rng = np.random.default_rng(3)
    x, y = _dd(rng.standard_normal((4, 6)), "cpu"), _dd(rng.standard_normal((4, 6)), "cpu")
    reset_launch_counts()
    got = torch.vmap(lambda a, b, c, d: DISPATCH.dd_arith(
        "mul", dd._raw(a, b), dd._raw(c, d)).hi)(x.hi, x.lo, y.hi, y.lo)
    assert torch.equal(got, PLAIN.dd_arith("mul", x, y).hi)
    assert launch_counts()["dd_arith"] == 0


# ---------------------------------------------------------------------------
# K25 plan, packed arguments, cached checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,strides,want", [
    # the FAS combine on packed (512, 2, 16129) rows: rows of 16129, no
    # float4 (odd row stride), 16 segments of 1024 a row
    ([1, 1, 512, 16129], [[0, 0, 32258, 1]] * 8,
     dict(tx=256, ty=1, segs=16, items=8192, grid=1056, index32=True, vec=0)),
    # contiguous pairs coalesced to one row: float4 for every component
    ([1, 1, 1, 8258048], [[0, 0, 0, 1]] * 6,
     dict(tx=256, ty=1, segs=8065, items=8065, grid=1056, index32=True, vec=0b111111)),
    # dd65's interior views: rows of 63 (16 threads a row, 16 rows a block),
    # row stride 65: scalar accesses
    ([1, 1024, 63, 63], [[0, 3969, 63, 1]] * 2 + [[0, 8450, 65, 1]] * 10,
     dict(tx=16, ty=16, segs=1, items=1024 * 63, grid=1056, index32=True, vec=0)),
    # 61-wide rows of one lane into rows padded to 64 (float4 for out); an
    # immediate (None) takes no bit
    ([1, 1, 61, 61], [[0, 0, 64, 1], [0, 0, 64, 1], None, None, [0, 0, 65, 1], [0, 0, 65, 1]],
     dict(tx=16, ty=16, segs=1, items=61, grid=4, index32=True, vec=0b000011)),
    # inner stride 2 (a strided view) and a broadcast row (outer stride 0)
    ([1, 1, 8, 64], [[0, 0, 128, 2], [0, 0, 128, 2], [0, 0, 0, 1], [0, 0, 64, 1]],
     dict(tx=16, ty=16, segs=1, items=8, grid=1, index32=True, vec=0b1100)),
    # 0-d: one element
    ([1, 1, 1, 1], [[0, 0, 0, 0]] * 2 + [None] * 4,
     dict(tx=1, ty=256, segs=1, items=1, grid=1, index32=True, vec=0)),
    # offsets past 2^31 elements: 64-bit indexing
    ([1, 1, 3, 1024], [[0, 0, 2 ** 30, 1]] * 2,
     dict(tx=256, ty=1, segs=1, items=3, grid=3, index32=False, vec=0b11)),
])
def test_k25_plan(size, strides, want):
    p = dd.plan(size, strides, 132)
    assert p._asdict() == want
    assert p.tx * p.ty == dd.THREADS


@pytest.mark.parametrize("W,tx,v", [(63, 16, 1), (63, 16, 4), (61, 16, 1), (1, 1, 4), (5, 2, 1),
                                    (16129, 256, 1), (16129, 256, 4), (1024, 256, 4)])
def test_k25_items_cover_each_row_once(W, tx, v):
    """The kernel's walk of a row (csrc/dd_arith.cu): segment s, thread t
    and element j cover s 4 TX + 4 t + j (V = 4) or s 4 TX + t + j TX
    (V = 1); over the plan's segments every element 0..W-1 once."""
    p = dd.plan([1, 1, 1, W], [[0, 0, 0, 1]], 132)
    assert p.tx == tx
    s, t, j = np.meshgrid(np.arange(p.segs), np.arange(p.tx), np.arange(4), indexing="ij")
    e = s * 4 * p.tx + (4 * t + j if v == 4 else t + j * p.tx)
    e = np.sort(e[e < W])
    np.testing.assert_array_equal(e, np.arange(W))


def test_k25_pack_layout():
    p = dd.Plan(16, 16, 1, 63, 4, True, 0b11)
    strides = [[0, 0, 61, 1], [0, 0, 61, 1], None, None, [0, 0, 65, 1], [0, 0, 65, 1]]
    a = dd.pack(2, "combine", 2, [1, 1, 61, 61], p, 132, (1, 0), strides)
    assert len(a) == dd.HEAD + dd.SLOTS * dd.N_COMPONENTS == 113
    assert list(a[:dd.HEAD]) == [2, dd.OPS.index("combine"), 2, 1, 16, 16, 1, 1, 61, 61, 1, 63,
                                 4, 132, 0b11, 1, 0, 1, 1, 1, 1, 1, 1]
    comp = [list(a[dd.HEAD + dd.SLOTS * k:dd.HEAD + dd.SLOTS * (k + 1)]) for k in range(18)]
    assert comp[0] == comp[1] == [0, 0, 0, 61, 1]          # pointer slot first, 0 until a call
    assert comp[2] == comp[3] == [0] * 5                    # an immediate
    assert comp[4] == comp[5] == [0, 0, 0, 65, 1]
    assert all(c == [0] * 5 for c in comp[6:])


@pytest.mark.parametrize("args,kw,match", [
    (("pow", "x", "x"), {}, "unknown op"),
    (("add", "x"), {}, "takes 2"),
    (("add", "x", "x"), dict(coeffs=[1.0, 1.0]), "takes 2"),
    (("combine",) + ("x",) * 9, dict(coeffs=[1.0] * 9), "1-8 operands"),
    (("combine", "x", "x"), dict(coeffs=[1.0]), "1-8 operands"),
    (("add", "x", "t"), {}, "DD pairs"),
    (("add", "x", "x"), dict(out="narrow"), "out has shape"),
    (("add", "x", "wide"), {}, "do not broadcast"),
    (("add", "x", "f64"), {}, "float32"),
    (("add", "x", "meta"), {}, "must lie on"),
])
def test_k25_cached_checks_raise_on_every_call(args, kw, match):
    z = {"x": dd.from_f64(np.zeros((3, 4))), "t": torch.zeros((3, 4)),
         "narrow": dd.from_f64(np.zeros((3, 5))), "wide": dd.from_f64(np.zeros((2, 4))),
         "f64": dd._raw(torch.zeros((3, 4), dtype=torch.float64),
                        torch.zeros((3, 4), dtype=torch.float64)),
         "meta": dd.from_f64(np.zeros((3, 4)), "meta")}
    args = [z.get(a, a) for a in args]
    kw = {k: z.get(v, v) if isinstance(v, str) else v for k, v in kw.items()}
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            DISPATCH.dd_arith(*args, **kw)


def test_k25_repeat_call_hits_the_cache():
    x = dd.from_f64(np.ones((3, 7)))
    DISPATCH.dd_arith("combine", x, x, coeffs=[1.0, 0.5])
    info = dd._checked.cache_info()
    DISPATCH.dd_arith("combine", x, x, coeffs=[1.0, 0.25])   # another value of one kind
    after = dd._checked.cache_info()
    assert (after.hits, after.misses) == (info.hits + 1, info.misses)
    assert info.maxsize == 1024


class _Captured:
    """A stand-in for the kernel library: records what pm_dd_arith was given."""

    def __init__(self):
        self.calls = []

    def pm_dd_arith(self, args, vals, stream):
        n = dd.HEAD + dd.SLOTS * dd.N_COMPONENTS
        self.calls.append((list((ctypes.c_int64 * n).from_address(args)),
                           list((ctypes.c_float * (dd.N_COMPONENTS + 2 * dd.MAX_TERMS))
                                .from_address(vals)), stream))
        return 0


def _as_cuda(monkeypatch):
    """Make CPU tensors look like tensors on CUDA device 0 to K25's checks
    (0-d tensors stay CPU immediates) and capture the launches."""
    lib = _Captured()
    monkeypatch.setattr(dd, "fact", lambda t: (t.dtype, CUDA0 if t.dim() else t.device, t.shape,
                                               t.stride()))
    monkeypatch.setattr(dd._build, "sm_count", lambda index: 132)
    monkeypatch.setattr(dd._build, "library", lambda: lib)
    monkeypatch.setattr(dd._build, "stream", lambda index: 7)
    dd._checked.cache_clear()
    return lib


def _offsets(t, base):
    """Element offsets from ``base`` (an address) of each element of t, in
    row-major order."""
    idx = np.zeros(t.shape, dtype=np.int64)
    for ax, (n, s) in enumerate(zip(t.shape, t.stride())):
        shape = [1] * t.dim()
        shape[ax] = n
        idx = idx + (np.arange(n) * s).reshape(shape)
    return (idx + (t.data_ptr() - base) // 4).ravel()


@pytest.mark.parametrize("name", ["packed rows", "61-wide rows", "broadcast", "0-d operands",
                                  "mixed immediate", "misaligned rows", "strided out",
                                  "resid into a row", "combine 8"])
def test_k25_launch_the_checks_would_make(monkeypatch, name):
    """A call with CUDA facts launches with the plan's array: each
    component's pointer and strides walk exactly the elements of its
    broadcast view, in the output's row-major order; the immediates and
    the coefficients are the call's; the launch count moves."""
    rng = np.random.default_rng(5)
    R, N = 3, 11
    x = _dd(rng.standard_normal((R, N)), "cpu")
    calls = []                        # (operands, coeffs, out) of the call the case makes

    def spy(op, *operands, coeffs=None, out=None):
        calls.append((op, operands, coeffs, out))
        return PLAIN.dd_arith(op, *operands, coeffs=coeffs, out=out)

    # record the case's call on the CPU, then replay it with CUDA facts (an
    # out made here where the case lets the call allocate one)
    _k25_case(name, torch.device("cpu"))(DISPATCH._replace(dd_arith=spy))
    op, operands, coeffs, out = calls[-1]
    shape = dd._broadcast(*(o.shape for o in operands))
    if out is None:
        buf = torch.empty((2, *shape), dtype=torch.float32)
        out = torch.empty(shape, dtype=torch.float32) if op == "resid" else dd._raw(buf[0], buf[1])
    lib = _as_cuda(monkeypatch)
    before = DISPATCH.dd_arith.launches
    DISPATCH.dd_arith(op, *operands, coeffs=coeffs, out=out)
    assert DISPATCH.dd_arith.launches == before + 1 and len(lib.calls) == 1
    args, vals, stream = lib.calls[0]
    assert stream == 7 and args[0] == 0 and args[1] == dd.OPS.index(op)
    n0, n1, n2, W = args[6:10]
    comps = [out, None] if op == "resid" else [out.hi, out.lo]
    comps += [t for o in operands for t in (o.hi, o.lo)]
    for k, t in enumerate(comps):
        ptr, s0, s1, s2, si = args[dd.HEAD + dd.SLOTS * k:dd.HEAD + dd.SLOTS * (k + 1)]
        if t is None:
            assert ptr == 0
            continue
        if t.dim() == 0 and t.device.type == "cpu":             # an immediate
            assert ptr == 0 and vals[k] == np.float32(t.item())
            continue
        assert ptr == t.data_ptr()
        i0, i1, i2, e = np.meshgrid(np.arange(n0), np.arange(n1), np.arange(n2), np.arange(W),
                                    indexing="ij")
        walk = (i0 * s0 + i1 * s1 + i2 * s2 + e * si).ravel()
        np.testing.assert_array_equal(walk, _offsets(t.expand(shape), ptr))
        if (args[14] >> k) & 1:                                  # float4-capable
            assert si == 1 and s0 % 4 == s1 % 4 == s2 % 4 == 0
    for k, c in enumerate(coeffs or ()):
        assert (vals[dd.N_COMPONENTS + 2 * k], vals[dd.N_COMPONENTS + 2 * k + 1]) == \
            dd._split_f64(c)
        assert args[15 + k] == dd._coefficient_kind(c)


# ---------------------------------------------------------------------------
# the plain K25 against the JAX package's DD operations
# ---------------------------------------------------------------------------


def _jdd(x):
    from pymgrit_tpu.ops import dd as jdd
    return jdd.DD(x.hi.numpy(), x.lo.numpy())


def _jax_value(op, operands, coeffs):
    """The JAX package's value of a K25 call, op by op (eagerly)."""
    from pymgrit_tpu.ops import dd as jdd
    xs = [_jdd(x) for x in operands]
    if op == "combine":
        acc = None
        for x, c in zip(xs, coeffs):
            x = x if c == 1.0 else jdd.neg(x) if c == -1.0 else jdd.mul(x, jdd.from_f64(c))
            acc = x if acc is None else jdd.add(acc, x)
        return acc
    if op == "resid":
        d = jdd.sub(*xs)
        return d.hi + d.lo
    return {"add": jdd.add, "sub": jdd.sub, "mul": jdd.mul, "div": jdd.div, "sqrt": jdd.sqrt,
            "neg": jdd.neg}[op](*xs)


def _same_as_jax(got, want):
    for a, b in zip(_parts(got), (want.hi, want.lo) if hasattr(want, "hi") else (want,)):
        b = np.broadcast_to(np.asarray(b, dtype=np.float32), a.shape)
        np.testing.assert_array_equal(a.numpy().view(np.int32), np.ascontiguousarray(b).view(np.int32))


@pytest.mark.parametrize("name", [n for n in K25_CASES if n not in ("empty",)])
def test_k25_plain_matches_jax(name):
    """Every K25 case's plain result equals the JAX package's DD operations
    on the same operands, bit for bit (hi and lo); sqrt within 2^-47 (the
    JAX package's float32 root on XLA's CPU is one ulp off at some inputs,
    which the refinement leaves in lo; the plain version and K25 take the
    correctly rounded root)."""
    calls = []

    def spy(op, *operands, coeffs=None, out=None):
        snapshot = [dd._raw(o.hi.clone(), o.lo.clone()) for o in operands]
        r = PLAIN.dd_arith(op, *operands, coeffs=coeffs, out=out)
        calls.append((op, snapshot, coeffs, r))
        return r

    _k25_case(name, torch.device("cpu"))(DISPATCH._replace(dd_arith=spy))
    assert calls
    for op, operands, coeffs, r in calls:
        want = _jax_value(op, operands, coeffs)
        if op == "sqrt":     # XLA's float32 sqrt on the CPU is not correctly rounded
            w = np.asarray(want.hi, np.float64) + np.asarray(want.lo, np.float64)
            assert np.all(np.abs(r.to_float64() - w) <= 2.0 ** -47 * np.abs(w))
            continue
        _same_as_jax(r, want)


# ---------------------------------------------------------------------------
# K16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,itemsize,optin,want", [
    (128, 8, 232448, ("shared", 8192)),
    (512, 8, 232448, ("shared", 32768)),
    (3632, 8, 232448, ("shared", 232448)),        # the largest float64 side on an H100
    (3633, 8, 232448, ("device", 0)),
    (4096, 8, 232448, ("device", 0)),
    (4096, 4, 232448, ("shared", 131072)),
    (7265, 4, 232448, ("device", 0)),
    (128, 8, 4096, ("device", 0)),                # a card with less shared memory
])
def test_k16_plan(n, itemsize, optin, want):
    assert dense_newton.plan(n, itemsize, optin) == want


def _k16_case(dev, dtype, J, L, n, dt, nu=0.01, with_g=False, nan_lane=None, tol=1e-12,
              maxiter=30, seed=0, swaps=False):
    """run(ops) -> (out, iters) of J lanes x L chained steps of n points
    (the out a strided view of a tube)."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, n, endpoint=False)
    seeds = np.sin(2 * np.pi * x) * rng.uniform(0.5, 1.5, (J, 1)) + 0.3 * np.cos(6 * np.pi * x)
    if nan_lane is not None:
        seeds[nan_lane, n // 3] = np.nan
    seeds = torch.as_tensor(seeds, dtype=dtype, device=dev)
    dts = torch.as_tensor(np.full((L, J), dt) * rng.uniform(0.5, 1.5, (1, J)), dtype=dtype,
                          device=dev)
    g = torch.as_tensor(rng.uniform(-1e-3, 1e-3, (J, L, n)), dtype=dtype,
                        device=dev) if with_g else None

    if swaps:                      # LAPACK's LU of the first Jacobian swaps rows
        D1, D2 = (torch.as_tensor(a) for a in dense_newton.periodic_differences(n, 1.0 / n))
        u = seeds.double().cpu()
        jac = torch.eye(n) + dts[0].double().cpu()[:, None, None] * (
            torch.diag_embed(u @ D1.T) + u[:, :, None] * D1 - nu * D2)
        pivots = torch.linalg.lu_factor(jac).pivots
        assert bool((pivots != torch.arange(1, n + 1, dtype=pivots.dtype)).any())

    def run(ops):
        tube = torch.full((J, L + 1, n), 7.0, dtype=dtype, device=dev)
        iters = torch.full((L, J), -1, dtype=torch.int32, device=dev)
        ops.burgers1d_newton(seeds, dts, tube[:, 1:], g, nu, 1.0 / n, tol, maxiter, iters)
        return tube, iters
    return run


# (dtype, J, L, n, dt, options): pivot swaps at large dt (the Jacobian is
# not diagonally dominant; the case checks that LAPACK's LU of the first
# Jacobian swaps rows), small and model sides on the shared route, a
# NaN lane, the maxiter stop, float32's fixed count, g, and the device
# workspace past the opt-in (n = 3700 in float64)
K16_CASES = (
    (torch.float64, 8, 3, 64, 2.0, dict(swaps=True, nu=0.002)),
    (torch.float64, 5, 2, 3, 0.05, {}),
    (torch.float64, 3, 2, 17, 0.1, dict(with_g=True)),
    (torch.float64, 256, 2, 128, 1.0 / 256, dict(with_g=True)),
    (torch.float64, 6, 2, 128, 2.0, dict(nan_lane=2)),
    (torch.float64, 4, 2, 96, 0.5, dict(tol=0.0, maxiter=3)),
    (torch.float64, 4, 1, 512, 1.0 / 512, {}),
    (torch.float32, 8, 3, 128, 0.05, dict(tol=0.0, maxiter=4)),
    (torch.float64, 2, 1, 3700, 1.0 / 4096, {}),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,J,L,n,dt,kw", K16_CASES)
def test_k16_matches_plain_on_card(cuda, dtype, J, L, n, dt, kw):
    run = _k16_case(cuda, dtype, J, L, n, dt, **kw)
    route, _ = dense_newton.plan(n, torch.finfo(dtype).bits // 8,
                                 torch.cuda.get_device_properties(0).shared_memory_per_block_optin)
    assert route == ("device" if n == 3700 else "shared")
    reset_launch_counts()
    (k, ik) = run(DISPATCH)
    torch.cuda.synchronize()
    assert launch_counts()["burgers1d_newton"] == 1
    (p, ip) = run(PLAIN)
    assert torch.equal(ik, ip)                              # every lane's and step's iterations
    nan = torch.isnan(p)
    assert torch.equal(torch.isnan(k), nan)
    rtol = 1e-10 if dtype == torch.float64 else 1e-4
    err = float((k[~nan] - p[~nan]).abs().max())
    assert err <= rtol * float(p[~nan].abs().max()), err
    k2, ik2 = run(DISPATCH)
    assert torch.equal(ik2, ik) and torch.equal(k2[~nan], k[~nan])     # a fixed order
    if "nan_lane" in kw:
        assert int(ik[0, kw["nan_lane"]]) == 0 and bool(ik[0].ne(0).sum() == J - 1)
    if kw.get("tol") == 0.0:
        assert bool((ik == kw["maxiter"]).all())


def _jax_newton_count(bj, u, dt, monkeypatch):
    """JAX's Newton iterations of one step, counted at jnp.linalg.solve."""
    import jax
    import jax.numpy as jnp
    calls = [0]
    solve = jnp.linalg.solve

    def counted(a, b):
        jax.debug.callback(lambda: calls.__setitem__(0, calls[0] + 1))
        return solve(a, b)

    monkeypatch.setattr(jnp.linalg, "solve", counted)
    out = np.asarray(bj.step(jnp.asarray(u), 0.0, dt))
    monkeypatch.undo()
    return out, calls[0]


def test_k16_plain_matches_jax_with_pivot_swaps(monkeypatch):
    """At a large step the Jacobian is not diagonally dominant and LAPACK's
    partial pivoting swaps rows: the plain K16 step equals JAX's
    Burgers1D.step at rtol 1e-12 with the same Newton iterations a lane."""
    import scipy.linalg
    from pymgrit_tpu.models.burgers import Burgers1D as JBurgers1D
    nx, nu = 32, 0.002
    bj = JBurgers1D(nx=nx, nu=nu, t_start=0, t_stop=1, nt=3)
    x = np.linspace(0, 1, nx, endpoint=False)
    us = np.stack([np.sin(2 * np.pi * x), 0.8 * np.sin(2 * np.pi * x) + 0.4 * np.cos(4 * np.pi * x),
                   1.3 * np.sin(2 * np.pi * x + 0.3)])
    dts = np.array([0.5, 1.0, 2.0])
    D1, D2 = dense_newton.periodic_differences(nx, float(bj.dx))
    swaps = 0
    for u, dt in zip(us, dts):       # the first Newton iteration's LU pivots
        Jac = np.eye(nx) + dt * (np.diag(D1 @ u) + u[:, None] * D1 - nu * D2)
        swaps += int(np.sum(scipy.linalg.lu_factor(Jac)[1] != np.arange(nx)))
    assert swaps > 0
    iters = torch.zeros((1, 3), dtype=torch.int32)
    out = torch.empty((3, 1, nx), dtype=torch.float64)
    dense_newton.burgers1d_newton_plain(torch.as_tensor(us), torch.as_tensor(dts)[None], out,
                                        nu=nu, dx=float(bj.dx), tol=bj.newton_tol,
                                        maxiter=bj.newton_maxiter, iters=iters)
    counts = []
    for i in range(3):
        uj, nj = _jax_newton_count(bj, us[i], dts[i], monkeypatch)
        counts.append(nj)
        np.testing.assert_allclose(out[i, 0].numpy(), uj, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(uj)))
    assert iters[0].tolist() == counts
