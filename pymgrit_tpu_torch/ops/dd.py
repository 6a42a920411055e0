"""Double-double ("DD") arithmetic on float32 pairs, and kernel K25
``dd_arith`` (CUDA C++, ``csrc/dd_arith.cu``) beside its plain version.

Counterpart of ``pymgrit_tpu/ops/dd.py``: a DD number is the unevaluated sum
``hi + lo`` of two float32 values (about 2^-48 relative precision).  The
error-free transforms (Knuth's TwoSum, Dekker's QuickTwoSum, split and
TwoProd) and the accurate DD add / mul / div / sqrt are the JAX package's,
operation for operation, so the port computes what it computes (the port
keeps float32 pairs on the card, where float64 would be native, for that
reason: its histories have a DD floor, not a float64 one).

``DD`` holds two float32 tensors on one device and the kernel set its
arithmetic runs on (``ops``: ``pymgrit_tpu_torch.ops.DISPATCH`` unless
given; an operation takes the set of its first DD operand).  Its operators
``+ - * / @`` and unary minus take DD, Python scalars and numpy arrays
(split exactly from float64) and torch tensors (taken at face value as
float32, lo = 0).  Every arithmetic operation is one call of
``ops.dd_arith`` (K25 on CUDA tensors; its plain version on CPU tensors or
with ``ops=PLAIN``), a product one call of ``ops.dd_matmul`` (K26,
``ops/dd_matmul.py``).  ``DD`` is a torch pytree node, so ``torch.vmap``
and the tube helpers of ``core/vector.py`` see ``(hi, lo)``.

The plain version uses only single-rounding operations (``+ - * /``,
the correctly rounded ``ieee_sqrt.sqrt_rn``, ``torch.where``; never
``addcmul`` or another fused op), as the JAX package's ``jnp`` ops round
once each.
"""

from __future__ import annotations

import array
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils import _pytree

from pymgrit_tpu_torch.ops import _build
from pymgrit_tpu_torch.ops.ieee_sqrt import sqrt_rn

_F32 = torch.float32
SPLIT_FACTOR = 4097.0              # 2**12 + 1: Dekker's split of a 24-bit significand
MAX_TERMS = 8                      # operands of one K25 launch (csrc/dd_arith.cu)
OPS = ("add", "sub", "mul", "div", "sqrt", "neg", "combine", "resid")
_ARITY = {"add": 2, "sub": 2, "mul": 2, "div": 2, "sqrt": 1, "neg": 1, "resid": 2}


# ---------------------------------------------------------------------------
# error-free transforms and DD arithmetic on (hi, lo) tensor pairs (plain)
# ---------------------------------------------------------------------------


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b) (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def quick_two_sum(a, b):
    """TwoSum assuming |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def split(a):
    """Dekker split: a == h + l with h, l of at most 12 significand bits."""
    c = SPLIT_FACTOR * a
    h = c - (c - a)
    return h, a - h


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b) (Dekker)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add(x, y):
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s1, s2 = quick_two_sum(s1, s2 + t1)
    return quick_two_sum(s1, s2 + t2)


def _neg(x):
    return -x[0], -x[1]


def _mul(x, y):
    p, e = two_prod(x[0], y[0])
    return quick_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def _div(x, y):
    zero = torch.zeros((), dtype=_F32)
    q1 = x[0] / y[0]
    r = _add(x, _neg(_mul(y, (q1, zero))))
    q2 = r[0] / y[0]
    r = _add(r, _neg(_mul(y, (q2, zero))))
    q3 = r[0] / y[0]
    return _add(quick_two_sum(q1, q2), (q3, zero))


def _sqrt(x):
    zero = torch.zeros((), dtype=_F32)
    pos = x[0] > 0
    y = sqrt_rn(torch.where(pos, x[0], 1.0))
    e = _add((torch.where(pos, x[0], 0.0), torch.where(pos, x[1], 0.0)),
             _neg(_mul((y, zero), (y, zero))))
    # a true division: torch's ``0.5 / y`` is reciprocal(y) * 0.5
    out = _add((y, zero), (e[0] * (torch.tensor(0.5, dtype=_F32, device=y.device) / y), zero))
    dead = x[0] <= 0
    return torch.where(dead, 0.0, out[0]), torch.where(dead, 0.0, out[1])


@functools.lru_cache(maxsize=256)
def _split_f64(c: float):
    """(hi, lo) float32 values with hi + lo = c to 48 bits (exact split)."""
    hi = np.float32(c)
    return float(hi), float(np.float32(np.float64(c) - np.float64(hi)))


def _coefficient_kind(c: float) -> int:
    return 1 if c == 1.0 else -1 if c == -1.0 else 0


def _value(op, *operands, coeffs=None):
    """The value of ``dd_arith(op, *operands, coeffs=coeffs)`` as a fresh
    (hi, lo) pair (a float32 tensor for ``resid``), with broadcasting."""
    xs = [(x.hi, x.lo) for x in operands]
    if op == "combine":
        acc = None
        for x, c in zip(xs, coeffs):
            kind = _coefficient_kind(c)
            if kind == -1:
                x = _neg(x)
            elif kind == 0:
                x = _mul(x, tuple(torch.tensor(v, dtype=_F32) for v in _split_f64(c)))
            acc = x if acc is None else _add(acc, x)
        return (acc[0].clone(), acc[1].clone()) if acc is xs[0] else acc
    if op == "resid":
        d = _add(xs[0], _neg(xs[1]))
        return d[0] + d[1]
    fn = {"add": _add, "mul": _mul, "div": _div, "sqrt": _sqrt, "neg": _neg,
          "sub": lambda x, y: _add(x, _neg(y))}[op]
    return fn(*xs)


# ---------------------------------------------------------------------------
# K25 dd_arith
# ---------------------------------------------------------------------------


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dd_arith: {msg}")


def _immediate(t: torch.Tensor) -> bool:
    """A 0-d CPU tensor: a scalar K25 takes by value."""
    return t.dim() == 0 and t.device.type == "cpu"


def _broadcast(*shapes) -> torch.Size:
    """torch.broadcast_shapes, without its per-call cost on the host."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, n in enumerate(s, nd - len(s)):
            if n != 1:
                _require(out[i] in (1, n), f"shapes {[tuple(x) for x in shapes]} do not broadcast")
                out[i] = n
    return torch.Size(out)


def _coalesce(size, strides):
    """Drop extent-1 axes and merge neighbours that every stride list
    walks as one axis; (size, [strides...]) with at most as many axes."""
    axes = [i for i, n in enumerate(size) if n != 1]
    size = [size[i] for i in axes]
    strides = [[s[i] for i in axes] for s in strides]
    i = len(size) - 1
    while i > 0:
        if all(s[i - 1] == s[i] * size[i] for s in strides):
            size[i - 1] *= size[i]
            for s in strides:
                s[i - 1] = s[i]
                del s[i]
            del size[i]
        i -= 1
    return size, strides


def _is_batched(t: torch.Tensor) -> bool:
    return torch._C._functorch.is_batchedtensor(t)


def fact(t: torch.Tensor):
    """What K25's checks read of a tensor: (dtype, device, shape, strides)."""
    return t.dtype, t.device, t.shape, t.stride()


# K25's launch (csrc/dd_arith.cu): blocks of THREADS threads, 16-byte
# accesses of VEC floats, the components (out hi, out lo, then each
# operand's hi and lo) and the packed array's layout (``pack``)
THREADS, VEC, AXES = 256, 4, 4
N_COMPONENTS = 2 + 2 * MAX_TERMS
HEAD, SLOTS = 23, 5
# the grid's cap before the launcher clamps it to the occupancy of the
# instantiation times the SMs
BLOCKS_PER_SM = 8
# the float arguments of a call with no immediate and no coefficient (the
# launcher reads them, never writes)
_NO_VALUES = array.array("f", [0.0] * (N_COMPONENTS + 2 * MAX_TERMS))


class Plan(NamedTuple):
    """A K25 launch shape: TX threads across a row's segment of 4 TX
    elements and TY rows a block (TX TY = THREADS), the segments a row, the
    items (rows x segments), the blocks wanted, 32-bit indexing, and the
    components that may take 16-byte accesses (a bitmask, by component)."""
    tx: int
    ty: int
    segs: int
    items: int
    grid: int
    index32: bool
    vec: int


def plan(size, strides, sm):
    """The launch plan of a K25 call on the coalesced extents ``size`` (at
    most AXES, the last the inner axis, already padded to AXES at the
    front) with each component's element strides (``None`` for an
    immediate), on a card of ``sm`` SMs.

    A component may take 16-byte accesses where its inner stride is 1 and
    every outer stride a multiple of VEC (the launcher also needs its
    pointer on 16 bytes).  TX is the least power of two (1-THREADS) with
    VEC TX covering the row, TY = THREADS / TX rows a block, so short rows
    fill a block.  32-bit indexing where every element offset of every
    component, the items and the row's last segment fit in 31 bits."""
    W = size[-1]
    rows = math.prod(size[:-1])
    quads, tx = -(-W // VEC), 1
    while tx < quads and tx < THREADS:
        tx *= 2
    ty = THREADS // tx
    segs = max(1, -(-W // (VEC * tx)))
    items = rows * segs
    grid = max(1, min(-(-items // ty), BLOCKS_PER_SM * sm))
    vec, reach = 0, 0
    for k, st in enumerate(strides):
        if st is None:
            continue
        reach = max(reach, sum(abs(s) * (n - 1) for s, n in zip(st, size)))
        if st[-1] == 1 and all(s % VEC == 0 for s in st[:-1]):
            vec |= 1 << k
    index32 = max(reach, items, W + VEC * tx) < 2 ** 31
    return Plan(tx, ty, segs, items, grid, index32, vec)


def pack(index, op, n, size, p, sm, kinds, strides):
    """K25's int64 argument array (csrc/dd_arith.cu ``pm_dd_arith``): the
    CUDA device, the op, the term count, 32-bit indexing, TX, TY, the three
    outer extents, the inner extent, segments a row, items, blocks wanted,
    the SMs, the 16-byte-capable components, the eight coefficient kinds,
    then SLOTS slots a component: its pointer (0 until a call fills it in,
    and for an immediate), three outer strides and the inner stride."""
    head = [index, OPS.index(op), n, int(p.index32), p.tx, p.ty, *size, p.segs, p.items,
            p.grid, sm, p.vec, *kinds, *[1] * (MAX_TERMS - len(kinds))]
    body = []
    for st in strides + [None] * (N_COMPONENTS - len(strides)):
        body += [0, *(st if st is not None else (0,) * AXES)]
    return array.array("q", head + body)


def _strides_to(shape, tshape, tstride):
    """The element strides of a tensor of shape tshape broadcast to shape
    (0 on the axes it broadcasts along); None where it does not broadcast."""
    lead = len(shape) - len(tshape)
    if lead < 0:
        return None
    out = [0] * lead
    for n, tn, ts in zip(shape[lead:], tshape, tstride):
        if tn == n:
            out.append(ts if n != 1 else 0)
        elif tn == 1:
            out.append(0)
        else:
            return None
    return out


@functools.lru_cache(maxsize=1024)
def _checked(op, comps, kinds, out_facts):
    """Every check of a K25 call, on the op, the ``fact``s of the operands'
    components (hi, lo of each), the coefficient kinds (None unless
    combine) and out's facts ((hi, lo), or resid's one tensor; None: the
    call allocates out), cached by them.  Returns (on the CPU, the launch:
    the packed array without pointers, the pointer slots with their
    components, the immediate components, the broadcast shape, its size,
    the device; None on the CPU)."""
    _require(op in OPS, f"unknown op {op!r}")
    n = len(comps) // 2
    if op == "combine":
        _require(1 <= n <= MAX_TERMS and kinds is not None and len(kinds) == n,
                 f"combine takes 1-{MAX_TERMS} operands, each with a coefficient")
    else:
        _require(n == _ARITY[op] and kinds is None, f"{op} takes {_ARITY[op]} operand(s)")
    _require(all(f[0] == _F32 for f in comps), "DD components must be float32")
    shape = _broadcast(*(f[2] for f in comps[::2]))
    outs = None
    if out_facts is not None:
        outs = [out_facts] if op == "resid" else list(out_facts)
        _require(all(f[0] == _F32 for f in outs), "out must be float32")
        _require(tuple(outs[0][2]) == tuple(shape) and outs[-1][2] == outs[0][2],
                 f"out has shape {tuple(outs[0][2])}, expected {tuple(shape)}")
    immediate = [len(f[2]) == 0 and f[1].type == "cpu" for f in comps]
    lead = [f for f, imm in zip(comps, immediate) if not imm]
    device = outs[0][1] if outs is not None else lead[0][1] if lead else torch.device("cpu")
    _require(all(f[1] == device for f in lead),
             f"operands must lie on {device} (or be 0-d CPU scalars)")
    if device.type == "cpu":
        return True, None
    _require(device.type == "cuda", f"unsupported device {device}")
    numel = math.prod(shape)
    if outs is None:        # a fresh (2, *shape) buffer (resid: one tensor)
        contiguous = [0] * len(shape)
        step = 1
        for i in range(len(shape) - 1, -1, -1):
            contiguous[i] = step
            step *= shape[i]
        out_strides = [contiguous] * (1 if op == "resid" else 2)
    else:
        out_strides = [list(f[3]) for f in outs]
    strides = out_strides + [None] * (2 - len(out_strides))
    for f, imm in zip(comps, immediate):
        st = None if imm else _strides_to(shape, f[2], f[3])
        _require(imm or st is not None,
                 f"a component of shape {tuple(f[2])} does not broadcast to {tuple(shape)}")
        strides.append(st)
    live = [k for k, st in enumerate(strides) if st is not None]
    size, merged = _coalesce(list(shape), [strides[k] for k in live])
    _require(len(size) <= AXES,
             f"shape {tuple(shape)} with these strides needs more than {AXES} axes")
    if not size:
        size, merged = [1], [[0] for _ in live]
    pad = AXES - len(size)
    size = [1] * pad + size
    for k, st in zip(live, merged):
        strides[k] = [0] * pad + st
    sm = _build.sm_count(device.index)
    p = plan(size, strides, sm)
    args = pack(device.index, op, n, size, p, sm, kinds or (), strides)
    slots = tuple((HEAD + SLOTS * k, k) for k in live)
    imms = tuple(k for k, imm in enumerate(immediate, 2) if imm)
    return False, (args, slots, imms, shape, numel, device)


def dd_arith(op, *operands, coeffs=None, out=None):
    """Elementwise DD operation ``op`` on DD operands, broadcast to a common
    shape (K25).

    op: "add", "sub", "mul", "div" (two operands), "sqrt", "neg" (one),
    "combine" (1-8 operands x_k and float coefficients c_k: the left-to-right
    DD sum of c_k x_k, with c_k = +1 and -1 exact and any other c_k split
    exactly from float64) or "resid" (two operands: the float32 value hi +
    lo of their DD difference, the input of a float32 norm).  Operands are
    ``DD`` pairs of float32 tensors on the output's device (or 0-d CPU
    pairs, scalars).  out: optional DD (a float32 tensor for "resid") of
    the broadcast shape, with any strides; it may be one of the operands
    (the same view), not a shifted view of one.  Returns out, or a new DD
    (float32 tensor) without it.

    The checks, the broadcast, the coalesced layout, the launch plan and the
    packed argument array are cached by the operands' facts (``_checked``);
    a call on the card fills in the pointers, the immediates and the
    coefficients and makes one ctypes call.
    """
    for x in operands:
        if not isinstance(x, DD):
            _require(False, "operands must be DD pairs")
    tensors = [t for x in operands for t in (x.hi, x.lo)]
    on_cpu, launch = _checked(
        op, tuple(map(fact, tensors)),
        None if coeffs is None else tuple(map(_coefficient_kind, coeffs)),
        None if out is None else fact(out) if op == "resid" else (fact(out.hi), fact(out.lo)))
    if on_cpu:
        return dd_arith_plain(op, *operands, coeffs=coeffs, out=out)
    if torch._C._functorch.maybe_current_level() is not None and any(map(_is_batched, tensors)):
        _require(False, "K25 takes no vmapped tensor on the card: write a per-state DD "
                 "transfer batched (batched = True)")
    tmpl, slots, imms, shape, numel, device = launch
    if out is None:
        if op == "resid":
            out = torch.empty(shape, dtype=_F32, device=device)
        else:
            out = _raw(*torch.empty((2, *shape), dtype=_F32, device=device).unbind(0))
    if numel == 0:
        return out
    tensors[:0] = (out, out) if op == "resid" else (out.hi, out.lo)
    args = tmpl[:]
    for slot, k in slots:
        args[slot] = tensors[k].data_ptr()
    vals = _NO_VALUES
    if imms or coeffs is not None:
        vals = _NO_VALUES[:]
        for k in imms:
            vals[k] = tensors[k].item()
        for k, c in enumerate(coeffs or ()):
            vals[N_COMPONENTS + 2 * k], vals[N_COMPONENTS + 2 * k + 1] = _split_f64(c)
    status = _build.library().pm_dd_arith(args.buffer_info()[0], vals.buffer_info()[0],
                                          _build.stream(device.index))
    _build.check(status, "dd_arith")
    dd_arith.launches += 1
    dd_arith.mode_launches[op] += 1
    return out


dd_arith.launches = 0
dd_arith.mode_launches = {op: 0 for op in OPS}


def dd_arith_plain(op, *operands, coeffs=None, out=None):
    """The plain version of ``dd_arith`` (same arguments): the pair
    arithmetic above, one rounding an operation.  On the card, 0-d CPU
    operands move to the device first: PyTorch's CUDA division by a CPU
    scalar multiplies by its reciprocal, which rounds twice."""
    dev = (out if op == "resid" else out.hi).device if out is not None else next(
        (x.device for x in operands if not _immediate(x.hi)), torch.device("cpu"))
    if dev.type != "cpu":
        operands = [x if x.hi.device == dev else _raw(x.hi.to(dev), x.lo.to(dev), x.ops)
                    for x in operands]
    return _store(_value(op, *operands, coeffs=coeffs), op, out)


def _store(value, op, out):
    """Plain result into out (or as a new DD / tensor)."""
    if op == "resid":
        return value if out is None else out.copy_(value)
    hi, lo = value
    if out is None:
        shape = _broadcast(hi.shape, lo.shape)
        return _raw(hi.expand(shape), lo.expand(shape))
    out.hi.copy_(hi)
    out.lo.copy_(lo)
    return out


# ---------------------------------------------------------------------------
# the DD type
# ---------------------------------------------------------------------------


def _default_ops():
    from pymgrit_tpu_torch.ops import DISPATCH
    return DISPATCH


def _ops_of(*xs):
    for x in xs:
        if isinstance(x, DD):
            return x.ops
    return _default_ops()


class DD:
    """Unevaluated float32 sum hi + lo, with elementwise broadcasting.

    ``DD(hi, lo=None, ops=None)``: hi and lo are cast to float32 (lo = 0
    when not given); ``ops`` is the kernel set of its arithmetic.
    ``x.at[idx].set(v)`` / ``.add(v)`` return updated copies, the add
    renormalizing through a DD add."""

    __slots__ = ("hi", "lo", "ops")

    def __init__(self, hi, lo=None, ops=None):
        self.hi = torch.as_tensor(hi).to(_F32)
        self.lo = torch.zeros_like(self.hi) if lo is None else \
            torch.as_tensor(lo, device=self.hi.device).to(_F32)
        self.ops = ops if ops is not None else _default_ops()

    # -- structure ---------------------------------------------------------

    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.dim()

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def device(self):
        return self.hi.device

    def __getitem__(self, key):
        return _raw(self.hi[key], self.lo[key], self.ops)

    def reshape(self, *shape):
        return _raw(self.hi.reshape(*shape), self.lo.reshape(*shape), self.ops)

    def expand(self, *shape):
        return _raw(self.hi.expand(*shape), self.lo.expand(*shape), self.ops)

    @property
    def T(self):
        return _raw(self.hi.T, self.lo.T, self.ops)

    @property
    def at(self):
        return _DDAt(self)

    def __repr__(self):
        return f"DD(hi={self.hi!r}, lo={self.lo!r})"

    # -- value extraction --------------------------------------------------

    def to_float(self):
        """The float32 value hi + lo (for norms and output)."""
        return self.hi + self.lo

    def to_float64(self):
        """The exact value as a float64 numpy array (on the host)."""
        return (self.hi.detach().double() + self.lo.detach().double()).cpu().numpy()

    # -- operators ---------------------------------------------------------

    def __add__(self, other):
        return add(self, coerce(other, self.device))

    __radd__ = __add__

    def __sub__(self, other):
        return sub(self, coerce(other, self.device))

    def __rsub__(self, other):
        return sub(coerce(other, self.device), self)

    def __mul__(self, other):
        return mul(self, coerce(other, self.device))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return div(self, coerce(other, self.device))

    def __rtruediv__(self, other):
        return div(coerce(other, self.device), self)

    def __neg__(self):
        return neg(self)

    def __matmul__(self, other):
        from pymgrit_tpu_torch.ops.dd_matmul import matmul_dd
        return matmul_dd(self, coerce(other, self.device))

    def __rmatmul__(self, other):
        from pymgrit_tpu_torch.ops.dd_matmul import matmul_dd
        return matmul_dd(coerce(other, self.device), self)


class _DDAt:
    """``x.at[idx]``: ``.set(v)`` and ``.add(v)`` (renormalizing)."""

    def __init__(self, ref: DD):
        self._ref = ref

    def __getitem__(self, idx):
        return _DDAtIndexed(self._ref, idx)


class _DDAtIndexed:
    def __init__(self, ref: DD, idx):
        self._ref = ref
        self._idx = idx

    def _with(self, value: DD) -> DD:
        hi, lo = self._ref.hi.clone(), self._ref.lo.clone()
        hi[self._idx] = value.hi.to(hi.device)
        lo[self._idx] = value.lo.to(lo.device)
        return _raw(hi, lo, self._ref.ops)

    def set(self, value):
        return self._with(coerce(value, self._ref.device))

    def add(self, value):
        return self._with(add(self._ref[self._idx], coerce(value, self._ref.device)))


def _raw(hi, lo, ops=None) -> DD:
    """A DD of the given tensors, without casts or copies."""
    obj = DD.__new__(DD)
    obj.hi = hi
    obj.lo = lo
    obj.ops = ops if ops is not None else _default_ops()
    return obj


_pytree.register_pytree_node(
    DD, lambda d: ([d.hi, d.lo], d.ops), lambda children, ops: _raw(children[0], children[1], ops),
    serialized_type_name="pymgrit_tpu_torch.ops.dd.DD")


def coerce(x, device=None, ops=None) -> DD:
    """A DD from a DD (itself), a Python scalar or numpy array (split
    exactly from float64: on ``device``, a 0-d value stays a CPU scalar) or
    a torch tensor (taken at face value as float32, lo = 0)."""
    if isinstance(x, DD):
        return x
    if isinstance(x, (int, float, np.ndarray)) or np.isscalar(x):
        return from_f64(x, device if np.ndim(x) else None, ops)
    t = torch.as_tensor(x).to(_F32)
    return _raw(t, torch.zeros((), dtype=_F32, device=t.device).expand(t.shape), ops)


def from_f64(arr, device=None, ops=None) -> DD:
    """Exact split of float64 values into (hi, lo) float32 pairs, on
    ``device`` (the CPU by default; a 0-d CPU pair is a scalar that K25
    takes by value)."""
    a = np.asarray(arr, dtype=np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    dev = "cpu" if device is None else device
    return _raw(torch.as_tensor(hi, device=dev), torch.as_tensor(lo, device=dev), ops)


def zeros_like(x) -> DD:
    t = coerce(x)
    return _raw(torch.zeros_like(t.hi), torch.zeros_like(t.hi), t.ops)


def ones_like(x) -> DD:
    t = coerce(x)
    return _raw(torch.ones_like(t.hi), torch.zeros_like(t.hi), t.ops)


def pair(t: torch.Tensor, ops=None, axis: int = 1) -> DD:
    """The DD view of a packed float32 tensor whose axis ``axis`` holds
    (hi, lo): a batch or tube of DD states as the solver stores it,
    (rows, 2, ...), or a chain block (J, L, 2, ...) with axis 2."""
    return _raw(t.select(axis, 0), t.select(axis, 1), ops)


def packed(x: DD, axis: int = 1) -> torch.Tensor:
    """The packed float32 tensor of DD states, (hi, lo) on axis ``axis``."""
    return torch.stack([x.hi, x.lo], dim=axis)


# ---------------------------------------------------------------------------
# DD arithmetic (each call one K25 launch on the card)
# ---------------------------------------------------------------------------


def add(x: DD, y: DD) -> DD:
    return _ops_of(x, y).dd_arith("add", x, y)


def neg(x: DD) -> DD:
    return x.ops.dd_arith("neg", x)


def sub(x: DD, y: DD) -> DD:
    return _ops_of(x, y).dd_arith("sub", x, y)


def mul(x: DD, y: DD) -> DD:
    return _ops_of(x, y).dd_arith("mul", x, y)


def div(x: DD, y: DD) -> DD:
    return _ops_of(x, y).dd_arith("div", x, y)


def sqrt(x: DD) -> DD:
    """DD square root by one Karp/Markstein refinement of the float32 root;
    sqrt(0) = 0."""
    return x.ops.dd_arith("sqrt", x)


def scale_pow2(x: DD, p) -> DD:
    """Multiply by an exact power of two (error-free)."""
    return x.ops.dd_arith("combine", x, coeffs=[float(p)])
