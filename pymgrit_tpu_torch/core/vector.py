"""State algebra over a pytree of tensors and double-double pairs.

Counterpart of ``pymgrit_tpu/core/vector.py``.  A state at one time point
is a tensor, a ``DD`` pair (``ops/dd.py``) or a pytree of them (tuples,
lists, dicts, nested); a *tube* is the same structure with a leading time
axis on every leaf.  Leaves are visited in the JAX package's order
(``jax.tree_util``: a dict's keys sorted), through ``torch.utils._pytree``
with a DD pair as one leaf, as JAX's ``_is_dd`` treats it.  The algebraic
operations (``add``, ``sub``, ``scale``, ``axpy``, ``add_at``, ``norm``)
treat a DD pair as one leaf, so sums and scalings stay renormalized (a
componentwise hi + hi, lo + lo would drop the rounding error of hi); the
structural ones (``take``, ``set_at``, ``where``, ``stack``, ``concat``,
``tube_of``, ``dynamic_index``) recurse into hi and lo.  All functions here
are pure: they return new tensors and never write their arguments.  (The
solver updates its tubes in place through its own row views; see
``core/solver.py``, which stores a DD tube as one packed float32 tensor and
a multi-leaf tube as one float64 row a state, ``Layout``.)
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Union

import numpy as np
import torch
from torch.utils import _pytree

from pymgrit_tpu_torch.core import prng
from pymgrit_tpu_torch.ops import dd as _dd
from pymgrit_tpu_torch.ops.dd import DD
from pymgrit_tpu_torch.ops.ieee_sqrt import sqrt_rn

State = Union[torch.Tensor, DD, tuple, list, dict]


def _is_dd(x) -> bool:
    return isinstance(x, DD)


def _canonical(a):
    """a with every plain dict's keys in sorted order, so that torch's
    pytree visits the leaves in the JAX package's order (tuples, lists,
    named tuples and ordered dicts keep theirs, as in ``jax.tree_util``)."""
    if type(a) is dict:
        return {k: _canonical(a[k]) for k in sorted(a)}
    if type(a) is OrderedDict:
        return OrderedDict((k, _canonical(v)) for k, v in a.items())
    if isinstance(a, (tuple, list)):
        items = [_canonical(x) for x in a]
        return type(a)(*items) if hasattr(a, "_fields") else type(a)(items)
    return a


def _flatten(a):
    """(leaves in the JAX package's order, their spec); a DD pair is one leaf."""
    return _pytree.tree_flatten(_canonical(a), is_leaf=_is_dd)


def _map(fn, *trees: Any):
    """Structural map: a DD pair maps hi and lo alike."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)

    def leaf(*xs):
        if _is_dd(xs[0]):
            return _dd._raw(fn(*(t.hi for t in xs)), fn(*(t.lo for t in xs)), xs[0].ops)
        return fn(*xs)
    return _pytree.tree_map(leaf, *map(_canonical, trees), is_leaf=_is_dd)


def _amap(fn, *trees: Any):
    """Algebraic map: a DD pair is one leaf."""
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return _pytree.tree_map(fn, *map(_canonical, trees), is_leaf=_is_dd)


def _algebra_leaves(a: State) -> list:
    return _flatten(a)[0]


def leaves(a: State) -> list:
    """The tensors of a state, in order (hi, then lo, of a DD pair)."""
    return [t for x in _algebra_leaves(a) for t in ((x.hi, x.lo) if _is_dd(x) else (x,))]


def contains_dd(a: State) -> bool:
    """True if any leaf of the state is a double-double pair."""
    return any(_is_dd(x) for x in _algebra_leaves(a))


def _coerce(s, like: DD) -> DD:
    return _dd.coerce(s, like.device, like.ops)


def add(a: State, b: State) -> State:
    """a + b leafwise (DD add on DD pairs)."""
    return _amap(lambda x, y: _dd.add(x, y) if _is_dd(x) else torch.add(x, y), a, b)


def sub(a: State, b: State) -> State:
    """a - b leafwise."""
    return _amap(lambda x, y: _dd.sub(x, y) if _is_dd(x) else torch.sub(x, y), a, b)


def scale(a: State, s) -> State:
    """s * a leafwise.  On a DD pair a Python float s is split exactly, so
    e.g. weight_c = 1.3 scales at full float64 fidelity."""
    return _amap(lambda x: _dd.mul(x, _coerce(s, x)) if _is_dd(x) else x * s, a)


def axpy(y: State, alpha, x: State) -> State:
    """y + alpha * x leafwise."""
    return _amap(lambda yy, xx: _dd.add(yy, _dd.mul(xx, _coerce(alpha, xx)))
                 if _is_dd(yy) else yy + alpha * xx, y, x)


def _float(x):
    return x.to_float() if _is_dd(x) else x


def norm(a: State) -> torch.Tensor:
    """2-norm over all leaves concatenated (0-d tensor).  A DD pair counts
    with its float32 value hi + lo: the inputs of a residual norm need the
    extended cancellation, the norm only reports a magnitude."""
    return sqrt_rn(sum(torch.sum(torch.square(_float(x))) for x in _algebra_leaves(a)))


def zeros_like(a: State) -> State:
    """Zero state with the same structure, dtype and device."""
    return _map(torch.zeros_like, a)


def _index(idx, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=device)


def take(tube: State, idx) -> State:
    """Gather time indices: tube[idx] on every leaf."""
    return _map(lambda x: torch.index_select(x, 0, _index(idx, x.device)), tube)


def set_at(tube: State, idx, values: State) -> State:
    """A copy of tube with rows idx replaced by values."""
    def _set(x, v):
        out = x.clone()
        out[_index(idx, x.device)] = v
        return out
    return _map(_set, tube, values)


def add_at(tube: State, idx, values: State) -> State:
    """A copy of tube with values added to rows idx (idx without repeats).
    A DD tube goes through gather, DD add and set."""
    def _add(x, v):
        i = _index(idx, x.device)
        if _is_dd(x):
            new = _dd.add(_dd._raw(x.hi[i], x.lo[i], x.ops), v)
            return _map(lambda t, n: t.index_put((i,), n), x, new)
        out = x.clone()
        out[i] = out[i] + v
        return out
    return _amap(_add, tube, values)


def dynamic_index(tube: State, i) -> State:
    """tube[i] on every leaf (one index, axis dropped), with the JAX
    package's ``lax.dynamic_index_in_dim`` rule: a negative index counts
    from the end, then the index is clamped into range.  ``i`` may be an int
    or a 0-d integer tensor (read without a host sync)."""
    def _pick(x):
        n = x.shape[0]
        k = torch.as_tensor(i, dtype=torch.int64, device=x.device).reshape(1)
        k = torch.clamp(torch.where(k < 0, k + n, k), 0, n - 1)
        return torch.index_select(x, 0, k)[0]
    return _map(_pick, tube)


def where(mask, a: State, b: State) -> State:
    """Select a where mask else b; mask broadcasts against leading axes."""
    def _sel(x, y):
        m = torch.as_tensor(mask, device=x.device)
        return torch.where(m.reshape(tuple(m.shape) + (1,) * (x.dim() - m.dim())), x, y)
    return _map(_sel, a, b)


def stack(states) -> State:
    """Stack a list of single states into a tube."""
    return _map(lambda *xs: torch.stack(xs, dim=0), *states)


def random_like(a: State, key) -> State:
    """Uniform [0, 1) state with the structure, dtypes and devices of a: the
    JAX package's ``random_like`` for the same (2,) uint32 key (one split
    key a leaf, in its leaf order; the draw of ``core/prng.py``; float64
    and float32 leaves).  A DD pair gets a uniform float32 hi and lo = 0."""
    leaves_a, spec = _flatten(a)
    keys = prng.split(np.asarray(key, dtype=np.uint32), len(leaves_a))
    new = []
    for k, x in zip(keys, leaves_a):
        t = torch.as_tensor(prng.uniform(k, tuple(x.shape), x.dtype), device=x.device)
        new.append(_dd._raw(t, torch.zeros_like(t), x.ops) if _is_dd(x) else t)
    return _pytree.tree_unflatten(new, spec)


def concat(tubes) -> State:
    """Concatenate tubes along the time axis."""
    return _map(lambda *xs: torch.cat(xs, dim=0), *tubes)


def tube_of(template: State, nt: int) -> State:
    """A zero tube of nt copies of template (same dtype and device)."""
    return _map(lambda x: torch.zeros((nt,) + tuple(x.shape), dtype=x.dtype,
                                      device=x.device), template)


def length(tube: State) -> int:
    """Length of the time axis."""
    return leaves(tube)[0].shape[0]


def batched_norm(tube: State) -> torch.Tensor:
    """Per-time-point 2-norm over all leaves: shape (length,)."""
    sq = sum(torch.sum(torch.square(_float(x).reshape(x.shape[0], -1)), dim=1)
             for x in _algebra_leaves(tube))
    return sqrt_rn(sq)


def as_f64(a: State) -> State:
    """Cast every leaf to torch.float64 (device unchanged); DD pairs keep
    their float32 pairs."""
    return _amap(lambda x: x if _is_dd(x) else torch.as_tensor(x).to(torch.float64), a)


class Layout:
    """How the solver stores a multi-leaf float64 state: its leaves in the
    JAX package's order, each flattened, concatenated into one row of
    ``numel`` values.  ``flat`` packs a state (its leaves with any common
    leading axes) into a (..., numel) tensor; ``tree`` unpacks a (..., numel)
    tensor into the state's structure as views of it, so that a callee
    that writes a leaf writes the row.  Both work under ``torch.vmap``."""

    def __init__(self, template: State):
        leaves_t, self.spec = _flatten(template)
        if any(_is_dd(x) for x in leaves_t):
            raise NotImplementedError(
                "a multi-leaf state with a double-double leaf is not ported (ROADMAP A9: "
                "precision='dd' takes one DD pair a state)")
        self.shapes = [tuple(torch.as_tensor(x).shape) for x in leaves_t]
        self.sizes = [int(np.prod(sh, dtype=np.int64)) for sh in self.shapes]
        self.numel = sum(self.sizes)

    def flat(self, state: State) -> torch.Tensor:
        xs = [torch.as_tensor(x) for x in _flatten(state)[0]]
        lead = tuple(xs[0].shape[:xs[0].dim() - len(self.shapes[0])])
        return torch.cat([x.reshape(lead + (n,)) for x, n in zip(xs, self.sizes)], dim=-1)

    def tree(self, rows: torch.Tensor) -> State:
        lead = tuple(rows.shape[:-1])
        parts = torch.split(rows, self.sizes, dim=-1)
        return _pytree.tree_unflatten([p.view(lead + sh) for p, sh in zip(parts, self.shapes)],
                                      self.spec)


def layout(template: State):
    """The solver's ``Layout`` of a state, or None for a single tensor or
    DD pair (stored as it is)."""
    if isinstance(template, torch.Tensor) or _is_dd(template):
        return None
    return Layout(template)
