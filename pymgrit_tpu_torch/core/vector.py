"""State algebra over a tensor, a double-double pair or a tuple of them.

Counterpart of ``pymgrit_tpu/core/vector.py``.  A state at one time point
is a tensor, a ``DD`` pair (``ops/dd.py``) or a tuple of them; a *tube* is
the same structure with a leading time axis on every leaf.  The algebraic
operations (``add``, ``sub``, ``scale``, ``axpy``, ``add_at``, ``norm``)
treat a DD pair as one leaf, so sums and scalings stay renormalized (a
componentwise hi + hi, lo + lo would drop the rounding error of hi); the
structural ones (``take``, ``set_at``, ``where``, ``stack``, ``concat``,
``tube_of``, ``dynamic_index``) recurse into hi and lo.  All functions here
are pure: they return new tensors and never write their arguments.  (The
solver updates its tubes in place through its own row views; see
``core/solver.py``, which stores a DD tube as one packed float32 tensor.)
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from pymgrit_tpu_torch.core import prng
from pymgrit_tpu_torch.ops import dd as _dd
from pymgrit_tpu_torch.ops.dd import DD

State = Union[torch.Tensor, DD, tuple]


def _is_dd(x) -> bool:
    return isinstance(x, DD)


def _map(fn, *trees: Any):
    """Structural map: a DD pair maps hi and lo alike."""
    if isinstance(trees[0], tuple):
        return tuple(_map(fn, *leaves) for leaves in zip(*trees))
    if _is_dd(trees[0]):
        return _dd._raw(fn(*(t.hi for t in trees)), fn(*(t.lo for t in trees)), trees[0].ops)
    return fn(*trees)


def _amap(fn, *trees: Any):
    """Algebraic map: a DD pair is one leaf."""
    if isinstance(trees[0], tuple):
        return tuple(_amap(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _algebra_leaves(a: State) -> list:
    if isinstance(a, tuple):
        return [x for leaf in a for x in _algebra_leaves(leaf)]
    return [a]


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
    return torch.sqrt(sum(torch.sum(torch.square(_float(x))) for x in _algebra_leaves(a)))


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
    JAX package's ``random_like`` for the same (2,) uint32 key (the draw of
    ``core/prng.py``; float64 and float32 leaves).  A DD pair gets a uniform
    float32 hi and lo = 0."""
    leaves_a = _algebra_leaves(a)
    keys = prng.split(np.asarray(key, dtype=np.uint32), len(leaves_a))
    draws = iter([prng.uniform(k, tuple(x.shape), x.dtype) for k, x in zip(keys, leaves_a)])

    def _draw(x):
        t = torch.as_tensor(next(draws), device=x.device)
        return _dd._raw(t, torch.zeros_like(t), x.ops) if _is_dd(x) else t
    return _amap(_draw, a)


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
    return torch.sqrt(sq)


def as_f64(a: State) -> State:
    """Cast every leaf to torch.float64 (device unchanged); DD pairs keep
    their float32 pairs."""
    return _amap(lambda x: x if _is_dd(x) else torch.as_tensor(x).to(torch.float64), a)
