"""State algebra over a tensor or a tuple of tensors.

Counterpart of ``pymgrit_tpu/core/vector.py`` (without double-double
support).  A state at one time point is a tensor or a tuple of tensors; a
*tube* is the same structure with a leading time axis on every leaf.  All
functions here are pure: they return new tensors and never write their
arguments.  (The solver updates its tubes in place through its own row
views; see ``core/solver.py``.)
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from pymgrit_tpu_torch.core import prng

State = Union[torch.Tensor, tuple]


def _map(fn, *trees: Any):
    if isinstance(trees[0], tuple):
        return tuple(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def leaves(a: State) -> list:
    """The tensors of a state, in order."""
    if isinstance(a, tuple):
        return [x for leaf in a for x in leaves(leaf)]
    return [a]


def add(a: State, b: State) -> State:
    """a + b leafwise."""
    return _map(torch.add, a, b)


def sub(a: State, b: State) -> State:
    """a - b leafwise."""
    return _map(torch.sub, a, b)


def scale(a: State, s) -> State:
    """s * a leafwise."""
    return _map(lambda x: x * s, a)


def axpy(y: State, alpha, x: State) -> State:
    """y + alpha * x leafwise."""
    return _map(lambda yy, xx: yy + alpha * xx, y, x)


def norm(a: State) -> torch.Tensor:
    """2-norm over all leaves concatenated (0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in leaves(a)))


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
    """A copy of tube with values added to rows idx (idx without repeats)."""
    def _add(x, v):
        out = x.clone()
        i = _index(idx, x.device)
        out[i] = out[i] + v
        return out
    return _map(_add, tube, values)


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
    ``core/prng.py``; float64 and float32 leaves)."""
    leaves_a = leaves(a)
    keys = prng.split(np.asarray(key, dtype=np.uint32), len(leaves_a))
    draws = iter([prng.uniform(k, tuple(x.shape), x.dtype) for k, x in zip(keys, leaves_a)])
    return _map(lambda x: torch.as_tensor(next(draws), device=x.device), a)


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
    sq = sum(torch.sum(torch.square(x.reshape(x.shape[0], -1)), dim=1)
             for x in leaves(tube))
    return torch.sqrt(sq)


def as_f64(a: State) -> State:
    """Cast every leaf to torch.float64 (device unchanged)."""
    return _map(lambda x: torch.as_tensor(x).to(torch.float64), a)
