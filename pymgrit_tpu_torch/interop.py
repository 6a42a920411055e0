"""Carry solver state across from the JAX package.

The JAX package's ``Mgrit`` state is the pytree ``(u, v, g)`` of per-level
tubes with ``v[0] = g[0] = None``; ``jax.tree_util.tree_flatten`` orders
its leaves ``u[0..L-1]``, then ``v[1..L-1]``, then ``g[1..L-1]``.  Its
``save_checkpoint`` writes them as ``leaf_<i>`` into an ``.npz`` file.  A
tube of pair states (``Heat1DBDF1`` / ``Heat1DBDF2``) is the dict
{'first', 'second'} there, so it gives two leaves in that (key) order; the
port's pair tube is one (nt, 2, n) tensor, so the two are stacked.  A
double-double tube (``precision='dd'``) is a ``DD`` pytree there, whose two
leaves are hi then lo; the port stores it as one packed (nt, 2, ...)
float32 tensor, so it is stacked the same way (in the tube's dtype).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def state_from_numpy(mgrit, leaves: Sequence[np.ndarray]) -> None:
    """Replace the port solver's ``(u, v, g)`` with numpy arrays given in
    the JAX package's leaf order (copied to the solver's device as
    float64, or float32 for a DD solver).  Level 0 may hold the full tube or
    the condensed C-rows; the next solve re-condenses it.  With two leaves a
    tube (pair states, first then second; DD pairs, hi then lo), each pair
    is stacked into one (nt, 2, ...) tube."""
    L = mgrit.lvl_max
    if len(leaves) == 2 * (3 * L - 2):
        leaves = [np.stack([np.asarray(a), np.asarray(b)], axis=1)
                  for a, b in zip(leaves[0::2], leaves[1::2])]
    if len(leaves) != 3 * L - 2:
        raise ValueError(f"expected {3 * L - 2} leaves (or two a tube) for {L} levels, "
                         f"got {len(leaves)}")

    def tensor(a, like):
        t = torch.tensor(np.asarray(a), dtype=like.dtype if like is not None else torch.float64,
                         device=mgrit.device)
        if like is not None and t.shape[1:] != like.shape[1:]:
            raise ValueError(f"state shape {tuple(t.shape)} does not match {tuple(like.shape)}")
        return t

    u = [tensor(a, x) for a, x in zip(leaves[:L], mgrit.u)]
    for lvl in range(1, L):
        if u[lvl].shape != mgrit.u[lvl].shape:
            raise ValueError(f"level {lvl} tube has shape {tuple(u[lvl].shape)}, "
                             f"expected {tuple(mgrit.u[lvl].shape)}")
    mgrit.u = u
    mgrit.v = [None] + [tensor(a, x) for a, x in zip(leaves[L:2 * L - 1], mgrit.v[1:])]
    mgrit.g = [None] + [tensor(a, x) for a, x in zip(leaves[2 * L - 1:], mgrit.g[1:])]
