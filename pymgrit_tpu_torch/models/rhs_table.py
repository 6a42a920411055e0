"""Lookup in a tabulated right-hand side (the heat models).

A heat model samples its rhs over the level's grid times once, in one
batched numpy evaluation, so every solver phase reads samples of one
evaluation context (transcendentals round differently in scalar and
vectorized evaluations).  ``table_rows`` reads that table back;
``grid_index`` finds the rows of grid times on the host, for a device index
that a model makes once.  In double-double precision the table is float32
and is read at each time's float32 value (``dd_time_keys``), as the JAX
package's DD tables are.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def table_rows(tbl: torch.Tensor, times: torch.Tensor, ts,
               evaluate: Callable[[float], torch.Tensor]) -> torch.Tensor:
    """Rows of the (T, N) table ``tbl`` at the times ts (numpy, any shape
    S) as an S + (N,) tensor.

    times: the (T,) float64 CPU tensor of sample times.  A one-row table (a
    time-independent rhs) is expanded with stride 0; grid times hit the
    table (nearest entry, torch.searchsorted); off-grid times are sampled by
    ``evaluate(t) -> (N,) tensor``."""
    ts = np.asarray(ts, dtype=np.float64)
    N = tbl.shape[1]
    if tbl.shape[0] == 1:
        return tbl[0].expand(ts.shape + (N,))
    tv = torch.as_tensor(np.ascontiguousarray(ts.reshape(-1)), dtype=torch.float64)
    idx = torch.clamp(torch.searchsorted(times, tv), 0, times.shape[0] - 1)
    prev = torch.clamp(idx - 1, min=0)
    idx = torch.where((idx > 0) & (torch.abs(times[prev] - tv) < torch.abs(times[idx] - tv)),
                      prev, idx)
    rows = tbl[idx.to(tbl.device)]
    for i in torch.nonzero(times[idx] != tv).flatten().tolist():
        rows[i] = evaluate(float(tv[i]))
    return rows.reshape(ts.shape + (N,))


def grid_index(times: np.ndarray, ts: np.ndarray):
    """Positions of the times ts (numpy) in the sorted sample times
    ``times`` (numpy), or None when one of them is not a sample time."""
    pos = np.clip(np.searchsorted(times, ts), 0, times.size - 1)
    return pos if np.array_equal(times[pos], ts) else None


def dd_time_keys(ts) -> np.ndarray:
    """The float32 value hi + lo of each time's exact double-double split
    (the JAX package's DD rhs-table key ``t.to_float()``), as float64 numpy
    values; ``ts`` is numpy float64 times or a ``DD`` of times (read back
    from its device).  Keys map to themselves."""
    if hasattr(ts, "hi"):
        return ts.to_float().double().cpu().numpy()
    ts = np.asarray(ts, dtype=np.float64)
    hi = ts.astype(np.float32)
    return (hi + (ts - hi).astype(np.float32)).astype(np.float64)
