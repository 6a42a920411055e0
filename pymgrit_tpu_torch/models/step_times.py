"""Device copies of the solver's step-time tables, cached by value, and
the single and batched steps of a model that steps in chains.

The solver hands ``step_chain`` its (L, J) step times as numpy arrays (the
same arrays every iteration, see ``Mgrit._block_times``).  A model whose
kernel reads times on the device would otherwise copy them from pageable
host memory on every call, which synchronises the stream; this cache copies
each distinct table once.
"""

from __future__ import annotations

import numpy as np
import torch

_LIMIT = 64          # distinct tables kept per model (cleared when exceeded)


class StepTimes:
    def __init__(self, device):
        self.device = device
        self._cache = {}

    def _get(self, kind, arrays, dtype, make):
        key = (kind, dtype) + tuple((a.shape, a.tobytes()) for a in arrays)
        t = self._cache.get(key)
        if t is None:
            if len(self._cache) >= _LIMIT:
                self._cache.clear()
            t = self._cache[key] = torch.as_tensor(np.ascontiguousarray(make()), dtype=dtype,
                                                   device=self.device)
        return t

    def times(self, tp, tc, dtype=torch.float64):
        """(tp, tc) as contiguous device tensors."""
        tp = np.asarray(tp, dtype=np.float64)
        tc = np.asarray(tc, dtype=np.float64)
        return (self._get("t", (tp,), dtype, lambda: tp),
                self._get("t", (tc,), dtype, lambda: tc))

    def steps(self, tp, tc, dtype=torch.float64):
        """tc - tp, the step sizes (computed in float64 numpy, as the JAX
        package's traced t_stop - t_start), on the device."""
        tp = np.asarray(tp, dtype=np.float64)
        tc = np.asarray(tc, dtype=np.float64)
        return self._get("dt", (tp, tc), dtype, lambda: tc - tp)


class ChainSteps:
    """``step`` and ``step_batched`` of a model whose stepper is
    ``step_chain`` (J chains of L steps): a step is a chain with L = 1.
    Comes before ``Application`` among a model's bases."""

    def step(self, u_start, t_start, t_stop):
        return self.step_batched(u_start[None], [float(t_start)], [float(t_stop)])[0]

    def step_batched(self, u_tube, t_starts, t_stops):
        """One step of each of B states."""
        out = torch.empty_like(u_tube)
        tp = np.asarray(t_starts, dtype=np.float64).reshape(1, -1)
        tc = np.asarray(t_stops, dtype=np.float64).reshape(1, -1)
        self.step_chain(u_tube, tp, tc, out[:, None])
        return out
