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

    def cached(self, kind, arrays, dtype, make):
        """make() (a numpy array computed from the numpy ``arrays``, or None)
        as a contiguous device tensor (or None), made once per distinct
        ``kind`` and values of ``arrays``."""
        key = (kind, dtype) + tuple((a.shape, a.tobytes()) for a in arrays)
        if key not in self._cache:
            if len(self._cache) >= _LIMIT:
                self._cache.clear()
            a = make()
            self._cache[key] = None if a is None else torch.as_tensor(
                np.ascontiguousarray(a), dtype=dtype, device=self.device)
        return self._cache[key]

    def times(self, tp, tc, dtype=torch.float64):
        """(tp, tc) as contiguous device tensors."""
        tp = np.asarray(tp, dtype=np.float64)
        tc = np.asarray(tc, dtype=np.float64)
        return (self.cached("t", (tp,), dtype, lambda: tp),
                self.cached("t", (tc,), dtype, lambda: tc))

    def steps(self, tp, tc, dtype=torch.float64):
        """tc - tp, the step sizes (computed in float64 numpy, as the JAX
        package's traced t_stop - t_start), on the device."""
        tp = np.asarray(tp, dtype=np.float64)
        tc = np.asarray(tc, dtype=np.float64)
        return self.cached("dt", (tp, tc), dtype, lambda: tc - tp)


class ChainSteps:
    """``step`` and ``step_batched`` of a model whose stepper is
    ``step_chain`` (J chains of L steps): a step is a chain with L = 1.
    Comes before ``Application`` among a model's bases.

    A model whose kernel steps all chains one step at a time keeps this
    ``step_chain`` and supplies ``_lane_step(x, k, tables, out, g)`` (out =
    [g +] Phi(x) of step k, for the J states x) and, where its step needs
    more than the step sizes, ``_chain_tables(tp, tc, dtype)``; a model whose
    kernel runs whole chains overrides ``step_chain``."""

    def _chain_tables(self, tp, tc, dtype):
        """What ``_lane_step`` reads for the (L, J) step times tp, tc: here
        the step sizes tc - tp on the device (copied once per distinct
        table, ``StepTimes``)."""
        return self._times.steps(tp, tc, dtype)

    def step_chain(self, seed, t_prev, t_curr, out, g=None):
        """J chains of L steps: out[:, k] = [g[:, k] +] Phi(out[:, k-1]) with
        out[:, -1] = seed.  seed: (J, ...) states; t_prev, t_curr: (L, J)
        numpy step times; out, g: (J, L, ...) views (g optional) that must
        not overlap seed.  Returns out."""
        tp = np.asarray(t_prev, dtype=np.float64)
        tc = np.asarray(t_curr, dtype=np.float64)
        tables = self._chain_tables(tp, tc, seed.dtype)
        x = seed
        for k in range(tp.shape[0]):
            self._lane_step(x, k, tables, out[:, k], None if g is None else g[:, k])
            x = out[:, k]
        return out

    def step(self, u_start, t_start, t_stop):
        return self.step_batched(u_start[None], [float(t_start)], [float(t_stop)])[0]

    def step_batched(self, u_tube, t_starts, t_stops):
        """One step of each of B states."""
        out = torch.empty_like(u_tube)
        tp = np.asarray(t_starts, dtype=np.float64).reshape(1, -1)
        tc = np.asarray(t_stops, dtype=np.float64).reshape(1, -1)
        self.step_chain(u_tube, tp, tc, out[:, None])
        return out
