"""1D heat equation with two-points-per-vector states (BDF1 / BDF2).

Counterpart of ``pymgrit_tpu/models/heat_1d_2pts.py``: the pair state holds
the solution at two consecutive time values t and t + dtau; ``Heat1DBDF1``
takes two backward-Euler sub-steps per MGRIT step, ``Heat1DBDF2`` two
variable-step BDF2 steps (a Helmholtz solve each) after a trapezoidal
bootstrap of the second initial value.

State layout: the port's solver carries single tensors, so a pair is one
(2, n) tensor, ``first`` then ``second`` (JAX's is the dict {'first',
'second'}); the norm runs over both points, as JAX's does, and kernel K3
reads each state as one contiguous row of 2n values.  Every solve runs
through kernel K20 ``sine_solve1d`` on the pair's strided slots: BDF1 in
K20's BE mode, BDF2 in its BDF2 mode (the three-term right-hand side
(rhs - c2 first) + c1 second and the divisor lam + coeff, with per-lane
coefficients computed in float64 numpy with JAX's expressions and copied to
the device once per distinct set of step times).  The rhs is tabulated at
every grid time t and at t + dtau in one numpy evaluation; a chain gathers
its rows through a device index made once per distinct set of step times.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.rhs_table import grid_index, table_rows
from pymgrit_tpu_torch.models.step_times import ChainSteps, StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis, solve_shifted_1d


def PairState(first, second):
    """Two consecutive time values grouped as one state: the (..., 2, n)
    tensor of ``first`` and ``second``."""
    return torch.stack([torch.as_tensor(first), torch.as_tensor(second)], dim=-2)


def _bdf2_coefficients(tau_i, tau_im1):
    """(coeffm2, coeffm1, coeff) of a variable-step BDF2 step (JAX's
    expressions, float64 numpy)."""
    r_i = tau_i / tau_im1
    coeffm2 = (r_i ** 2) / (tau_i * (1 + r_i))
    coeffm1 = (1 + r_i) / tau_i
    coeff = (1 + 2 * r_i) / (tau_i * (1 + r_i))
    return coeffm2, coeffm1, coeff


class _HeatPairBase(ChainSteps, Application):
    """Shared setup: interior grid, sine eigenbasis, rhs tables.

    ``rhs(x, t)`` and ``init_cond(x)`` are numpy callables (evaluated once on
    the host).  ``device`` (the CUDA card unless ``"cpu"`` is asked for)
    places the state and tables; ``ops`` selects the kernel set
    (``pymgrit_tpu_torch.ops.DISPATCH`` by default; ``ops.PLAIN`` runs the
    plain versions on any device)."""

    def __init__(self, x_start: float, x_end: float, nx: int, dtau: float, a: float,
                 init_cond: Callable = lambda x: x * 0,
                 rhs: Callable = lambda x, t: x * 0, *args, device=None, ops: Ops = DISPATCH,
                 **kwargs):
        super().__init__(*args, **kwargs)
        x = np.linspace(x_start, x_end, nx)
        self.x = x[1:-1]
        self.nx = nx - 2
        self.dx = self.x[1] - self.x[0]
        self.a = a
        self.dtau = dtau
        self.rhs = rhs
        self.init_cond = init_cond
        self.device = model_device(device)
        self.ops = ops
        self._S_np, self._lam_np = sine_eigenbasis(self.nx, a / self.dx ** 2)
        self.S = self._tensor(self._S_np)
        self.lam = self._tensor(self._lam_np)
        self._times = StepTimes(self.device)
        self._build_rhs_tables()
        self.vector_template = torch.zeros((2, self.nx), dtype=torch.float64, device=self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=self.device)

    def _rhs_np(self, t) -> np.ndarray:
        return np.asarray(self.rhs(self.x, t), dtype=np.float64) * np.ones(self.nx)

    def _build_rhs_tables(self):
        """rhs(x, t) and rhs(x, t + dtau) at every grid time in one numpy
        evaluation; a time-independent rhs keeps one row of each."""
        ts = np.asarray(self.t, dtype=np.float64)
        both = np.concatenate([ts, ts + self.dtau])
        raw = np.asarray(self.rhs(self.x[None, :], both[:, None]), dtype=np.float64) \
            * np.ones((both.size, self.nx))
        if np.all(raw == raw[:1]):
            raw, ts = raw[[0, ts.size]], ts[:1]
        self._rhs_times = np.ascontiguousarray(ts)
        self._rhs_tbl_t = (self._tensor(raw[:ts.size]), self._tensor(raw[ts.size:]))

    def _rhs_rows(self, ts, shifted=False) -> torch.Tensor:
        """rhs rows at the times ts (numpy, any shape S), or at ts + dtau, as
        an S + (nx,) tensor.  Grid times gather table rows through a device
        index made once per distinct ts (``StepTimes``), so a solve copies
        no index to the device; other times go through ``table_rows``."""
        tbl = self._rhs_tbl_t[int(shifted)]
        if tbl.shape[0] == 1:
            return tbl[0].expand(ts.shape + (self.nx,))
        idx = self._times.cached("rhs", (ts,), torch.int64,
                                 lambda: grid_index(self._rhs_times, ts.reshape(-1)))
        if idx is None:
            tau = self.dtau if shifted else 0.0
            return table_rows(tbl, torch.as_tensor(self._rhs_times), ts,
                              lambda t: self._tensor(self._rhs_np(t + tau)))
        return tbl.index_select(0, idx).view(ts.shape + (self.nx,))

    def _lane_step(self, x, k, tables, out, g):
        """Step k of ``ChainSteps.step_chain`` for the (J, 2, nx) pairs x:
        ``_pair_step`` with the chain's tables at k, then [+ g]."""
        self._pair_step(x, out, *(t[k] for t in tables))
        if g is not None:
            out.add_(g)


class Heat1DBDF1(_HeatPairBase):
    """Pairwise BDF1: two backward-Euler sub-steps per MGRIT step."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        tmp1 = np.asarray(self.init_cond(self.x), dtype=np.float64)
        tmp2 = solve_shifted_1d(self._S_np, self._lam_np, self.dtau,
                                tmp1 + self._rhs_np(self.t[0] + self.dtau) * self.dtau)
        self.vector_t_start = self._tensor(np.stack([tmp1, tmp2]))

    def _chain_tables(self, tp, tc, dtype):
        """Per step of the (L, J) step times: the first sub-step's (J,)
        sizes t_stop - t_start - dtau, the second's dtau, and the rhs rows at
        t_stop and t_stop + dtau."""
        return (self._times.cached("bdf1", (tp, tc), dtype, lambda: (tc - tp) - self.dtau),
                self._times.cached("dtau", (tc,), dtype, lambda: np.full(tc.shape, self.dtau)),
                self._rhs_rows(tc), self._rhs_rows(tc, shifted=True))

    def _pair_step(self, u, out, dt1, dtau, rhs, rhs_shifted):
        """out = the pair after one step of each of the B pairs u (K20, BE
        mode twice: second -> t_stop, then -> t_stop + dtau)."""
        self.ops.sine_solve1d(u[:, 1], out[:, 0], self.S, self.lam, dt1, rhs)
        self.ops.sine_solve1d(out[:, 0], out[:, 1], self.S, self.lam, dtau, rhs_shifted)


class Heat1DBDF2(_HeatPairBase):
    """Pairwise variable-step BDF2: each solve is (L + coeff I) x = rhs."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        tmp1 = np.asarray(self.init_cond(self.x), dtype=np.float64)
        dtau = self.dtau
        S, lam = self._S_np, self._lam_np
        lap_tmp1 = S @ ((S @ tmp1) * lam)
        b = tmp1 - (dtau / 2) * lap_tmp1 + (dtau / 2) * (
            self._rhs_np(self.t[0]) + self._rhs_np(self.t[0] + dtau))
        tmp2 = solve_shifted_1d(S, lam, dtau / 2, b)
        self.vector_t_start = self._tensor(np.stack([tmp1, tmp2]))

    def _chain_tables(self, tp, tc, dtype):
        """Per step of the (L, J) step times: the (6, J) coefficients
        (coeffm2, coeffm1, coeff) of the step to t_stop, then of the step to
        t_stop + dtau, and the rhs rows at t_stop and t_stop + dtau."""
        def make():
            tau_i = (tc - tp) - self.dtau
            return np.stack(_bdf2_coefficients(tau_i, self.dtau)
                            + _bdf2_coefficients(self.dtau, tau_i), axis=1)
        return (self._times.cached("bdf2", (tp, tc), dtype, make),
                self._rhs_rows(tc), self._rhs_rows(tc, shifted=True))

    def _pair_step(self, u, out, c, rhs, rhs_shifted):
        """out = the pair after one step of each of the B pairs u (K20, BDF2
        mode twice: from (first, second) to t_stop, then from (second, the
        new first) to t_stop + dtau)."""
        self.ops.sine_solve1d(u[:, 0], out[:, 0], self.S, self.lam, rhs=rhs, second=u[:, 1],
                              c2=c[0], c1=c[1], coeff=c[2])
        self.ops.sine_solve1d(u[:, 1], out[:, 1], self.S, self.lam, rhs=rhs_shifted,
                              second=out[:, 0], c2=c[3], c1=c[4], coeff=c[5])
