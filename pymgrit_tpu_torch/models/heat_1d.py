"""1D heat equation with homogeneous Dirichlet BCs, in the physical or the
sine eigenbasis.

Counterpart of ``pymgrit_tpu/models/heat_1d.py`` (backward Euler).  The
state is the (nx-2,) vector of interior values (``basis='physical'``, the
default) or of their sine coefficients (``basis='spectral'``), and the BE
step is u' = (I + dt L)^-1 (u + dt b(x, t')) with the 3-point Laplacian L.

* spectral: the step is elementwise, u'^ = (u^ + dt rhs^) / (1 + dt lam);
  ``step_chain`` runs kernel K2 ``theta_chain`` with a zero lift (the same
  expression), ``relax_interval`` kernel K1 ``interval_affine`` on the
  closed-form tables, and ``affine_coeffs`` hands the step to the
  coarsest-level strategies (K8, K9).
* physical: a batched step is two products with the orthonormal sine
  basis around the diagonal solve, kernel K20 ``sine_solve1d`` (the JAX
  package leaves them to XLA as plain einsums); ``relax_interval``
  transforms the seeds (K20), applies the closed-form tables through K1
  and transforms back (K20).

The rhs is tabulated over the level's grid times in one numpy evaluation
(raw samples in the physical basis, transformed ones in the spectral basis),
so every phase reads samples of one evaluation context.

``precision='dd'`` (the JAX package's double-double mode, ``ops/dd.py``):
float32-pair state and tables, a float32 rhs table looked up at each
time's float32 value; spectral chains run K24 ``dd_theta_chain`` (BE with
a zero lift) and ``relax_interval`` K23 ``dd_interval_affine``; a physical
step is K25 ``dd_arith`` around two K26 ``dd_matmul`` sine products on all
lanes, and its ``relax_interval`` declines, as the JAX package's does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.rhs_table import dd_time_keys, table_rows
from pymgrit_tpu_torch.models.step_times import StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops import dd
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis, solve_shifted_1d


class Heat1D(Application):
    """u_t - a*u_xx = b(x,t) on [x_start, x_end], homogeneous Dirichlet BCs.

    ``rhs(x, t)`` and ``init_cond(x)`` are numpy callables (evaluated once on
    the host).  ``device`` (the CUDA card unless ``"cpu"`` is asked for)
    places the state and tables; ``ops`` selects the kernel set
    (``pymgrit_tpu_torch.ops.DISPATCH`` by default; ``ops.PLAIN`` runs the
    plain versions on any device).
    """

    def __init__(self, x_start: float, x_end: float, nx: int, a: float,
                 init_cond: Callable = lambda x: x * 0, rhs: Callable = lambda x, t: x * 0,
                 precision: str = None, basis: str = 'physical',
                 *args, device=None, ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        if basis not in ('physical', 'spectral'):
            raise Exception("basis must be 'physical' or 'spectral'")
        self._dd = precision == 'dd'
        self._spectral = basis == 'spectral'
        self.device = model_device(device)
        self.ops = ops
        self.x_start = x_start
        self.x_end = x_end
        self.x = np.linspace(x_start, x_end, nx)[1:-1]       # interior points only
        self.nx = nx - 2
        self.dx = self.x[1] - self.x[0]
        self.a = a
        self.rhs = rhs
        self.init_cond = init_cond

        self._S_np, self._lam_np = sine_eigenbasis(self.nx, self.a / self.dx ** 2)
        self.S = self._tensor(self._S_np)
        self.lam = self._tensor(self._lam_np)
        self._zero_lift = torch.zeros(self.nx, dtype=torch.float64, device=self.device)
        init = np.asarray(init_cond(self.x), dtype=np.float64) * np.ones(self.nx)
        if self._spectral:
            init = self._S_np @ init
        self.vector_t_start = self._tensor(init)
        self.vector_template = torch.zeros(self.nx, dtype=torch.float64, device=self.device)
        self._itbl_cache = {}       # (dt, m1) -> (A_k, G_k) numpy float64
        self._itbl_dev = {}         # (dt, m1) -> (A_k, G_k) (m1, nx) device tensors
        self._affine_dev = {}       # dt -> affine step (A, c) rows on the device
        self._times = StepTimes(self.device)    # step-size tables on the device (K2, DD)
        if self._dd:
            self.vector_t_start = self._split(init)
            self.vector_template = self._split(np.zeros(self.nx))
            self._lam_dd, self._S_dd = self._split(self._lam_np), self._split(self._S_np)
            self._zero_lift_dd = self._split(np.zeros(self.nx))
        self._build_rhs_table()
        if self._spectral and not self._dd:
            self.affine_coeffs = self._affine_coeffs_spectral

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=self.device)

    def _split(self, a) -> dd.DD:
        """float64 values split exactly into a DD pair on the device."""
        return dd.from_f64(np.ascontiguousarray(a), self.device, self.ops)

    # ------------------------------------------------------------------
    # the rhs table
    # ------------------------------------------------------------------

    def _build_rhs_table(self):
        """Tabulate rhs(x, t) over this level's grid times in one numpy
        evaluation; a time-independent rhs keeps one row.  The spectral
        table holds transformed rows (S is symmetric: r @ S == S @ r).  In
        DD the rhs is evaluated at the float32 times and the table holds
        float32 samples (the JAX package's DD table)."""
        ts = np.asarray(self.t, dtype=np.float64)
        if self._dd:
            ts = ts.astype(np.float32)
        raw = np.asarray(self.rhs(self.x[None, :], ts[:, None]), dtype=np.float64) \
            * np.ones((ts.size, self.nx))
        if np.all(raw == raw[:1]):
            raw, ts = raw[:1], ts[:1]
        tbl = raw @ self._S_np if self._spectral else raw
        if self._dd:
            tbl = tbl.astype(np.float32)
            raw = tbl if not self._spectral else raw
        self._rhs_tbl = tbl
        self._rhs_tbl0_hat_np = tbl[0].astype(np.float64) if self._spectral \
            else self._S_np @ raw[0].astype(np.float64)
        self._rhs_tbl_t = torch.as_tensor(tbl, device=self.device) if self._dd else self._tensor(tbl)
        self._rhs_times_t = torch.as_tensor(np.ascontiguousarray(ts), dtype=torch.float64)

    def _rhs_rows(self, ts) -> torch.Tensor:
        """Table rows (rhs, or rhs^ in the spectral basis) at the times ts
        (numpy, any shape S; in DD also DD times) as an S + (nx,) view
        (``table_rows``); in DD at each time's float32 value."""
        if self._dd:
            ts = dd_time_keys(ts)
        return table_rows(self._rhs_tbl_t, self._rhs_times_t, ts, self._rhs_sample)

    def _rhs_sample(self, t) -> torch.Tensor:
        r = np.asarray(self.rhs(self.x, np.float32(t) if self._dd else t), dtype=np.float64) \
            * np.ones(self.nx)
        r = self._S_np @ r if self._spectral else r
        if self._dd:
            return torch.as_tensor(r.astype(np.float32), device=self.device)
        return self._tensor(r)

    def _rhs_at(self, t) -> torch.Tensor:
        return self._rhs_rows(np.asarray(float(t)))

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def step(self, u_start, t_start, t_stop):
        if self._dd:
            return self.step_batched(u_start[None], t_start.reshape(1), t_stop.reshape(1))[0]
        dt = float(t_stop) - float(t_start)
        if self._spectral:
            return (u_start + dt * self._rhs_at(t_stop)) / (1.0 + dt * self.lam)
        b = u_start + dt * self._rhs_at(t_stop)
        return solve_shifted_1d(self.S, self.lam, dt, b)

    def step_batched(self, u_tube, t_starts, t_stops):
        """One step of each of B states (t_starts, t_stops: numpy (B,)).
        Physical: K20, two flat (B, nx) @ (nx, nx) products around the
        diagonal solve (S is symmetric, so S @ b == b @ S), its step sizes
        a device table made once per distinct set of step times
        (``StepTimes``).  Spectral: step_chain with L = 1 (K2)."""
        if self._dd:
            out = torch.empty((u_tube.shape[0], 1, 2, self.nx), dtype=torch.float32,
                              device=self.device)
            self._dd_chain(dd.packed(u_tube), dd.sub(t_stops, t_starts).reshape(1, -1),
                           self._rhs_rows(t_stops)[None], out)
            return dd.pair(out[:, 0], self.ops)
        tp = np.asarray(t_starts, dtype=np.float64).reshape(-1)
        tc = np.asarray(t_stops, dtype=np.float64).reshape(-1)
        out = torch.empty(u_tube.shape, dtype=u_tube.dtype, device=u_tube.device)
        if self._spectral:
            self.step_chain(u_tube, tp[None], tc[None], out[:, None])
            return out
        return self.ops.sine_solve1d(u_tube, out, self.S, self.lam,
                                     self._times.steps(tp, tc, self.lam.dtype), self._rhs_rows(tc))

    def step_chain(self, seed, t_prev, t_curr, out, g=None):
        """J chains of L steps: out[:, k] = [g[:, k] +] Phi(out[:, k-1]) with
        out[:, -1] = seed.  Spectral: one K2 launch with a zero lift, whose
        BE step (x + dt*rhs^ + dt*0) / (1 + dt*lam) is this model's step.
        Physical: step_batched per step.

        seed: (J, nx); t_prev, t_curr: (L, J) numpy step times; out, g:
        (J, L, nx) views (g optional) that must not overlap seed.  Returns
        out."""
        tp = np.asarray(t_prev, dtype=np.float64)
        tc = np.asarray(t_curr, dtype=np.float64)
        if self._dd:
            return self._dd_chain(seed, self._times.dd_steps(tp, tc, self.ops), self._rhs_rows(tc),
                                  out, g)
        if self._spectral:
            rhs1 = self._rhs_rows(tc)
            self.ops.theta_chain(seed, out, self._times.steps(tp, tc, seed.dtype), self.lam,
                                 self._zero_lift, rhs1, rhs1, 1.0, g)
            return out
        x = seed
        for k in range(tp.shape[0]):
            x = self.step_batched(x, tp[k], tc[k])
            if g is not None:
                x = g[:, k] + x
            out[:, k] = x
            x = out[:, k]
        return out

    # ------------------------------------------------------------------
    # closed-form interval relaxation
    # ------------------------------------------------------------------

    def _interval_tables(self, dt, m1):
        """Closed-form relaxation tables: BE in eigenspace is u -> A*u + c
        with A = 1/(1+dt*lam), c = dt*rhs0^/(1+dt*lam), so the k-th F-point of
        an interval is A^k * seed + G_k with G_k = A*G_{k-1} + c; rows
        k = 0..m1-1 hold A^(k+1) and G_(k+1).  Float64 numpy, cached per
        (dt, m1)."""
        key = (float(dt), int(m1))
        if key in self._itbl_cache:
            return self._itbl_cache[key]
        lam = self._lam_np
        A = 1.0 / (1.0 + dt * lam)
        c = dt * self._rhs_tbl0_hat_np * A
        A_k = np.empty((m1,) + lam.shape)
        G_k = np.empty((m1,) + lam.shape)
        A_k[0], G_k[0] = A, c
        for k in range(1, m1):
            A_k[k] = A_k[k - 1] * A
            G_k[k] = A * G_k[k - 1] + c
        self._itbl_cache[key] = (A_k, G_k)
        return A_k, G_k

    def _interval_tables_dev(self, dt, m1):
        key = (float(dt), int(m1))
        if key not in self._itbl_dev:
            make = self._split if self._dd else self._tensor
            self._itbl_dev[key] = tuple(make(x) for x in self._interval_tables(dt, m1))
        return self._itbl_dev[key]

    def relax_interval(self, seed, t_prev, t_curr, only_last=False,
                       interval_major=False, out=None, seed_out=None):
        """Closed-form F-values of J intervals through K1 (the physical
        basis transforms the seeds first and the values back, K20).

        t_prev, t_curr: (rows, J) numpy step times.  Returns the
        (rows, J, nx) F-values, or (J, rows, nx) with interval_major;
        only_last keeps just row rows-1.  With ``out`` (a (J, R, nx) view)
        the values are written there and out is returned; ``seed_out``
        optionally receives a copy of the seeds.  Declines (None) for
        non-uniform dt or a time-dependent rhs, and in DD for the physical
        basis; in DD the views are packed (…, 2, nx) and K23 runs."""
        if self._dd and not self._spectral:
            return None
        dts = np.asarray(t_curr, np.float64) - np.asarray(t_prev, np.float64)
        if dts.size == 0:
            return None
        dt = float(dts.flat[0])
        if not np.allclose(dts, dt, rtol=1e-12, atol=0.0):
            return None
        if self._rhs_tbl.shape[0] != 1:
            return None                           # time-dependent rhs
        m1 = t_prev.shape[0]
        A_t, G_t = self._interval_tables_dev(dt, m1)
        r0, R = (m1 - 1, 1) if only_last else (0, m1)
        J, N = seed.shape[0], self.nx
        result = out
        if out is None:
            shape = (2, N) if self._dd else (N,)
            if interval_major:
                result = out = torch.empty((J, R) + shape, dtype=seed.dtype, device=seed.device)
            else:
                result = torch.empty((R, J) + shape, dtype=seed.dtype, device=seed.device)
                out = result.transpose(0, 1)
        if self._dd:
            self.ops.dd_interval_affine(dd.pair(seed, self.ops), A_t, G_t, dd.pair(out, self.ops, 2),
                                        r0, None if seed_out is None else dd.pair(seed_out, self.ops))
            return result
        if self._spectral:
            self.ops.interval_affine(seed, A_t, G_t, out, r0, seed_out)
            return result
        xhat = torch.empty((J, N), dtype=seed.dtype, device=seed.device)
        yhat = torch.empty((J, R, N), dtype=seed.dtype, device=seed.device)
        self.ops.sine_solve1d(seed, xhat, self.S)
        self.ops.interval_affine(xhat, A_t, G_t, yhat, r0)
        if seed_out is not None:
            seed_out.copy_(seed)
        self.ops.sine_solve1d(yhat.view(J * R, N), out, self.S)
        return result

    # ------------------------------------------------------------------
    # the affine step of the coarsest-level strategies, and output
    # ------------------------------------------------------------------

    def _affine_coeffs_spectral(self, t_start, t_stop):
        """(A, c) with step(u, t0, t1) == A*u + c for every pair of the (n,)
        step times: (n, nx) tensors, or one row broadcast over n (stride 0)
        where every dt is the same and the rhs is time-independent."""
        tp = np.asarray(t_start, dtype=np.float64)
        tc = np.asarray(t_stop, dtype=np.float64)
        dts = tc - tp
        shape = dts.shape + (self.nx,)
        dt0 = float(dts.flat[0]) if dts.size else 0.0
        if self._rhs_tbl.shape[0] == 1 and np.all(dts == dt0):
            if dt0 not in self._affine_dev:
                denom = 1.0 + dt0 * self.lam
                self._affine_dev[dt0] = (1.0 / denom, dt0 * self._rhs_tbl_t[0] / denom)
            return tuple(x.expand(shape) for x in self._affine_dev[dt0])
        dt = self._tensor(dts.reshape(-1, 1))
        denom = 1.0 + dt * self.lam
        c = dt * self._rhs_rows(tc).reshape(-1, self.nx) / denom
        return (1.0 / denom).view(shape), c.view(shape)

    def to_physical(self, u_hat):
        """Spectral coefficients (..., nx) -> interior values (..., nx); a DD
        state counts with its float32 value, transformed in float64."""
        if isinstance(u_hat, dd.DD):
            u_hat = u_hat.to_float().double()
        return u_hat @ self.S.to(u_hat.device, u_hat.dtype)

    # ------------------------------------------------------------------
    # precision='dd': chains on packed (…, 2, nx) float32 views
    # ------------------------------------------------------------------

    def _dd_chain(self, seed, dt, rhs1, out, g=None):
        """J chains of L DD steps into out (the layout of ``step_chain``):
        spectral, one K24 launch (BE, zero lift: its step is this model's
        (u + dt rhs^) / (1 + dt lam)); physical, per step the JAX package's
        b = u + dt rhs, S b / (1 + dt lam), S (...) on all lanes (K25, K26).
        dt: (L, J) DD step sizes; rhs1: (L, J, nx) float32 rows."""
        ops, pair = self.ops, (lambda t, axis=1: dd.pair(t, self.ops, axis))
        if self._spectral:
            ops.dd_theta_chain(pair(seed), pair(out, 2), dt, self._lam_dd, self._zero_lift_dd,
                               rhs1, rhs1, 1.0, None if g is None else pair(g, 2))
            return out
        J, n = seed.shape[0], self.nx
        St = self._S_dd.T[None]
        x = seed
        for k in range(dt.shape[0]):
            d = dt[k][:, None]
            b = pair(x) + d * rhs1[k]
            bh = ops.dd_matmul(b[None], St)[0]
            xh = bh / (d * self._lam_dd + 1.0)
            y = pair(out[:, k])
            ops.dd_matmul(xh[None], St, out=y[None])
            if g is not None:
                ops.dd_arith("add", pair(g[:, k]), y, out=y)
            x = out[:, k]
        return out
