"""2D heat equation with Dirichlet BCs, in the physical or the sine
eigenbasis.

Counterpart of ``pymgrit_tpu/models/heat_2d.py`` (methods BE, CN and, in
the physical basis, FE).

* ``basis='physical'`` (the default): the state is the full (nx, ny) field
  with its Dirichlet ring.  A BE/CN step is one stencil pass that assembles
  the right-hand side (K7 ``theta_rhs2d``) and the two-sided sine solve of
  the interior, which writes the ring too (K5 ``sine_solve2d``); an FE step
  is K7 alone.  The closed-form interval relaxation ``relax_interval``
  transforms the seeds (K5) and writes the back-transformed F-values with
  their ring (K6 ``sine_affine2d``).
* ``basis='spectral'``: the state is the (nx-2, ny-2) array of sine
  coefficients of the interior, so every theta-step is elementwise:

      u'^ = (u^ (1 - th'*dt*Lam) + (th+th')*dt*lift^ + dt*rhs^) / (1 + th*dt*Lam)

  with th' = theta for CN and 0 for BE (derivation in the JAX module);
  ``step_chain`` and ``step_batched`` go through K2 ``theta_chain`` and
  ``relax_interval`` through K1 ``interval_affine``; ``affine_coeffs``
  hands the step to the coarsest-level strategies (K8, K9).

Both bases share the closed-form tables (the physical BE/CN step is the
spectral affine map conjugated by the orthogonal sine basis).  All tables
are built in float64 on the host once and copied to the device.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.rhs_table import table_rows
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis

_RHS_CHUNK = 1024      # time samples per batched rhs evaluation on the host


class Heat2D(Application):
    """u_t - a*(u_xx + u_yy) = b(x,y,t) with Dirichlet BCs.

    ``rhs(x, y, t)`` and ``init_cond(x, y)`` are numpy callables (they are
    evaluated once on the host).  ``device`` (the CUDA card unless ``"cpu"``
    is asked for) places the state and tables; ``ops`` selects the kernel
    set (``pymgrit_tpu_torch.ops.DISPATCH`` by default; ``ops.PLAIN`` runs
    the plain versions on any device).
    """

    def __init__(self, x_start: float, x_end: float, y_start: float, y_end: float,
                 nx: int, ny: int, a: float,
                 rhs: Callable = lambda x, y, t: 0 * x * y,
                 init_cond: Callable = lambda x, y: x * y * 0, method: str = 'BE',
                 bc_left: Union[int, float, Callable] = 0,
                 bc_right: Union[int, float, Callable] = 0,
                 bc_bottom: Union[int, float, Callable] = 0,
                 bc_top: Union[int, float, Callable] = 0,
                 precision: str = None, basis: str = 'physical',
                 *args, device=None, ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        if basis not in ('physical', 'spectral'):
            raise Exception("basis must be 'physical' or 'spectral'")
        self._spectral = basis == 'spectral'
        if self._spectral and method == 'FE':
            # the FE quirk accumulates bc data onto the carried boundary
            # ring, which coefficient space does not have
            raise Exception("basis='spectral' supports BE/CN (theta > 0) only")
        if precision == 'dd':
            raise NotImplementedError("precision='dd' is not ported yet (ROADMAP A3)")
        if method == 'BE':
            self.theta = 1.0
        elif method == 'FE':
            self.theta = 0.0
        elif method == 'CN':
            self.theta = 0.5
        else:
            raise Exception("Unknown method. Choose BE (Backward Euler), FE (Forward Euler) or CN (Crank-Nicolson")
        self.device = model_device(device)
        self.ops = ops
        self.x = np.linspace(x_start, x_end, nx)
        self.y = np.linspace(y_start, y_end, ny)
        self.x_2d = self.x[:, np.newaxis]
        self.y_2d = self.y[np.newaxis, :]
        self.nx = nx
        self.ny = ny
        self.dx = self.x[1] - self.x[0]
        self.dy = self.y[1] - self.y[0]
        self.a = a
        self.rhs = rhs

        def _bc_arr(bc, coords, name):
            if isinstance(bc, (float, int)):
                return np.full(len(coords), float(bc))
            if callable(bc):
                return np.asarray(bc(coords), dtype=np.float64) * np.ones(len(coords))
            raise Exception("Choose float, int or function for boundary condition " + name)

        # edge conventions of the JAX package: values[:, 0]=left(x),
        # values[:, -1]=right(x), values[-1, :]=bottom(y), values[0, :]=top(y)
        self.bc_left_arr = _bc_arr(bc_left, self.x, 'bc_left')
        self.bc_right_arr = _bc_arr(bc_right, self.x, 'bc_right')
        self.bc_bottom_arr = _bc_arr(bc_bottom, self.y, 'bc_bottom')
        self.bc_top_arr = _bc_arr(bc_top, self.y, 'bc_top')

        self.fx = a / self.dx ** 2
        self.fy = a / self.dy ** 2
        self._Sx_np, lamx = sine_eigenbasis(nx - 2, self.fx)
        self._Sy_np, lamy = sine_eigenbasis(ny - 2, self.fy)
        self._xi = self.x_2d[1:-1]       # (nx-2, 1)
        self._yi = self.y_2d[:, 1:-1]    # (1, ny-2)
        self._int_shape = (nx - 2, ny - 2)
        self._N = (nx - 2) * (ny - 2)    # interior points = coefficients

        init = np.asarray(init_cond(self.x_2d, self.y_2d), dtype=np.float64) * np.ones((nx, ny))
        init[:, 0] = self.bc_left_arr
        init[:, -1] = self.bc_right_arr
        init[-1, :] = self.bc_bottom_arr
        init[0, :] = self.bc_top_arr

        # interior coupling to the Dirichlet data, and the data as a field
        # (the ring template the physical kernels copy)
        lift = np.zeros(self._int_shape)
        lift[:, 0] += self.fy * self.bc_left_arr[1:-1]
        lift[:, -1] += self.fy * self.bc_right_arr[1:-1]
        lift[0, :] += self.fx * self.bc_top_arr[1:-1]
        lift[-1, :] += self.fx * self.bc_bottom_arr[1:-1]
        ring = np.zeros((nx, ny))
        ring[:, 0] = self.bc_left_arr
        ring[:, -1] = self.bc_right_arr
        ring[-1, :] = self.bc_bottom_arr
        ring[0, :] = self.bc_top_arr
        self._lift_hat_np = self._Sx_np @ lift @ self._Sy_np
        self._Lam_np = lamx[:, None] + lamy[None, :]
        self._lift = self._tensor(lift)
        self._lift_hat = self._tensor(self._lift_hat_np)
        self._ring = self._tensor(ring)
        self._Lam = self._tensor(self._Lam_np)
        self._Sx = self._tensor(self._Sx_np)
        self._Sy = self._tensor(self._Sy_np)
        self._itbl_cache = {}       # (dt, m1) -> (A_k, G_k) numpy float64
        self._itbl_dev = {}         # (dt, m1) -> (A_k, G_k) (m1, N) device tensors
        self._dt_dev = {}           # step-size row -> (dt, theta*dt) device tensors
        self._dscale_dev = {}       # dt -> CN ring-correction scale (N,) on the device
        self._affine_dev = {}       # dt -> affine step (A, c) rows (N,) on the device

        if self._spectral:
            self._shape = self._int_shape
            self.vector_t_start = self._tensor(self._Sx_np @ init[1:-1, 1:-1] @ self._Sy_np)
        else:
            self._shape = (nx, ny)
            self.vector_t_start = self._tensor(init)
        self.vector_template = torch.zeros(self._shape, dtype=torch.float64, device=self.device)
        self._build_rhs_table()
        if self._spectral:
            # the spectral theta-step is the elementwise affine map
            # u -> A*u + c, so the coarsest-level strategies apply exactly
            self.affine_coeffs = self._affine_coeffs_spectral

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=self.device)

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------

    def prepare_runtime(self, level_info) -> None:
        """Pre-build the closed-form interval tables of level 0 (m-1 rows
        for the F-sweep, m rows for the condensed C-step) on the device."""
        if getattr(level_info, "lvl", 0) != 0:
            return
        if self.theta == 0.0:
            return                      # FE: the hook declines
        if not getattr(level_info, "uniform", False) or level_info.m <= 1:
            return
        t = np.asarray(level_info.t, dtype=np.float64)
        if t.size < 2:
            return
        dts = np.diff(t)
        if not np.allclose(dts, dts[0], rtol=1e-12, atol=0.0):
            return
        if self._rhs_tbl.shape[0] != 1:
            return                      # time-dependent rhs: hook declines
        for m1 in (level_info.m - 1, level_info.m):
            if m1 >= 1:
                self._interval_tables_dev(float(dts.flat[0]), m1)

    def _build_rhs_table(self):
        """Tabulate the rhs over this level's grid times in batched numpy
        evaluations, so every phase reads samples of one evaluation
        context: raw interior samples in the physical basis, transformed
        ones (rhs^ = Sx rhs Sy) in the spectral basis.  A time-independent
        rhs keeps one row (the raw samples are compared, so only one is
        transformed)."""
        ts = np.asarray(self.t, dtype=np.float64)
        one = np.ones((1,) + self._int_shape)
        s0, chunks, n_same = None, [], 0
        for lo in range(0, ts.shape[0], _RHS_CHUNK):
            tt = ts[lo:lo + _RHS_CHUNK, None, None]
            part = np.asarray(self.rhs(x=self._xi, y=self._yi, t=tt), dtype=np.float64) * one
            part = np.broadcast_to(part, (tt.shape[0],) + self._int_shape)
            if s0 is None:
                s0 = part[0].copy()
            if not chunks and np.all(part == s0[None]):
                n_same += part.shape[0]        # keep no copy while constant
                continue
            if not chunks:
                chunks.append(np.broadcast_to(s0, (n_same,) + self._int_shape))
            chunks.append(part)
        raw, self._rhs_tbl_times = (np.concatenate(chunks), ts) if chunks else (s0[None], ts[:1])
        if self._spectral:
            self._rhs_tbl = self._Sx_np @ raw @ self._Sy_np
            self._rhs_tbl0_hat_np = self._rhs_tbl[0]
        else:
            self._rhs_tbl = raw
            self._rhs_tbl0_hat_np = self._Sx_np @ s0 @ self._Sy_np
        self._rhs_tbl_t = self._tensor(self._rhs_tbl.reshape(self._rhs_tbl.shape[0], -1))
        self._rhs_times_t = torch.as_tensor(np.ascontiguousarray(self._rhs_tbl_times),
                                            dtype=torch.float64)

    def _rhs_rows(self, ts) -> torch.Tensor:
        """Table rows (rhs, or rhs^ in the spectral basis) at the times ts
        (numpy, any shape S) as an S + (N,) view (``table_rows``)."""
        return table_rows(self._rhs_tbl_t, self._rhs_times_t, ts, self._rhs_sample)

    def _rhs_sample(self, t) -> torch.Tensor:
        """The rhs callable at an off-grid time t (transformed in the
        spectral basis), as an (N,) row."""
        r = np.asarray(self.rhs(x=self._xi, y=self._yi, t=t), dtype=np.float64) \
            * np.ones(self._int_shape)
        if self._spectral:
            r = self._Sx_np @ r @ self._Sy_np
        return self._tensor(r.reshape(-1))

    def _rhs_at(self, t) -> torch.Tensor:
        """The table row at time t as an interior-shaped tensor."""
        return self._rhs_rows(np.asarray(float(t))).reshape(self._int_shape)

    def _interval_tables(self, dt, m1):
        """Closed-form relaxation tables: the spectral theta-step is the
        elementwise affine map u -> A*u + c, so the k-th F-point of an
        interval is A^k * seed + G_k with G_k = A*G_{k-1} + c.  Built in
        float64 numpy (the recurrence is cancellation-prone in float32),
        cached per (dt, m1); rows k = 0..m1-1 hold A^(k+1) and G_(k+1)."""
        key = (float(dt), int(m1))
        if key in self._itbl_cache:
            return self._itbl_cache[key]
        th = self.theta
        thp = 0.0 if th == 1.0 else th           # explicit half (CN)
        Lam = self._Lam_np
        denom = 1.0 + th * dt * Lam
        A = (1.0 - thp * dt * Lam) / denom
        rhs0 = self._rhs_tbl0_hat_np
        c = ((th + thp) * dt * self._lift_hat_np + dt * rhs0) / denom
        A_k = np.empty((m1,) + Lam.shape)
        G_k = np.empty((m1,) + Lam.shape)
        A_k[0], G_k[0] = A, c
        for k in range(1, m1):
            A_k[k] = A_k[k - 1] * A
            G_k[k] = A * G_k[k - 1] + c
        self._itbl_cache[key] = (A_k, G_k)
        return A_k, G_k

    def _interval_tables_dev(self, dt, m1):
        """_interval_tables as contiguous (m1, N) device tensors."""
        key = (float(dt), int(m1))
        if key not in self._itbl_dev:
            A_k, G_k = self._interval_tables(dt, m1)
            self._itbl_dev[key] = (self._tensor(A_k.reshape(m1, -1)),
                                   self._tensor(G_k.reshape(m1, -1)))
        return self._itbl_dev[key]

    def _step_sizes(self, dts):
        """(dt, theta*dt) of one step of J chains: floats when the J step
        sizes agree, else (J,) device tensors, built once per distinct row
        (so a solve copies no step sizes to the device per call)."""
        dt0 = float(dts[0])
        if np.all(dts == dt0):
            return dt0, self.theta * dt0
        key = dts.tobytes()
        if key not in self._dt_dev:
            self._dt_dev[key] = (self._tensor(dts), self._tensor(self.theta * dts))
        return self._dt_dev[key]

    def _ring_scale(self, dt):
        """theta*dt / (1 + theta*dt*Lam) as an (N,) device tensor: the scale
        of CN's ring correction in relax_interval."""
        key = float(dt)
        if key not in self._dscale_dev:
            shift = self.theta * dt
            self._dscale_dev[key] = self._tensor((shift / (1.0 + shift * self._Lam_np)).reshape(-1))
        return self._dscale_dev[key]

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def _step_spectral(self, u, t_start, t_stop):
        """One theta-step in coefficient space (plain tensor ops)."""
        t_start, t_stop = float(t_start), float(t_stop)
        dt = t_stop - t_start
        shift = dt * self.theta
        lift_hat, Lam = self._lift_hat, self._Lam
        if self.theta == 1.0:
            b = u + dt * self._rhs_at(t_stop) + shift * lift_hat
        else:
            b = (u - shift * (u * Lam)) \
                + (shift * 2.0) * lift_hat \
                + dt * (self.theta * self._rhs_at(t_stop)
                        + (1 - self.theta) * self._rhs_at(t_start))
        return b / (1.0 + shift * Lam)

    def _affine_step(self, dt, rhs1, rhs0):
        """(A, c) with _step_spectral(u) == A*u + c as (N,) rows (float dt)
        or (n, N) tables ((n, 1) tensor dt); rhs0 is read by CN only."""
        shift = dt * self.theta
        Lam, lift_hat = self._Lam.view(-1), self._lift_hat.view(-1)
        denom = 1.0 + shift * Lam
        if self.theta == 1.0:
            return 1.0 / denom, (dt * rhs1 + shift * lift_hat) / denom
        A = (1.0 - shift * Lam) / denom
        c = ((shift * 2.0) * lift_hat
             + dt * (self.theta * rhs1 + (1 - self.theta) * rhs0)) / denom
        return A, c

    def _affine_coeffs_spectral(self, t_start, t_stop):
        """(A, c) with _step_spectral(u, t0, t1) == A*u + c for every pair
        of the (n,) step times: (n, nx-2, ny-2) tensors.  Where every dt is
        the same and the rhs is time-independent, both are one row
        broadcast over n (stride 0), built once per dt."""
        tp = np.asarray(t_start, dtype=np.float64)
        tc = np.asarray(t_stop, dtype=np.float64)
        dts = tc - tp
        shape = dts.shape + self._int_shape
        dt0 = float(dts.flat[0]) if dts.size else 0.0
        if self._rhs_tbl.shape[0] == 1 and np.all(dts == dt0):
            if dt0 not in self._affine_dev:
                row = self._rhs_tbl_t[0]
                self._affine_dev[dt0] = self._affine_step(dt0, row, row)
            return tuple(x.view(self._int_shape).expand(shape) for x in self._affine_dev[dt0])
        dt = self._tensor(dts.reshape(-1, 1))
        rhs1 = self._rhs_rows(tc).reshape(-1, self._N)
        rhs0 = rhs1 if self.theta == 1.0 else self._rhs_rows(tp).reshape(-1, self._N)
        A, c = self._affine_step(dt, rhs1, rhs0)
        return A.view(shape), c.view(shape)

    def step(self, u_start, t_start, t_stop):
        if self._spectral:
            return self._step_spectral(u_start, t_start, t_stop)
        return self.step_batched(u_start[None], [float(t_start)], [float(t_stop)])[0]

    def step_chain(self, seed, t_prev, t_curr, out, g=None):
        """J chains of L steps: out[:, k] = [g[:, k] +] Phi(out[:, k-1]) with
        out[:, -1] = seed.  Spectral: one K2 launch.  Physical: per step,
        K7 assembles the right-hand side and K5 solves and writes the state
        with its ring and g (BE, CN), or K7 writes the whole step (FE).

        seed: (J, ...) states; t_prev, t_curr: (L, J) numpy step times;
        out, g: (J, L, ...) views (g optional) that must not overlap seed.
        Returns out."""
        tp = np.asarray(t_prev, dtype=np.float64)
        tc = np.asarray(t_curr, dtype=np.float64)
        L, J = tp.shape
        N = self._N
        rhs1 = self._rhs_rows(tc) if self.theta > 0.0 else None
        rhs0 = rhs1 if self.theta == 1.0 else self._rhs_rows(tp)
        if self._spectral:
            dt = torch.as_tensor(tc - tp, dtype=seed.dtype, device=seed.device)
            self.ops.theta_chain(seed.view(J, N), out.view(J, L, N), dt,
                                 self._Lam.view(N), self._lift_hat.view(N), rhs1, rhs0,
                                 self.theta, None if g is None else g.view(J, L, N))
            return out
        if rhs1 is None:
            rhs1 = rhs0                     # FE reads the rhs at the step's start only
        b = None if self.theta == 0.0 else torch.empty(
            (J,) + self._int_shape, dtype=seed.dtype, device=seed.device)
        x = seed
        for k in range(L):
            dt, shift = self._step_sizes(tc[k] - tp[k])
            gk = None if g is None else g[:, k]
            if b is None:
                self.ops.theta_rhs2d(x, out[:, k], dt, 0.0, self.fx, self.fy, rhs1[k],
                                     rhs0[k], ring=self._ring, g=gk)
            else:
                self.ops.theta_rhs2d(x, b, dt, self.theta, self.fx, self.fy, rhs1[k],
                                     rhs0[k], lift=self._lift)
                self.ops.sine_solve2d(b, out[:, k], self._Sx, self._Sy, self._Lam, shift,
                                      self._ring, gk)
            x = out[:, k]
        return out

    def step_batched(self, u_tube, t_starts, t_stops):
        """One step of each of B states: step_chain with L = 1."""
        out = torch.empty_like(u_tube)
        tp = np.asarray(t_starts, dtype=np.float64).reshape(1, -1)
        tc = np.asarray(t_stops, dtype=np.float64).reshape(1, -1)
        self.step_chain(u_tube, tp, tc, out[:, None])
        return out

    def _ring_lift(self, seed):
        """lift(ring of each seed) - lift(bc data), (J, nx-2, ny-2): what
        CN's explicit half reads from a carried ring that the closed-form
        tables (which assume ring == bc data) miss."""
        dl = torch.zeros((seed.shape[0],) + self._int_shape, dtype=seed.dtype,
                         device=seed.device)
        dl[:, :, 0] += self.fy * seed[:, 1:-1, 0]
        dl[:, :, -1] += self.fy * seed[:, 1:-1, -1]
        dl[:, 0, :] += self.fx * seed[:, 0, 1:-1]
        dl[:, -1, :] += self.fx * seed[:, -1, 1:-1]
        return dl - self._lift

    def relax_interval(self, seed, t_prev, t_curr, only_last=False,
                       interval_major=False, out=None, seed_out=None):
        """Closed-form F-values of J intervals: K1 (spectral), or K5
        forward transforms of the seeds (and of CN's ring correction) and
        K6 (physical).

        t_prev, t_curr: (rows, J) numpy step times.  Returns the
        (rows, J, ...) F-values, or (J, rows, ...) with interval_major;
        only_last keeps just row rows-1.  With ``out`` (a (J, R, ...) view,
        R = 1 with only_last, else rows) the values are written there and
        out is returned; ``seed_out`` optionally receives a copy of the
        seeds (the tube's C-rows).  Declines (None) for FE, non-uniform dt
        or a time-dependent rhs."""
        if self.theta == 0.0:
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
        J, N = seed.shape[0], self._N
        result = out
        if out is None:
            if interval_major:
                result = out = torch.empty((J, R) + self._shape, dtype=seed.dtype,
                                           device=seed.device)
            else:
                result = torch.empty((R, J) + self._shape, dtype=seed.dtype,
                                     device=seed.device)
                out = result.transpose(0, 1)
        if self._spectral:
            self.ops.interval_affine(seed.view(J, N), A_t, G_t, out.view(J, R, N), r0,
                                     None if seed_out is None else seed_out.view(J, N))
            return result
        xhat = torch.empty((J,) + self._int_shape, dtype=seed.dtype, device=seed.device)
        self.ops.sine_solve2d(seed[:, 1:-1, 1:-1], xhat, self._Sx, self._Sy)
        dhat = dscale = None
        if self.theta < 1.0:
            dl = self._ring_lift(seed)
            dhat = self.ops.sine_solve2d(dl, torch.empty_like(dl), self._Sx, self._Sy).view(J, N)
            dscale = self._ring_scale(dt)
        self.ops.sine_affine2d(xhat.view(J, N), A_t, G_t, out, self._Sx, self._Sy, r0,
                               self._ring, dhat, dscale,
                               None if seed_out is None else seed, seed_out)
        return result

    def to_physical(self, u_hat):
        """Spectral coefficients (..., nx-2, ny-2) -> full (..., nx, ny)
        fields with the Dirichlet boundary ring (K5's transform mode)."""
        lead = tuple(u_hat.shape[:-2])
        B = int(np.prod(lead, dtype=np.int64))
        dev, dtype = u_hat.device, u_hat.dtype
        out = torch.empty(lead + (self.nx, self.ny), dtype=dtype, device=dev)
        self.ops.sine_solve2d(u_hat.reshape((B,) + self._int_shape),
                              out.view((B, self.nx, self.ny)), self._Sx.to(dev, dtype),
                              self._Sy.to(dev, dtype), ring=self._ring.to(dev, dtype))
        return out
