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

Under a ('time', 'space') mesh with n_space > 1 (``parallel.ShardedMgrit``)
the solver hands each level its space shard (``_space_slab``) and the state
becomes the shard's slab of rows of axis 0 (``space_sharding_axis``, as the
JAX package declares it; JAX's GSPMD partitions the same axis):

* spectral: coefficient rows [s R, (s + 1) R) of the (nx-2, ny-2) array;
  every step is pointwise in the coefficients, so K1, K2 (and K8, K9
  through ``affine_coeffs``) run unchanged on the slab's tables;
* physical: field rows [s R, (s + 1) R) of the (nx, ny) state, the ring
  only where the slab meets the grid's edge.  A BE/CN step is K7 on the
  slab widened by one ghost row on each side (``Comm.row_halo``), then a
  pencil solve (``_Pencil``): a y-transform of the slab's interior rows
  (K20's transform mode, rows as lanes), ``all_to_all`` to column slabs,
  the x-transform, the division by 1 + theta dt Lam[i, j] and the inverse
  x-transform in one K20 solve with a (columns, nx-2) lam table, back to
  row slabs and the inverse y-transform, written with the ring and g (K4).
  ``relax_interval`` runs the same forward pencil on the seeds, K1 on the
  column slab of coefficients (CN's ring correction through a second K1 and
  K4) and the inverse pencil of the F-values.  FE has no space route
  (ROADMAP A7c).

``precision='dd'`` (the JAX package's double-double mode, ``ops/dd.py``):
the state and the tables are float32 pairs split exactly from float64, the
rhs table is float32 (looked up at each time's float32 value), and every
operation is the JAX package's DD operation in its order.  Spectral:
``step_chain`` runs K24 ``dd_theta_chain`` and ``relax_interval`` K23
``dd_interval_affine``, so the condensed level-0 carry works in DD.
Physical: every step is K25 ``dd_arith`` (stencil, right-hand side,
boundary lift, diagonal solve) around four K26 ``dd_matmul`` sine products
on all lanes at once; its ``relax_interval`` declines, as the JAX
package's does.  DD models define no ``affine_coeffs``.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.rhs_table import dd_time_keys, table_rows
from pymgrit_tpu_torch.models.step_times import StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops import dd
from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis

_RHS_CHUNK = 1024      # time samples per batched rhs evaluation on the host
# values of the whole F-values a space shard's closed form moves at a time
# (bounds its temporaries: a chunk of intervals at a time)
_RELAX_CHUNK = 1 << 23


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
        self._dd = precision == 'dd'
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
        # state axis 0 (x) may be split over the mesh's 'space' axis
        self.space_sharding_axis = 0
        self._pencil = None         # the physical space route (``_space_slab``)
        self._slab_rows = slice(None)   # rows of the interior-shaped tables this state holds
        self._space = None              # (s, n_space) once a space shard
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
        self._lift_np, self._ring_np, self._init_np = lift, ring, init
        self._lift_hat_np = self._Sx_np @ lift @ self._Sy_np
        self._Lam_np = lamx[:, None] + lamy[None, :]
        self._lift = self._tensor(lift)
        self._lift_hat = self._tensor(self._lift_hat_np)
        self._ring = self._tensor(ring)
        self._Lam = self._tensor(self._Lam_np)
        self._Sx = self._tensor(self._Sx_np)
        self._Sy = self._tensor(self._Sy_np)
        self._itbl_cache = {}       # (dt, m1) -> (A_k, G_k) numpy float64
        self._itbl_dev = {}         # (dt, m1) -> (A_k, G_k) (m1, N) device tensors (DD: pairs)
        self._dt_dev = {}           # step-size row -> (dt, theta*dt) device tensors
        self._dscale_dev = {}       # dt -> CN ring-correction scale (N,) on the device
        self._affine_dev = {}       # dt -> affine step (A, c) rows (N,) on the device
        self._times = StepTimes(self.device)    # step-size tables on the device (K2, DD)

        self._shape = self._int_shape if self._spectral else (nx, ny)
        start = self._Sx_np @ init[1:-1, 1:-1] @ self._Sy_np if self._spectral else init
        if self._dd:
            self._init_dd(lamx, lamy, ring, start)
        else:
            self.vector_t_start = self._tensor(start)
            self.vector_template = torch.zeros(self._shape, dtype=torch.float64, device=self.device)
        self._build_rhs_table()
        if self._spectral and not self._dd:
            # the spectral theta-step is the elementwise affine map
            # u -> A*u + c, so the coarsest-level strategies apply exactly
            self.affine_coeffs = self._affine_coeffs_spectral

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=self.device)

    def _split(self, a) -> dd.DD:
        """float64 values split exactly into a DD pair on the device."""
        return dd.from_f64(np.ascontiguousarray(a), self.device, self.ops)

    def _init_dd(self, lamx, lamy, ring, start):
        """DD state and tables (the JAX package splits the same arrays)."""
        self.vector_template = self._split(np.zeros(self._shape))
        self.vector_t_start = self._split(start)
        if self._spectral:
            self._lift_hat_dd = self._split(self._lift_hat_np.reshape(-1))
            self._Lam_dd = self._split(self._Lam_np.reshape(-1))
            return
        self._Sx_dd, self._Sy_dd = self._split(self._Sx_np), self._split(self._Sy_np)
        # lamx[:, None] + lamy[None, :], the DD add of every step's denominator
        self._lam2_dd = dd.add(self._split(lamx)[:, None], self._split(lamy)[None, :])
        self._ring_dd = self._split(ring)
        self._edges_dd = [self._split(a) for a in (self.bc_left_arr[1:-1], self.bc_right_arr[1:-1],
                                                    self.bc_top_arr[1:-1], self.bc_bottom_arr[1:-1])]

    # ------------------------------------------------------------------
    # tables
    # ------------------------------------------------------------------

    def prepare_runtime(self, level_info) -> None:
        """Pre-build the closed-form interval tables of level 0 (m-1 rows
        for the F-sweep, m rows for the condensed C-step) on the device."""
        if getattr(level_info, "lvl", 0) != 0:
            return
        if self.theta == 0.0 or (self._dd and not self._spectral):
            return                      # FE and DD-physical: the hook declines
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
        transformed).  In DD the rhs is evaluated at the float32 times and
        the table holds float32 samples (the JAX package's DD table)."""
        ts = np.asarray(self.t, dtype=np.float64)
        if self._dd:
            ts = ts.astype(np.float32)
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
            self._rhs_tbl_raw0 = s0
            self._rhs_tbl0_hat_np = self._Sx_np @ s0 @ self._Sy_np
        rows = self._rhs_tbl.reshape(self._rhs_tbl.shape[0], -1)
        if self._dd:
            self._rhs_tbl = self._rhs_tbl.astype(np.float32)
            self._rhs_tbl0_hat_np = self._rhs_tbl[0].astype(np.float64) if self._spectral \
                else self._Sx_np @ s0.astype(np.float32) @ self._Sy_np
            self._rhs_tbl_t = torch.as_tensor(rows.astype(np.float32), device=self.device)
        else:
            self._rhs_tbl_t = self._tensor(rows)
        self._rhs_times_t = torch.as_tensor(np.ascontiguousarray(self._rhs_tbl_times),
                                            dtype=torch.float64)

    def _rhs_rows(self, ts) -> torch.Tensor:
        """Table rows (rhs, or rhs^ in the spectral basis) at the times ts
        (numpy, any shape S; in DD also DD times) as an S + (N,) view
        (``table_rows``).  In DD the rows are looked up at each time's
        float32 value."""
        if self._dd:
            ts = dd_time_keys(ts)
        return table_rows(self._rhs_tbl_t, self._rhs_times_t, ts, self._rhs_sample)

    def _rhs_sample(self, t) -> torch.Tensor:
        """The rhs callable at an off-grid time t (transformed in the
        spectral basis), as an (N,) row."""
        if self._dd:
            t = np.float32(t)
        r = np.asarray(self.rhs(x=self._xi, y=self._yi, t=t), dtype=np.float64) \
            * np.ones((self.nx - 2, self.ny - 2))
        if self._spectral:
            r = self._Sx_np @ r @ self._Sy_np
        r = r[self._slab_rows]
        if self._dd:
            return torch.as_tensor(r.reshape(-1).astype(np.float32), device=self.device)
        return self._tensor(r.reshape(-1))

    def _rhs_at(self, t) -> torch.Tensor:
        """The table row at time t as an interior-shaped tensor."""
        return self._rhs_rows(np.asarray(float(t))).reshape(self._int_shape)

    # ------------------------------------------------------------------
    # the 'space' mesh axis
    # ------------------------------------------------------------------

    def _space_slab(self, s: int, n_space: int, comm) -> None:
        """Make this level the space shard s of n_space (``parallel``'s
        ``ShardedMgrit`` calls it, with the space group's ``Comm``): the
        state becomes rows [s R, (s + 1) R) of axis 0 and every table the
        rows (spectral) or the row and column slabs (physical, ``_Pencil``)
        that shard reads.  A level made a shard stays one: a later solver
        may take it on the same shard of the same count."""
        if self._space is not None:
            if self._space != (s, n_space):
                raise ValueError(f"this level is space shard {self._space[0]} of "
                                 f"{self._space[1]}; build it anew for shard {s} of {n_space}")
            if self._pencil is not None:
                self._pencil.comm = comm
            return
        if self._dd:
            raise NotImplementedError("precision='dd' has no space route (ROADMAP A7c)")
        if self.theta == 0.0:
            raise NotImplementedError("Heat2D FE has no space route (ROADMAP A7c)")
        n = self._shape[0]
        if n % n_space:
            raise ValueError(f"the state's shape {self._shape} does not split over "
                             f"n_space = {n_space} along axis {self.space_sharding_axis}")
        R = n // n_space
        rows = slice(s * R, (s + 1) * R)
        for cache in (self._itbl_cache, self._itbl_dev, self._dt_dev, self._dscale_dev,
                      self._affine_dev):
            cache.clear()
        if self._spectral:
            self._slab_rows = rows
            self._Lam_np, self._lift_hat_np = self._Lam_np[rows], self._lift_hat_np[rows]
            self._rhs_tbl0_hat_np = self._rhs_tbl0_hat_np[rows]
            self._Lam, self._lift_hat = self._tensor(self._Lam_np), self._tensor(self._lift_hat_np)
            start = self.vector_t_start[rows].clone()
        else:
            if R < 2:
                raise ValueError(f"{self.nx} rows over n_space = {n_space}: a space shard of the "
                                 "physical state needs two rows")
            pen = self._pencil = _Pencil(self, s, n_space, comm)
            self._slab_rows = slice(pen.gi0 - 1, pen.gi1 - 1)
            cols = slice(pen.c0[s], pen.c0[s + 1])
            # the closed form's tables in the column slab's layout [column][x]
            rhs0_hat = self._Sx_np @ self._rhs_tbl_raw0 @ self._Sy_np
            self._Lam_np = np.ascontiguousarray(self._Lam_np[:, cols].T)
            self._lift_hat_np = np.ascontiguousarray(self._lift_hat_np[:, cols].T)
            self._rhs_tbl0_hat_np = np.ascontiguousarray(rhs0_hat[:, cols].T)
            self._lift = self._tensor(self._lift_np[self._slab_rows])
            self._ring = self._tensor(self._ring_np[rows])
            start = self._tensor(self._init_np[rows])
        self._rhs_tbl = self._rhs_tbl[:, self._slab_rows]
        self._rhs_tbl_t = self._tensor(self._rhs_tbl.reshape(self._rhs_tbl.shape[0], -1))
        self._int_shape = self._rhs_tbl.shape[1:]
        self._N = int(np.prod(self._int_shape))
        self._shape = (R,) + tuple(self._shape[1:])
        self._space = (s, n_space)
        self.vector_t_start = start
        self.vector_template = torch.zeros(self._shape, dtype=torch.float64, device=self.device)

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
        """_interval_tables as contiguous (m1, N) device tensors (DD pairs,
        split from float64, in DD)."""
        key = (float(dt), int(m1))
        if key not in self._itbl_dev:
            make = self._split if self._dd else self._tensor
            A_k, G_k = self._interval_tables(dt, m1)
            self._itbl_dev[key] = (make(A_k.reshape(m1, -1)), make(G_k.reshape(m1, -1)))
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
        if self._dd:
            return self.step_batched(u_start[None], t_start.reshape(1), t_stop.reshape(1))[0]
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
        if self._dd:
            return self._dd_chain(seed, self._times.dd_steps(tp, tc, self.ops), self._rhs_rows(tc),
                                  self._rhs_rows(tp), out, g)
        rhs1 = self._rhs_rows(tc) if self.theta > 0.0 else None
        rhs0 = rhs1 if self.theta == 1.0 else self._rhs_rows(tp)
        if self._spectral:
            self.ops.theta_chain(seed.view(J, N), out.view(J, L, N),
                                 self._times.steps(tp, tc, seed.dtype),
                                 self._Lam.view(N), self._lift_hat.view(N), rhs1, rhs0,
                                 self.theta, None if g is None else g.view(J, L, N))
            return out
        if rhs1 is None:
            rhs1 = rhs0                     # FE reads the rhs at the step's start only
        if self._pencil is not None:
            return self._pencil.chain(seed, tp, tc, rhs1, rhs0, out, g)
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
        """One step of each of B states: step_chain with L = 1 (in DD: B DD
        states and DD times in, B DD states out)."""
        if self._dd:
            dt = dd.sub(t_stops, t_starts).reshape(1, -1)
            out = torch.empty((u_tube.shape[0], 1, 2) + self._shape, dtype=torch.float32,
                              device=self.device)
            self._dd_chain(dd.packed(u_tube), dt, self._rhs_rows(t_stops)[None],
                           self._rhs_rows(t_starts)[None], out)
            return dd.pair(out[:, 0], self.ops)
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
        or a time-dependent rhs; in DD also for the physical basis.  In DD,
        seed, out and seed_out are packed (…, 2, ...) float32 views and K23
        runs."""
        if self.theta == 0.0 or (self._dd and not self._spectral):
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
            pair_axis = (2,) if self._dd else ()
            if interval_major:
                result = out = torch.empty((J, R) + pair_axis + self._shape, dtype=seed.dtype,
                                           device=seed.device)
            else:
                result = torch.empty((R, J) + pair_axis + self._shape, dtype=seed.dtype,
                                     device=seed.device)
                out = result.transpose(0, 1)
        if self._dd:
            self.ops.dd_interval_affine(self._pair_of(seed.view(J, 2, N)), A_t, G_t,
                                        self._pair_of(out.view(J, R, 2, N), 2), r0,
                                        None if seed_out is None else
                                        self._pair_of(seed_out.view(J, 2, N)))
            return result
        if self._spectral:
            self.ops.interval_affine(seed.view(J, N), A_t, G_t, out.view(J, R, N), r0,
                                     None if seed_out is None else seed_out.view(J, N))
            return result
        if self._pencil is not None:
            return self._pencil.relax(seed, A_t, G_t, dt, r0, out, result, seed_out)
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
        fields with the Dirichlet boundary ring (K5's transform mode); a DD
        state counts with its float32 value hi + lo, transformed in
        float64 (as the JAX package's einsum promotes it)."""
        if self._space is not None:
            raise NotImplementedError("to_physical transforms whole states, not a space slab")
        if isinstance(u_hat, dd.DD):
            u_hat = u_hat.to_float().double()
        lead = tuple(u_hat.shape[:-2])
        B = int(np.prod(lead, dtype=np.int64))
        dev, dtype = u_hat.device, u_hat.dtype
        out = torch.empty(lead + (self.nx, self.ny), dtype=dtype, device=dev)
        self.ops.sine_solve2d(u_hat.reshape((B,) + self._int_shape),
                              out.view((B, self.nx, self.ny)), self._Sx.to(dev, dtype),
                              self._Sy.to(dev, dtype), ring=self._ring.to(dev, dtype))
        return out

    # ------------------------------------------------------------------
    # precision='dd': chains of steps on packed (…, 2, ...) float32 views
    # ------------------------------------------------------------------

    def _pair_of(self, t, axis=1):
        return dd.pair(t, self.ops, axis)

    def _dd_chain(self, seed, dt, rhs1, rhs0, out, g=None):
        """J chains of L DD steps into out (the layout of ``step_chain``):
        K24 in the spectral basis; a K25/K26 step on all lanes per step in
        the physical one.  dt: (L, J) DD step sizes; rhs1, rhs0: (L, J, N)
        float32 table rows at the steps' ends and starts."""
        J, L, N = out.shape[0], out.shape[1], self._N
        pair = self._pair_of
        if self._spectral:
            self.ops.dd_theta_chain(pair(seed.view(J, 2, N)), pair(out.view(J, L, 2, N), 2), dt,
                                    self._Lam_dd, self._lift_hat_dd, rhs1, rhs0, self.theta,
                                    None if g is None else pair(g.view(J, L, 2, N), 2))
            return out
        x = seed
        for k in range(L):
            y = pair(out[:, k])
            self._dd_physical_step(pair(x), dt[k], rhs1[k], rhs0[k], y)
            if g is not None:
                self.ops.dd_arith("add", pair(g[:, k]), y, out=y)
            x = out[:, k]
        return out

    def _dd_apply_L(self, u):
        """The interior of the zeroed-ring 5-point operator of B DD states,
        in the JAX package's order: 2(fx+fy) u_c - fy u_w - fy u_e - fx u_n
        - fx u_s (one K25 combine)."""
        fx, fy = self.fx, self.fy
        return self.ops.dd_arith("combine", u[:, 1:-1, 1:-1], u[:, 1:-1, :-2], u[:, 1:-1, 2:],
                                 u[:, :-2, 1:-1], u[:, 2:, 1:-1],
                                 coeffs=[2 * (fx + fy), -fy, -fy, -fx, -fx])

    def _dd_physical_step(self, u, dt, rhs1, rhs0, out):
        """The JAX package's physical DD step (``Heat2D.step``, BE/CN/FE) of
        B lanes, operation for operation, into the DD view out (B, nx, ny).
        u: (B, nx, ny) DD; dt: (B,) DD; rhs1, rhs0: (B, N) float32 rows at
        the step's end and start."""
        ops, th = self.ops, self.theta
        B = u.shape[0]
        d = dt.reshape(B, 1, 1)
        r1, r0 = (r.reshape((B,) + self._int_shape) for r in (rhs1, rhs0))
        ring = self._ring_dd.expand(B, self.nx, self.ny)
        if th == 0.0:
            # FE: new = (bc ring + u) - dt L(u), then + dt rhs(t_start) inside
            Lu = dd.zeros_like(ring)
            inner = self._dd_apply_L(u)
            Lu.hi[:, 1:-1, 1:-1] = inner.hi
            Lu.lo[:, 1:-1, 1:-1] = inner.lo
            ops.dd_arith("sub", ring + u, d * Lu, out=out)
            inner = out[:, 1:-1, 1:-1]
            ops.dd_arith("add", inner, d * r0, out=inner)
            return out
        if th == 1.0:
            b = u[:, 1:-1, 1:-1] + d * r1
        else:
            b = u[:, 1:-1, 1:-1] - (d * th) * self._dd_apply_L(u)
            b = b + ((d * th) * r1 + (d * (1 - th)) * r0)
        # boundary lift b[:, :, 0] += shift fy bc_left, ... edge by edge (the
        # ring of the JAX package's b is the Dirichlet data)
        shift = d * th
        sy, sx = shift.reshape(B, 1) * self.fy, shift.reshape(B, 1) * self.fx
        left, right, top, bottom = self._edges_dd
        for view, s, edge in ((b[:, :, 0], sy, left), (b[:, :, -1], sy, right),
                              (b[:, 0, :], sx, top), (b[:, -1, :], sx, bottom)):
            ops.dd_arith("add", view, s * edge, out=view)
        n1, n2 = self._int_shape
        Sx, Sy = self._Sx_dd.expand(B, n1, n1), self._Sy_dd.expand(B, n2, n2)
        bh = ops.dd_matmul(ops.dd_matmul(Sx, b), Sy)
        x = bh / (shift * self._lam2_dd + 1.0)
        out.hi.copy_(ring.hi)
        out.lo.copy_(ring.lo)
        ops.dd_matmul(ops.dd_matmul(Sx, x), Sy, out=out[:, 1:-1, 1:-1])
        return out



class _Pencil:
    """A physical Heat2D level's space shard s of n (``Heat2D._space_slab``):
    field rows [r0, r1) = [s R, (s + 1) R) of the (nx, ny) state, of which
    the interior rows [gi0, gi1) (all but a ring row at the grid's edge),
    and, between the pencil transforms' passes, the column slab [c0[s],
    c0[s + 1]) of the ny - 2 interior columns.  The x-pass's lam table
    holds Lam[:, j] for the slab's columns j (a row each)."""

    def __init__(self, model: Heat2D, s: int, n: int, comm):
        self.model, self.s, self.comm = model, s, comm
        nx, ny = model.nx, model.ny
        R = self.R = nx // n
        self.r0, self.r1 = s * R, (s + 1) * R
        gi0 = [max(t * R, 1) for t in range(n)]
        gi1 = [min((t + 1) * R, nx - 1) for t in range(n)]
        # every shard's interior rows: their count and first x index
        self.rows = [b - a for a, b in zip(gi0, gi1)]
        self.roff = [a - 1 for a in gi0]
        self.gi0, self.gi1 = gi0[s], gi1[s]
        self.li0, self.li1 = self.gi0 - self.r0, self.gi1 - self.r0
        nc = ny - 2
        self.c0 = [nc * t // n for t in range(n + 1)]
        self.cols = [self.c0[t + 1] - self.c0[t] for t in range(n)]
        # the stencil's rows: the slab and a ghost row where a neighbour holds it
        self.w0, self.w1 = max(self.r0 - 1, 0), min(self.r1 + 1, nx)
        self.top, self.bottom = self.r0 == 0, self.r1 == nx
        self.lam = model._tensor(model._Lam_np[:, self.c0[s]:self.c0[s + 1]].T)
        self._shifts = {}           # theta dt by lane, per step size
        self._corr = {}             # (dt, m1) -> CN's correction tables

    # -- moving between row and column slabs ----------------------------

    def to_cols(self, y, J):
        """(J * rows, ny - 2) interior rows of J states -> (J * columns,
        nx - 2): each state's columns of this shard's slab, whole in x."""
        s, nt = self.s, len(self.cols)
        rm, cm = self.rows[s], self.cols[s]
        y3 = y.view(J, rm, -1)
        send = torch.empty(y.numel(), dtype=y.dtype, device=y.device)
        sizes, off = [], 0
        for t in range(nt):
            k = J * self.cols[t] * rm
            send[off:off + k].view(J, self.cols[t], rm).copy_(
                y3[:, :, self.c0[t]:self.c0[t + 1]].transpose(1, 2))
            sizes.append(k)
            off += k
        recv = self.comm.all_to_all(send, sizes, [J * cm * self.rows[t] for t in range(nt)])
        del send
        X = torch.empty((J, cm, self.model.nx - 2), dtype=y.dtype, device=y.device)
        off = 0
        for t in range(nt):
            k = J * cm * self.rows[t]
            X[:, :, self.roff[t]:self.roff[t] + self.rows[t]] = recv[off:off + k].view(
                J, cm, self.rows[t])
            off += k
        return X.view(J * cm, -1)

    def to_rows(self, X, J):
        """The inverse of ``to_cols``: (J * columns, nx - 2) -> (J * rows,
        ny - 2)."""
        s, nt = self.s, len(self.cols)
        rm, cm = self.rows[s], self.cols[s]
        X3 = X.view(J, cm, -1)
        send = torch.empty(J * cm * sum(self.rows), dtype=X.dtype, device=X.device)
        sizes, off = [], 0
        for t in range(nt):
            k = J * cm * self.rows[t]
            send[off:off + k].view(J, cm, self.rows[t]).copy_(
                X3[:, :, self.roff[t]:self.roff[t] + self.rows[t]])
            sizes.append(k)
            off += k
        recv = self.comm.all_to_all(send, sizes, [J * self.cols[t] * rm for t in range(nt)])
        del send
        Y = torch.empty((J, rm, self.model.ny - 2), dtype=X.dtype, device=X.device)
        off = 0
        for t in range(nt):
            k = J * self.cols[t] * rm
            Y[:, :, self.c0[t]:self.c0[t + 1]] = recv[off:off + k].view(
                J, self.cols[t], rm).transpose(1, 2)
            off += k
        return Y.view(J * rm, -1)

    def forward(self, b, J):
        """Sx b Sy of J states' interior rows b (J * rows, ny - 2), as the
        column slab (J * columns, nx - 2) of coefficients (K20 twice)."""
        m = self.model
        yh = torch.empty_like(b)
        m.ops.sine_solve1d(b, yh, m._Sy)
        X = self.to_cols(yh, J)
        xh = torch.empty_like(X)
        m.ops.sine_solve1d(X, xh, m._Sx)
        return xh

    # -- the state's ring and ghost rows ----------------------------------

    def widen(self, x, uw):
        """uw <- the slab x with the neighbours' edge rows around it (the
        rows K7's stencil reads)."""
        o = self.r0 - self.w0
        uw[:, o:o + self.R].copy_(x)
        above, below = self.comm.row_halo(x[:, 0], x[:, self.R - 1])
        if not self.top:
            uw[:, 0].copy_(above)
        if not self.bottom:
            uw[:, -1].copy_(below)

    def ring(self, dst):
        """The Dirichlet ring's cells of the slab views dst (..., R, ny)."""
        ring = self.model._ring
        dst[..., 0].copy_(ring[:, 0].expand(dst[..., 0].shape))
        dst[..., -1].copy_(ring[:, -1].expand(dst[..., -1].shape))
        if self.top:
            dst[..., 0, 1:-1].copy_(ring[0, 1:-1].expand(dst[..., 0, 1:-1].shape))
        if self.bottom:
            dst[..., -1, 1:-1].copy_(ring[-1, 1:-1].expand(dst[..., -1, 1:-1].shape))

    def ring_lift(self, seed):
        """``Heat2D._ring_lift`` of the slab's interior rows: lift(ring of
        each seed) - lift(bc data), (J, rows, ny - 2)."""
        m = self.model
        si = seed[:, self.li0:self.li1]
        dl = torch.zeros((seed.shape[0],) + tuple(m._lift.shape), dtype=seed.dtype,
                         device=seed.device)
        dl[:, :, 0] += m.fy * si[:, :, 0]
        dl[:, :, -1] += m.fy * si[:, :, -1]
        if self.top:
            dl[:, 0, :] += m.fx * seed[:, 0, 1:-1]
        if self.bottom:
            dl[:, -1, :] += m.fx * seed[:, -1, 1:-1]
        return dl - m._lift

    # -- the step and the closed form ---------------------------------------

    def lane_shifts(self, shift, J):
        """theta dt of each of the x-pass's J * columns lanes (K20's dt)."""
        cm = self.cols[self.s]
        key = (shift.data_ptr(), J) if isinstance(shift, torch.Tensor) else (float(shift), J)
        if key not in self._shifts:
            m = self.model
            self._shifts[key] = (shift.repeat_interleave(cm) if isinstance(shift, torch.Tensor)
                                 else torch.full((J * cm,), float(shift), dtype=torch.float64,
                                                 device=m.device))
        return self._shifts[key]

    def chain(self, seed, tp, tc, rhs1, rhs0, out, g):
        """``Heat2D.step_chain`` on the slab: per step K7 on the widened
        slab, the pencil solve (K20: y-transform, x-pass with the lam table,
        inverse y-transform) and the ring, then g (K4)."""
        m = self.model
        ops = m.ops
        L, J = tp.shape
        rm, nc = self.rows[self.s], m.ny - 2
        dtype, dev = seed.dtype, seed.device
        uw = torch.empty((J, self.w1 - self.w0, m.ny), dtype=dtype, device=dev)
        b = torch.empty((J * rm, nc), dtype=dtype, device=dev)
        yh = torch.empty_like(b)
        x = seed
        for k in range(L):
            dt, shift = m._step_sizes(tc[k] - tp[k])
            self.widen(x, uw)
            ops.theta_rhs2d(uw, b.view(J, rm, nc), dt, m.theta, m.fx, m.fy, rhs1[k], rhs0[k],
                            lift=m._lift)
            ops.sine_solve1d(b, yh, m._Sy)
            X = self.to_cols(yh, J)
            ops.sine_solve1d(X, X, m._Sx, self.lam, self.lane_shifts(shift, J))
            dst = out[:, k]
            ops.sine_solve1d(self.to_rows(X, J), dst[:, self.li0:self.li1, 1:-1], m._Sy)
            self.ring(dst)
            if g is not None:
                ops.cpoint_combine(dst.view(J, -1), [g[:, k].view(J, -1), dst.view(J, -1)],
                                   [1.0, 1.0])
            x = dst
        return out

    def correction_tables(self, dt, m1):
        """CN's ring correction as K1 tables: (dscale A^(k-1), zeros), (m1,
        columns * (nx - 2)), dscale = theta dt / (1 + theta dt Lam)."""
        key = (float(dt), int(m1))
        if key not in self._corr:
            m = self.model
            A_k, _ = m._interval_tables(dt, m1)
            shift = m.theta * dt
            dscale = shift / (1.0 + shift * m._Lam_np)
            A_km1 = np.concatenate([np.ones((1,) + A_k.shape[1:]), A_k[:-1]])
            B = (dscale[None] * A_km1).reshape(m1, -1)
            self._corr[key] = (m._tensor(B), torch.zeros(B.shape, dtype=torch.float64,
                                                          device=m.device))
        return self._corr[key]

    def relax(self, seed, A_t, G_t, dt, r0, out, result, seed_out):
        """``Heat2D.relax_interval`` on the slab, a chunk of intervals at a
        time (``_RELAX_CHUNK`` values of the whole F-values at most; the
        same chunks on every shard): the seeds' forward pencil, K1 on the
        column slab of coefficients (CN: the ring correction by a second K1
        and K4), the F-values' inverse x-transform, one all_to_all and the
        inverse y-transform, with the ring."""
        m = self.model
        J, Rr = seed.shape[0], out.shape[1]
        per = max(1, Rr * (m.nx - 2) * (m.ny - 2))
        step = max(1, _RELAX_CHUNK // per)
        for j0 in range(0, J, step):
            j1 = min(J, j0 + step)
            self._relax_chunk(seed[j0:j1], A_t, G_t, dt, r0, out[j0:j1])
        self.ring(out)
        if seed_out is not None:
            seed_out.copy_(seed)
        return result

    def _relax_chunk(self, seed, A_t, G_t, dt, r0, out):
        m = self.model
        ops = m.ops
        J, Rr = seed.shape[0], out.shape[1]
        rm, nc, nx2 = self.rows[self.s], m.ny - 2, m.nx - 2
        b = seed[:, self.li0:self.li1, 1:-1].contiguous().view(J * rm, nc)
        xhat = self.forward(b, J)
        Nc = xhat.numel() // J
        yhat = torch.empty((J, Rr, Nc), dtype=seed.dtype, device=seed.device)
        ops.interval_affine(xhat.view(J, Nc), A_t, G_t, yhat, r0)
        if m.theta < 1.0:
            dhat = self.forward(self.ring_lift(seed).view(J * rm, nc), J)
            B_t, Z_t = self.correction_tables(dt, A_t.shape[0])
            corr = torch.empty_like(yhat)
            ops.interval_affine(dhat.view(J, Nc), B_t, Z_t, corr, r0)
            ops.cpoint_combine(yhat.view(J * Rr, Nc), [yhat.view(J * Rr, Nc),
                                                        corr.view(J * Rr, Nc)], [1.0, 1.0])
            del corr
        vals = torch.empty((J * Rr * self.cols[self.s], nx2), dtype=seed.dtype, device=seed.device)
        ops.sine_solve1d(yhat.view(-1, nx2), vals, m._Sx)
        del yhat
        Y = self.to_rows(vals, J * Rr)
        del vals
        inner = torch.empty((J * Rr, rm, nc), dtype=seed.dtype, device=seed.device)
        ops.sine_solve1d(Y, inner, m._Sy)
        out[:, :, self.li0:self.li1, 1:-1].copy_(inner.view(J, Rr, rm, nc))
