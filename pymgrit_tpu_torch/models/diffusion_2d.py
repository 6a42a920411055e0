"""2D diffusion with a P1 discontinuous-Galerkin interior-penalty method.

Counterpart of ``pymgrit_tpu/models/diffusion_2d.py`` (the reference's
Firedrake coupling model: P1-DG SIPG diffusion on a periodic square,
backward Euler).  The SIPG operator is assembled once on the host (numpy,
float64; ``_assemble_p1dg_sipg`` is a copy of the JAX package's) and
generalized-eigendecomposed against the DG mass matrix, A V = M V diag(lam)
with V^T M V = I, so the backward-Euler step

    (M + dt A) u = M u_prev   =>   u = V ((W u_prev) / (1 + dt lam)),  W = V^T M,

is two dense (N x N) products around a diagonal scale (N = 6 n^2).  The
tables equal the JAX model's (the same numpy assembly and
``scipy.linalg.eigh``).  ``step_batched`` and ``step_chain`` run the step on
B lanes in row form, ((u W^T) / (1 + dt_b lam)) V^T, through kernel K22
``eig_step`` (the FP64 tensor cores).
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.step_times import ChainSteps, StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops import dd


def _assemble_p1dg_sipg(n: int, length: float, kappa, mu: float):
    """P1-DG SIPG mass/stiffness on an n x n periodic square of size
    ``length``, each cell split into two triangles.  Returns (M, K, xy)
    with xy the (n_dof, 2) node coordinates (DG: per-triangle copies)."""
    h = length / n
    n_tri = 2 * n * n
    n_dof = 3 * n_tri

    # triangle -> 3 vertex coordinates (periodic wrap only affects
    # *connectivity*, not coordinates: each DG dof keeps its own coords)
    verts = np.zeros((n_tri, 3, 2))
    for j in range(n):
        for i in range(n):
            c = 2 * (j * n + i)
            x0, y0 = i * h, j * h
            # lower triangle: (i,j), (i+1,j), (i+1,j+1)
            verts[c] = [(x0, y0), (x0 + h, y0), (x0 + h, y0 + h)]
            # upper triangle: (i,j), (i+1,j+1), (i,j+1)
            verts[c + 1] = [(x0, y0), (x0 + h, y0 + h), (x0, y0 + h)]

    area = 0.5 * h * h
    # P1 gradients: for triangle with vertices p0,p1,p2,
    # grad phi_k = perp(edge opposite k) / (2*area)
    grads = np.zeros((n_tri, 3, 2))
    for t in range(n_tri):
        p = verts[t]
        for k in range(3):
            e = p[(k + 2) % 3] - p[(k + 1) % 3]
            grads[t, k] = np.array([-e[1], e[0]]) / (2 * area)

    if callable(kappa):
        cent = verts.mean(axis=1)
        kap = np.asarray(kappa(cent[:, 0], cent[:, 1]), dtype=np.float64) \
            * np.ones(n_tri)
    else:
        kap = np.full(n_tri, float(kappa))

    M = np.zeros((n_dof, n_dof))
    K = np.zeros((n_dof, n_dof))
    m_loc = area / 12.0 * np.array([[2.0, 1, 1], [1, 2, 1], [1, 1, 2]])
    for t in range(n_tri):
        d = 3 * t + np.arange(3)
        M[np.ix_(d, d)] += m_loc
        K[np.ix_(d, d)] += kap[t] * area * (grads[t] @ grads[t].T)

    # interior facets: per cell, its bottom, left, and diagonal edge.
    # Local vertex numbering: lower tri L = [v00, v10, v11],
    # upper tri U = [v00, v11, v01].
    def tri_id(i, j, upper):
        return 2 * ((j % n) * n + (i % n)) + int(upper)

    edges = []   # (tri+, locals+ (2 nodes on edge), tri-, locals-, normal, |e|)
    for j in range(n):
        for i in range(n):
            # bottom edge, endpoints ordered ((i,j),(i+1,j)): L(i,j) locals
            # (0,1); U(i,j-1) has these endpoints at locals (2,1) (v01,v11)
            edges.append((tri_id(i, j, 0), (0, 1), tri_id(i, j - 1, 1), (2, 1),
                          np.array([0.0, -1.0]), h))
            # left edge (v00-v01): U(i,j) [0,2] <-> L(i-1,j) right (v10-v11)=[1,2]
            edges.append((tri_id(i, j, 1), (0, 2), tri_id(i - 1, j, 0), (1, 2),
                          np.array([-1.0, 0.0]), h))
            # diagonal (v00-v11): L(i,j) [0,2] <-> U(i,j) [0,1]
            edges.append((tri_id(i, j, 0), (0, 2), tri_id(i, j, 1), (0, 1),
                          np.array([-1.0, 1.0]) / np.sqrt(2.0), h * np.sqrt(2.0)))

    # edge-trace integrals of P1 basis: for the two on-edge nodes (a, b) of
    # each side, int phi_a phi_b = |e| * (1/3 same endpoint, 1/6 crossed);
    # matching endpoints: (+ side node a) and (- side node a') coincide when
    # they are the same geometric endpoint.  By construction above, local
    # pair orderings traverse the edge in the same direction for + and -.
    for tp, lp, tm, lm, nrm, elen in edges:
        dp = 3 * tp + np.arange(3)
        dm = 3 * tm + np.arange(3)
        kp, km = kap[tp], kap[tm]
        # trace vectors: value of each local basis at the 2 edge endpoints
        trp = np.zeros((3, 2))
        trp[lp[0], 0] = 1.0
        trp[lp[1], 1] = 1.0
        trm = np.zeros((3, 2))
        trm[lm[0], 0] = 1.0
        trm[lm[1], 1] = 1.0
        # int_e (trace_i)(trace_j) = elen * tr_i @ Q @ tr_j with
        # Q = [[1/3, 1/6], [1/6, 1/3]]
        Q = elen * np.array([[1.0 / 3, 1.0 / 6], [1.0 / 6, 1.0 / 3]])
        # int_e (trace_i) = elen * tr_i @ q, q = [1/2, 1/2]
        q = elen * np.array([0.5, 0.5])

        # normal fluxes (constant per side): kappa grad(phi) . n
        fp = kp * (grads[tp] @ nrm)          # (3,)
        fm = km * (grads[tm] @ nrm)

        # jump/average in scalar convention with n = normal from + to -:
        # [u] = u+ - u-, {w} = (w+ + w-)/2
        jump = [(dp, trp, 1.0), (dm, trm, -1.0)]
        flux = [(dp, fp, 0.5), (dm, fm, 0.5)]

        # consistency: -int {kappa grad u . n} [v]  and symmetric partner
        for (dv, trv, sv) in jump:
            for (du, fu, su) in flux:
                blk = -su * np.outer(trv @ q, fu) * sv
                K[np.ix_(dv, du)] += blk
                K[np.ix_(du, dv)] += blk.T
        # penalty mu*kappa*[u][v].  For the reference's constant kappa this
        # equals its form 2avg(outer(phi,n)) : 2avg(outer(gamma,n)*kappa)
        # exactly; for the inhomogeneous extension we take the symmetric
        # average-kappa weight (standard SWIP) so the operator stays
        # symmetric for the generalized eigendecomposition.
        w = mu * 0.5 * (kp + km)
        for (dv, trv, sv) in jump:
            for (du, tru, su) in jump:
                K[np.ix_(dv, du)] += w * sv * su * (trv @ Q @ tru.T)

    xy = verts.reshape(n_dof, 2)
    return M, K, xy


class Diffusion2D(ChainSteps, Application):
    """u_t = div(kappa grad u) on a periodic square, P1-DG SIPG in space,
    backward Euler in time.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    state and tables; ``ops`` selects the kernel set
    (``pymgrit_tpu_torch.ops.DISPATCH`` by default; ``ops.PLAIN`` runs the
    plain version on any device).  ``lam``, ``V``, ``W``, ``mass`` and
    ``xy`` are the float64 numpy tables, as in the JAX package."""

    def __init__(self, n: int = 20, length: float = 10.0,
                 kappa: Union[float, Callable] = 0.1, mu: float = 5.0,
                 init_cond: Callable = None, precision: str = None,
                 *args, device=None, ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self._dd = precision == 'dd'
        self.n = n
        self.length = length
        self.kappa = kappa
        self.mu = mu
        self.device = model_device(device)
        self.ops = ops

        M, K, xy = _assemble_p1dg_sipg(n, length, kappa, mu)
        import scipy.linalg
        lam, V = scipy.linalg.eigh(K, M)     # A V = M V lam, V^T M V = I
        W = V.T @ M
        self.lam = lam
        self.V = V
        self.W = W
        self.xy = xy
        self.mass = M

        if init_cond is None:
            c = length / 2.0
            init_cond = lambda x, y: np.exp(-((x - c) ** 2 + (y - c) ** 2))
        u0 = np.asarray(init_cond(xy[:, 0], xy[:, 1]), dtype=np.float64)

        self._mass_ones = self._tensor(M @ np.ones(M.shape[0]))
        self._times = StepTimes(self.device)
        if self._dd:
            # V, W and lam split exactly into float32 pairs (the JAX package's DD
            # tables); the step's products run on K26, its scale on K25
            self._V_dd, self._W_dd, self._lam_dd = (
                dd.from_f64(np.ascontiguousarray(a), self.device, ops) for a in (V, W, lam))
            self.vector_template = dd.from_f64(np.zeros(3 * 2 * n * n), self.device, ops)
            self.vector_t_start = dd.from_f64(u0, self.device, ops)
            return
        self._V_t, self._W_t, self._lam_t = (self._tensor(a) for a in (V, W, lam))
        self.vector_template = torch.zeros(3 * 2 * n * n, dtype=torch.float64, device=self.device)
        self.vector_t_start = self._tensor(u0)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=self.device)

    def _chain_tables(self, tp, tc, dtype):
        """The step sizes tc - tp on the device (a DD subtraction of the
        split times in DD)."""
        if self._dd:
            return self._times.dd_steps(tp, tc, self.ops)
        return super()._chain_tables(tp, tc, dtype)

    def _lane_step(self, x, k, dts, out, g):
        """Step k of ``ChainSteps.step_chain`` for the (J, N) states x: one
        K22 launch pair with the chain's step sizes dts[k], then [+ g].  In
        DD (packed (J, 2, N) views): the JAX package's V ((W u) / (1 + dt
        lam)), the products on K26 and the rest on K25."""
        if self._dd:
            ops = self.ops
            u, y = dd.pair(x, ops), dd.pair(out, ops)
            uh = ops.dd_matmul(u[None], self._W_dd.T[None])[0]
            v = uh / (dts[k][:, None] * self._lam_dd + 1.0)
            ops.dd_matmul(v[None], self._V_dd.T[None], out=y[None])
            if g is not None:
                ops.dd_arith("add", dd.pair(g, ops), y, out=y)
            return
        self.ops.eig_step(x, out, self._W_t, self._V_t, self._lam_t, dts[k])
        if g is not None:
            out.add_(g)

    def step(self, u_start, t_start, t_stop):
        if self._dd:
            return self.step_batched(u_start[None], t_start.reshape(1), t_stop.reshape(1))[0]
        return super().step(u_start, t_start, t_stop)

    def step_batched(self, u_tube, t_starts, t_stops):
        """One step of each of B states (DD states and DD times in DD)."""
        if not self._dd:
            return super().step_batched(u_tube, t_starts, t_stops)
        out = torch.empty((u_tube.shape[0], 2) + tuple(u_tube.shape[1:]), dtype=torch.float32,
                          device=self.device)
        self._lane_step(dd.packed(u_tube), 0, dd.sub(t_stops, t_starts).reshape(1, -1), out, None)
        return dd.pair(out, self.ops)

    def total_mass(self, u):
        """int u dx (conserved by periodic diffusion): a diagnostic."""
        return torch.sum(self._mass_ones.to(u.device, u.dtype) * u)
