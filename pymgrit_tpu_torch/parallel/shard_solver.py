"""MGRIT over a ('time', 'space') mesh of processes, with explicit halo
exchanges.

Counterpart of ``pymgrit_tpu/parallel/shard_solver.py``: each process runs
what JAX's ``shard_map`` body runs on one device, on its own slab of every
level, and communicates through ``parallel.comm`` (``torch.distributed``):

* Level state is *interval-major*: ``blocks`` (J_loc, m, ...) -- block j =
  [C-point j*m, its m-1 F-points] -- plus ``last`` (the final C-point),
  replicated.  Coarse levels also carry ``g_blocks`` / ``g_last`` and the
  saved FAS iterate ``v_blocks`` / ``v_last``.  Each rank builds only its
  own slab.
* F-relaxation is local.  Level 0 takes the application's closed form
  (``relax_interval``, kernel K1, or K23 in DD) where the padded grid is
  uniform; every other F-chain goes through the serial solver's ``_chain``
  (the application's ``step_chain``: kernel K2, or K24 in DD; one launch a
  set of chains).
* C-relaxation, the FAS right-hand side and the residual need one halo: the
  previous interval's last F-point, a shift by one across ranks
  (``Comm.shift``, JAX's ``ppermute``).
* The coarse grid's blocks are a reshape of the fine C-points: restriction
  and interpolation are local.
* The coarsest level is solved sequentially on every rank after one
  ``all_gather`` (one chain).
* Residual norms (kernel K3, or the application's ``state_norm``) reduce
  with ``all_reduce`` (sum, max); the square root of the 2-norm is
  ``ieee_sqrt.sqrt_rn``.

Arbitrary interval counts are padded as in JAX: each level's interval
count is rounded up to a shard-divisible J_pad with phantom trailing
intervals on linearly extended times, which no norm and no real point
reads.

Non-uniform hierarchies take JAX's general path (``_setup_general`` and the
``_*_g`` methods): ragged blocks padded to the longest (the lanes past a
block's length are stepped on and never read), trailing F-points,
Gauss-Seidel passes over runs of adjacent C-points (one halo each), and
level transitions through an ``all_gather`` of the coarse level.

The row routines it shares with the serial solver do the arithmetic
(``core.solver.RowRoutines``: ``_chain``, ``_combine`` = K4 or K25 in DD,
``_gather`` = K21, ``_row_norms``, the transfers over rows, the multi-leaf
``vector.Layout`` and the DD packing), so both executors run the same
operations and kernels; on the general path rows move by index through K21,
as on the serial solver's ragged levels.

A mesh with n_space > 1 splits every state's ``space_sharding_axis`` over
the space group: each process holds the slab [s R, (s + 1) R) of that axis
(R = its length / n_space) in every tube, and the application's space route
(``_space_slab``: Heat2D, spectral and physical) does the arithmetic on the
slab and its own communication over the space group (JAX's GSPMD inserts
the collectives of the same splits).  The time collectives stay on the time
group.  Each C-point's norm is the root (``sqrt_rn``) of its slabs' sums of
squares (K3's squares mode) added over the space group; then the time
reduction runs as with one slab.  ``random_init_guess`` draws the whole
states and keeps the slab, so the history does not depend on n_space;
``fine_solution`` gathers over time, then over space.  An application
without a space route, ``precision='dd'`` and spatial coarsening raise on
n_space > 1 (ROADMAP A7c).
"""

from __future__ import annotations

import logging
import sys
import time
from typing import List

import numpy as np
import torch
from torch.utils import _pytree

from pymgrit_tpu_torch.core import prng, vector
from pymgrit_tpu_torch.core.grid_transfer import GridTransferCopy
from pymgrit_tpu_torch.core.levels import build_level_infos, validate_hierarchy
from pymgrit_tpu_torch.core.solver import RowRoutines, _rows, hook_accepts_kwarg
from pymgrit_tpu_torch.ops.ieee_sqrt import sqrt_rn
from pymgrit_tpu_torch.parallel.comm import Comm


_DRAW_ROWS = 4096        # rows of a random initial slab drawn at a time


def _pad_times(t: np.ndarray, n_points: int) -> np.ndarray:
    """Extend a time grid to n_points by continuing the last spacing
    (phantom points get finite, strictly increasing times)."""
    t = np.asarray(t, dtype=np.float64)
    extra = n_points - len(t)
    if extra <= 0:
        return t[:n_points]
    dt = t[-1] - t[-2] if len(t) > 1 else 1.0
    if dt <= 0:
        dt = 1.0
    return np.concatenate([t, t[-1] + dt * np.arange(1, extra + 1)])


class ShardedMgrit(RowRoutines):
    """MGRIT over a ('time', 'space') mesh (``parallel.make_time_space_mesh``),
    one process a cell.  Every rank constructs the solver with the same
    arguments and calls the same methods."""

    def __init__(self, problem: List, mesh, transfer: List = None,
                 tol: float = 1e-7, max_iter: int = 100,
                 nested_iteration: bool = True, cf_iter=1,
                 cycle_type: str = 'V', weight_c: float = 1.0,
                 t_norm: int = 2, conv_crit: int = 0,
                 output_fcn=None, output_lvl: int = 1,
                 random_init_guess: bool = False, rng_seed: int = 0,
                 logging_lvl: int = logging.INFO):
        logging.basicConfig(format='%(levelname)s - %(asctime)s - %(message)s',
                            datefmt='%d-%m-%y %H:%M:%S', level=logging_lvl, stream=sys.stdout)
        validate_hierarchy([p.t for p in problem])
        if conv_crit not in (0, 1, 2, 3):
            raise Exception("Convergence criterion must be 0, 1, 2 or 3")
        if output_lvl not in (0, 1, 2):
            raise Exception("Unknown output level. Choose 0, 1 or 2.")
        self.mesh = mesh
        self.n_shards = mesh.shape["time"]
        self.rank = mesh.rank
        self.n_space = mesh.shape["space"]
        self.space_comm = None
        if self.n_space > 1:
            self._space_route(problem, transfer, mesh)
        self._init_rows(problem, weight_c)
        self.output_fcn = output_fcn if (output_fcn is not None and callable(output_fcn)) else None
        self.output_lvl = output_lvl
        self.random_init_guess = random_init_guess
        self.rng_seed = rng_seed
        self.solve_iter = 0
        self._all_below = False
        self.tol = tol
        self.iter_max = max_iter
        self.cycle_type = cycle_type
        self.t_norm = t_norm
        # 0/1: global residual/jump norm < tol; 2/3: every point's < tol
        self.conv_crit = conv_crit
        self.global_conv_crit = conv_crit in (0, 1)
        self.lvl_max = len(problem)
        self.cf_iter = [cf_iter] * self.lvl_max if isinstance(cf_iter, int) else list(cf_iter)
        self.levels = build_level_infos([p.t for p in problem])
        self.conv = np.zeros(max_iter + 1)
        self.runtime_setup = 0.0
        self.runtime_solve = 0.0

        L = self.lvl_max
        P_ = self.n_shards
        self._general = L >= 2 and not all(self.levels[lvl].uniform for lvl in range(L - 1))
        if self._general:
            self._setup_general(P_)
        else:
            # padded interval counts, divisible over the shards on every
            # level, chosen coarsest-up so that restriction stays a local
            # reshape
            self.m_eff = [self.levels[lvl].m if lvl < L - 1 else 1 for lvl in range(L)]
            self.J_real = [(self.levels[lvl].nt - 1) // self.m_eff[lvl] for lvl in range(L)]
            self.J_pad = [0] * L
            self.J_pad[L - 1] = -(-self.J_real[L - 1] // P_) * P_
            if L >= 2:
                self.J_pad[L - 2] = self.J_pad[L - 1]
            for lvl in range(L - 3, -1, -1):
                self.J_pad[lvl] = self.J_pad[lvl + 1] * self.m_eff[lvl + 1]
            self.Jloc = [self.J_pad[lvl] // P_ for lvl in range(L)]
            self.t_pad = [_pad_times(self.levels[lvl].t, self.J_pad[lvl] * self.m_eff[lvl] + 1)
                          for lvl in range(L)]

        if transfer is None:
            transfer = [GridTransferCopy() for _ in range(self.lvl_max - 1)]
        self.restrict_fns = [self._transfer_fn(tr, tr.restriction, lvl, lvl + 1)
                             for lvl, tr in enumerate(transfer)]
        self.interp_fns = [self._transfer_fn(tr, tr.interpolation, lvl + 1, lvl)
                           for lvl, tr in enumerate(transfer)]
        self.device = self._state(problem[0].vector_template, 0).device
        self.comm = Comm(mesh.group, self.device)
        self._cache = {}
        for lvl, p in enumerate(problem):
            p.prepare_runtime(self.levels[lvl])

        t0 = time.time()
        self._build_state(nested_iteration)
        self.runtime_setup = time.time() - t0
        if self.output_lvl == 2:
            self._call_output()

    def _space_route(self, problem, transfer, mesh):
        """Hand every level its space shard (the application's
        ``_space_slab``), after the refusals: every rank raises alike,
        before any collective."""
        for p in problem:
            if vector.contains_dd(p.vector_template):
                raise NotImplementedError(
                    "precision='dd' has no space route: n_space > 1 (ROADMAP A7c)")
            if getattr(p, "_space_slab", None) is None:
                raise NotImplementedError(
                    f"{type(p).__name__} has no space route: n_space > 1 (ROADMAP A7c)")
        if transfer is not None and not all(type(tr) is GridTransferCopy for tr in transfer):
            raise NotImplementedError("spatial coarsening under a space axis (n_space > 1) is not "
                                      "ported (ROADMAP A7c)")
        self.space_axis = problem[0].space_sharding_axis
        self.space_comm = Comm(mesh.space_group, problem[0].vector_template.device)
        for p in problem:
            p._space_slab(mesh.space_rank, self.n_space, self.space_comm)

    def _row_norms(self, a, b):
        """The serial solver's per-row norms; on a space slab the root of the
        sums of squares (K3's squares mode) added over the space group."""
        if self.space_comm is None:
            return super()._row_norms(a, b)
        sq = self.ops.residual_row_norms(_rows(a), _rows(b), squares=True)
        return sqrt_rn(self.space_comm.all_reduce(sq))

    def _keep_slab(self, rows):
        """This shard's slab of whole states (R, ...) along the space axis."""
        if self.space_comm is None:
            return rows
        ax = 1 + self.space_axis
        R = rows.shape[ax] // self.n_space
        return rows.narrow(ax, self.mesh.space_rank * R, R)

    def _space_gather(self, tube):
        """The whole states of a (nt, ...) tube of slabs (collective over the
        space group)."""
        if self.space_comm is None:
            return tube
        ax = 1 + self.space_axis
        return self.space_comm.all_gather(tube.movedim(ax, 0).contiguous()).movedim(0, ax) \
            .contiguous()

    # ------------------------------------------------------------------
    # general (non-uniform) static structure (JAX's, in numpy)
    # ------------------------------------------------------------------

    def _setup_general(self, P_):
        """Static structure of a ragged hierarchy: block j = [C-point j, its
        len_j - 1 F-points], lanes padded to m_max; trailing F-points (a
        final point absent from the coarser grid); Gauss-Seidel positions
        of runs of adjacent C-points (rmax passes, one halo each)."""
        L = self.lvl_max
        self.m_eff, self.J_real, self.J_pad, self.Jloc = [], [], [], []
        self.g_trailing = []
        self.g_len, self.g_lane_pt = [], []
        self.g_ts_prev, self.g_ts_curr = [], []     # (J_pad, m_max-1) chain times
        self.g_th_prev, self.g_th = [], []          # (J_pad,) head-step times
        self.g_pos, self.g_rmax, self.g_pos_last = [], [], []
        self.g_ub_src = []                          # (nt-1,) unblockify gather
        self.t_pad = [None] * L
        for lvl in range(L):
            li = self.levels[lvl]
            nt, t = li.nt, li.t
            if lvl < L - 1:
                cpts = np.asarray(li.cpts)
                trailing = bool(cpts[-1] != nt - 1)
                heads = cpts if trailing else cpts[:-1]
            else:
                trailing = False
                heads = np.arange(nt - 1)
            J = len(heads)
            Jp = -(-J // P_) * P_
            p = np.append(heads, nt - 1)            # block bounds; p[J] = nt-1
            lens = np.diff(p).astype(np.int64)
            m_max = int(lens.max()) if J else 1
            len_arr = np.full(Jp, m_max, dtype=np.int64)
            len_arr[:J] = lens
            t_ext = _pad_times(t, nt + (Jp - J) * m_max + 2)
            vhead = np.empty(Jp, dtype=np.int64)
            vhead[:J] = p[:J]
            vhead[J:] = (nt - 1) + np.arange(Jp - J) * m_max

            lane_pt = np.empty((Jp, m_max), dtype=np.int64)
            ts_prev = np.empty((Jp, max(m_max - 1, 1)))
            ts_curr = np.empty((Jp, max(m_max - 1, 1)))
            for j in range(Jp):
                ln = len_arr[j]
                base = vhead[j]
                lane_pt[j] = np.minimum(base + np.minimum(np.arange(m_max), ln - 1), nt - 1)
                for s in range(max(m_max - 1, 1)):
                    sv = min(s, ln - 2) if ln >= 2 else 0
                    ts_prev[j, s] = t_ext[base + sv]
                    ts_curr[j, s] = t_ext[base + sv + 1]
            th_prev = np.array([t_ext[max(vhead[j] - 1, 0)] for j in range(Jp)])
            th = np.array([t_ext[vhead[j]] for j in range(Jp)])
            th_prev[0], th[0] = t_ext[0], t_ext[1]   # head 0: a dummy step (never written)

            pos = np.zeros(Jp, dtype=np.int64)
            for j in range(1, Jp):
                pos[j] = pos[j - 1] + 1 if len_arr[j - 1] == 1 else 0
            if lvl < L - 1 and not trailing:
                pos_last = int(pos[J - 1] + 1 if len_arr[J - 1] == 1 else 0) if J else 0
            else:
                pos_last = -1                        # last point is F / coarsest
            rmax = int(max(pos[:J].max() if J else 0, max(pos_last, 0)))

            ub_src = np.empty(nt - 1, dtype=np.int64)
            for j in range(J):
                ub_src[p[j]:p[j + 1]] = j * m_max + np.arange(lens[j])

            self.m_eff.append(m_max)
            self.J_real.append(J)
            self.J_pad.append(Jp)
            self.Jloc.append(Jp // P_)
            self.g_trailing.append(trailing)
            self.g_len.append(len_arr)
            self.g_lane_pt.append(lane_pt)
            self.g_ts_prev.append(ts_prev)
            self.g_ts_curr.append(ts_curr)
            self.g_th_prev.append(th_prev)
            self.g_th.append(th)
            self.g_pos.append(pos)
            self.g_rmax.append(rmax)
            self.g_pos_last.append(pos_last)
            self.g_ub_src.append(ub_src)
        lC = L - 1
        self.t_pad[lC] = _pad_times(self.levels[lC].t, self.J_pad[lC] + 1)

    # ------------------------------------------------------------------
    # layout helpers
    # ------------------------------------------------------------------

    def _loc(self, a, lvl):
        """This rank's slab of a (J_pad, ...) global array."""
        J = self.Jloc[lvl]
        return a[self.rank * J:(self.rank + 1) * J]

    def _index(self, key, values):
        """A device index tensor, made once."""
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(np.asarray(values, dtype=np.int64),
                                               device=self.device)
        return self._cache[key]

    def _fill_rows(self, rows, lvl, idx):
        """Write rows idx (global point indices) of level lvl's initial tube
        into the zero rows ``rows``: at level 0 with ``random_init_guess``
        the JAX package's random draw of those rows (a chunk at a time),
        and the start value at point 0."""
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        p = self.problem[lvl]
        nt = self.levels[lvl].nt
        if lvl == 0 and self.random_init_guess:
            lay, shape = self._layouts[lvl], tuple(rows.shape[1:])
            for c in range(0, idx.size, _DRAW_ROWS):
                part = idx[c:c + _DRAW_ROWS]
                if self._dd:
                    rows[c:c + part.size] = prng.random_dd_tube(
                        self.rng_seed, nt, shape[1:], rows.device, rows=part)
                elif lay is not None:
                    rows[c:c + part.size] = torch.cat(
                        [x.reshape(part.size, -1) for x in prng.random_leaves(
                            self.rng_seed, nt, lay.shapes, rows.device, rows=part)], dim=1)
                else:
                    # the whole states' draw (the history does not depend on
                    # n_space), this shard's slab kept
                    whole = list(shape)
                    if self.space_comm is not None:
                        whole[self.space_axis] *= self.n_space
                    rows[c:c + part.size] = self._keep_slab(prng.random_leaves(
                        self.rng_seed, nt, [tuple(whole)], rows.device, rows=part)[0])
        start = np.nonzero(idx == 0)[0]
        if start.size:
            rows[torch.as_tensor(start, device=rows.device)] = self._state(p.vector_t_start, lvl)

    def _entry_rows(self, lvl):
        """(blocks (J_loc, m, ...), last) of this rank's initial slab,
        written in place (phantom blocks zero on the uniform path)."""
        nt, m, Jloc = self.levels[lvl].nt, self.m_eff[lvl], self.Jloc[lvl]
        template = self._state(self.problem[lvl].vector_template, lvl)
        shape = tuple(template.shape)
        blocks = torch.zeros((Jloc, m) + shape, dtype=template.dtype, device=self.device)
        if self._general:
            self._fill_rows(blocks.view((-1,) + shape), lvl,
                            self._loc(self.g_lane_pt[lvl], lvl))
        else:
            first = self.rank * Jloc
            n_real = max(0, min(Jloc, self.J_real[lvl] - first))
            self._fill_rows(blocks[:n_real].view((-1,) + shape), lvl,
                            first * m + np.arange(n_real * m))
        last = torch.zeros((1,) + shape, dtype=template.dtype, device=self.device)
        self._fill_rows(last, lvl, [nt - 1])
        return blocks, last[0]

    def _build_state(self, nested):
        self.state = {}
        for lvl in range(self.lvl_max):
            blocks, last = self._entry_rows(lvl)
            entry = {"blocks": blocks, "last": last}
            if lvl > 0:
                entry["g_blocks"] = torch.zeros_like(blocks)
                entry["g_last"] = torch.zeros_like(last)
                if self._general:
                    # the saved FAS iterate, a replicated coarse tube
                    entry["v_tube"] = vector.tube_of(last, self.levels[lvl].nt)
                else:
                    entry["v_blocks"] = torch.zeros_like(blocks)
                    entry["v_last"] = torch.zeros_like(last)
            self.state[lvl] = entry
        # level 0's closed form applies where the padded grid is uniform
        hook = getattr(self.problem[0], "relax_interval", None)
        d = np.diff(self.t_pad[0]) if self.t_pad[0] is not None else np.zeros(0)
        uniform = d.size and np.allclose(d, d[0], rtol=1e-12, atol=0.0)
        self._hook0 = (hook if hook is not None and not self._general and uniform
                       and hook_accepts_kwarg(hook, "out") else None)
        # phantom blocks and the global first C-point are not residual points
        J0 = self.Jloc[0]
        gidx = self.rank * J0 + np.arange(J0)
        drop = (gidx >= self.J_real[0]) | (gidx == 0)
        self._keep0 = torch.as_tensor(~drop, device=self.device)
        if nested:
            self._nested()
        # the jump criteria compare with the previous iterate's C-points
        self._u_save = self._c_view()

    def _c_view(self):
        """Copies of the level-0 C-points of this rank and of ``last``."""
        st = self.state[0]
        return {"c": st["blocks"][:, 0].clone(), "last": st["last"].clone()}

    # ------------------------------------------------------------------
    # communication: halos and broadcasts of rows
    # ------------------------------------------------------------------

    def _halo(self, vals):
        """(J_loc, ...) -> each entry's predecessor in global order; the
        first arrives from the previous rank (zeros on rank 0)."""
        out = torch.empty_like(vals)
        out[1:] = vals[:-1]
        out[0] = self.comm.shift(vals[-1])
        return out

    def _select_global(self, view, lvl, j_global):
        """Row j_global (global block index) of a (J_loc, ...) view, on every
        rank: a broadcast from its owner."""
        owner, loc = divmod(j_global, self.Jloc[lvl])
        buf = view[loc].clone() if self.rank == owner else torch.empty(
            view.shape[1:], dtype=view.dtype, device=view.device)
        return self.comm.broadcast(buf, owner)

    def _step_last(self, lvl, prev, g=None):
        """One step of a single state to the level's final point."""
        t = self.levels[lvl].t
        return self._step_rows(lvl, prev[None], t[-2:-1], t[-1:], None if g is None else g[None])[0]

    def _restrict(self, lvl, rows):
        """The restriction of rows (R, ...) as a fresh contiguous tensor."""
        return self.restrict_fns[lvl](rows).contiguous()

    def _interp(self, lvl, rows):
        return self.interp_fns[lvl](rows).contiguous()

    def _c_step_times(self, lvl):
        """This rank's (t_prev, t_curr) of the step into each block's
        C-point from the previous block's last F-point (block 0: a dummy)."""
        key = ("ct", lvl)
        if key not in self._cache:
            if self._general:
                tp, tc = self.g_th_prev[lvl], self.g_th[lvl]
            else:
                m, Jp, t = self.m_eff[lvl], self.J_pad[lvl], self.t_pad[lvl]
                tc = t[np.arange(Jp) * m]
                tprev = t[np.arange(1, Jp + 1) * m - 1]
                tp = np.concatenate([tprev[:1], tprev[:-1]])
            self._cache[key] = (self._loc(tp, lvl), self._loc(tc, lvl))
        return self._cache[key]

    def _prev_f(self, lvl):
        """Each block's predecessor of its C-point: the previous block's
        last (real) lane, across ranks."""
        blocks = self.state[lvl]["blocks"]
        return self._halo(self._last_real_lane(lvl) if self._general else blocks[:, -1])

    def _global_last_f(self, lvl):
        """The predecessor of the level's final point, on every rank."""
        blocks = self.state[lvl]["blocks"]
        view = self._last_real_lane(lvl) if self._general else blocks[:, -1]
        return self._select_global(view, lvl, self.J_real[lvl] - 1)

    def _last_real_lane(self, lvl):
        """(J_loc, ...) each block's last real lane (general path; K21)."""
        blocks = self.state[lvl]["blocks"]
        m = self.m_eff[lvl]
        lane = self._index(("lane", lvl),
                           np.arange(self.Jloc[lvl]) * m + self._loc(self.g_len[lvl] - 1, lvl))
        return self._gather(blocks.view((-1,) + tuple(blocks.shape[2:])), lane)

    # ------------------------------------------------------------------
    # shard-local phases (uniform path)
    # ------------------------------------------------------------------

    def _f_relax(self, lvl):
        """Every block's F-points from its own C-point: level 0 through the
        closed form where the grid allows, else one set of chains; then a
        trailing final F-point (general path) from the last block."""
        if self.m_eff[lvl] > 1:
            self._f_chains(lvl)
        if self._general and self.g_trailing[lvl]:
            st = self.state[lvl]
            st["last"].copy_(self._step_last(lvl, self._global_last_f(lvl),
                                             st["g_last"] if lvl > 0 else None))

    def _f_chains(self, lvl):
        m = self.m_eff[lvl]
        st = self.state[lvl]
        blocks = st["blocks"]
        x, out = blocks[:, 0], blocks[:, 1:]
        if self._general:
            tp = self._loc(self.g_ts_prev[lvl], lvl).T
            tc = self._loc(self.g_ts_curr[lvl], lvl).T
        else:
            tl = self._loc(self.t_pad[lvl][:self.J_pad[lvl] * m].reshape(-1, m), lvl)
            tp, tc = tl[:, :m - 1].T, tl[:, 1:].T
        tp, tc = np.ascontiguousarray(tp), np.ascontiguousarray(tc)      # (m-1, J_loc)
        if lvl == 0:
            if self._hook0 is not None:
                # the closed form reads the step size of the first interval
                # (JAX tiles global block 0's times)
                tg = self.t_pad[0]
                t0 = np.tile(tg[0:m - 1][:, None], (1, self.Jloc[0]))
                t1 = np.tile(tg[1:m][:, None], (1, self.Jloc[0]))
                if self._hook0(self._tree(0, x), t0, t1, out=self._tree(0, out)) is not None:
                    return
            self._chain(0, x, tp, tc, out)
            return
        self._chain(lvl, x, tp, tc, out, st["g_blocks"][:, 1:])

    def _c_relax(self, lvl):
        if self._general:
            return self._c_relax_g(lvl)
        st = self.state[lvl]
        tp, tc = self._c_step_times(lvl)
        stepped = self._step_rows(lvl, self._prev_f(lvl), tp, tc,
                             st["g_blocks"][:, 0] if lvl > 0 else None)
        lo = 1 if self.rank == 0 else 0          # the global first C-point keeps the IC
        self._weighted_into(st["blocks"][lo:, 0], stepped[lo:])
        self._weighted_into(st["last"][None], self._step_last(
            lvl, self._global_last_f(lvl), st["g_last"] if lvl > 0 else None)[None])

    def _fas(self, lvl):
        """Restriction and the FAS right-hand side into level lvl+1."""
        if self._general:
            return self._fas_g(lvl)
        st, stc = self.state[lvl], self.state[lvl + 1]
        Jloc = self.Jloc[lvl]
        fine_c = st["blocks"][:, 0]
        u_flat = stc["blocks"].view((Jloc,) + tuple(stc["blocks"].shape[2:]))
        u_flat.copy_(self.restrict_fns[lvl](fine_c))
        stc["last"].copy_(self.restrict_fns[lvl](st["last"][None])[0])
        stc["v_blocks"].copy_(stc["blocks"])
        stc["v_last"].copy_(stc["last"])
        v_flat = stc["v_blocks"].view(u_flat.shape)

        # g = R(Phi(u_prevF) - u_C [+ g terms]) + v - Phi_c(v_prev)
        tp, tc = self._c_step_times(lvl)
        inner = self._step_rows(lvl, self._prev_f(lvl), tp, tc)
        if lvl == 0:
            self._combine(inner, [inner, fine_c], [1.0, -1.0])
        else:
            self._combine(inner, [st["g_blocks"][:, 0], fine_c, inner], [1.0, -1.0, 1.0])
        r = self._restrict(lvl, inner)
        t_c, Jp = self.t_pad[lvl + 1], self.J_pad[lvl]
        stepped_c = self._step_rows(lvl + 1, self._halo(v_flat),
                               self._loc(np.concatenate([t_c[0:1], t_c[:Jp - 1]]), lvl),
                               self._loc(t_c[:Jp], lvl))
        g_flat = stc["g_blocks"].view(u_flat.shape)
        self._combine(g_flat, [v_flat, stepped_c, r], [1.0, -1.0, 1.0])
        if self.rank == 0:
            g_flat[0].zero_()                      # the global coarse point 0: never read

        # g_last, at the global final coarse point
        inner_l = self._step_last(lvl, self._global_last_f(lvl))[None]
        if lvl == 0:
            self._combine(inner_l, [inner_l, st["last"][None]], [1.0, -1.0])
        else:
            self._combine(inner_l, [st["g_last"][None], st["last"][None], inner_l],
                          [1.0, -1.0, 1.0])
        r_l = self._restrict(lvl, inner_l)
        stepped_cl = self._step_last(lvl + 1, self._select_global(v_flat, lvl,
                                                                  self.J_real[lvl] - 1))
        self._combine(stc["g_last"][None], [stc["v_last"][None], stepped_cl[None], r_l],
                      [1.0, -1.0, 1.0])

    def _error_correction(self, lvl):
        if self._general:
            return self._error_correction_g(lvl)
        st, stc = self.state[lvl], self.state[lvl + 1]
        Jloc = self.Jloc[lvl]
        shape = (Jloc,) + tuple(stc["blocks"].shape[2:])
        e = torch.empty(shape, dtype=stc["blocks"].dtype, device=self.device)
        self._combine(e, [stc["blocks"].view(shape), stc["v_blocks"].view(shape)], [1.0, -1.0])
        if self.rank == 0:
            e[0].zero_()                           # the IC receives no correction
        dst = st["blocks"][:, 0]
        self._combine(dst, [dst, self._interp(lvl, e)], [1.0, 1.0])
        el = torch.empty_like(stc["last"])[None]
        self._combine(el, [stc["last"][None], stc["v_last"][None]], [1.0, -1.0])
        self._combine(st["last"][None], [st["last"][None], self._interp(lvl, el)], [1.0, 1.0])

    def _coarsest_solve(self):
        """The sequential solve of the coarsest level, repeated on every rank
        after one all_gather of g: points 0..J_real-1 live in ``blocks``
        (m = 1), the final point in ``last``; the chain runs over the padded
        length and phantom steps trail the real points."""
        lvl = self.lvl_max - 1
        st = self.state[lvl]
        J_real, Jp, Jloc = self.J_real[lvl], self.J_pad[lvl], self.Jloc[lvl]
        shape = tuple(st["blocks"].shape[2:])
        g_all = self.comm.all_gather(st["g_blocks"].view((Jloc,) + shape))
        u0 = self._select_global(st["blocks"][:, 0], lvl, 0)
        # step k produces point k+1 with g at point k+1; the step producing
        # the real final point (k = J_real-1) takes g_last
        g_seq = torch.empty((1, Jp) + shape, dtype=g_all.dtype, device=self.device)
        g_seq[0, :Jp - 1] = g_all[1:]
        g_seq[0, Jp - 1] = st["g_last"]
        g_seq[0, J_real - 1] = st["g_last"]
        t = self.t_pad[lvl]
        rest = torch.empty_like(g_seq)
        self._chain(lvl, u0[None], t[:-1][:, None], t[1:][:, None], rest, g_seq)
        # rest: points 1..J_pad; blocks hold points 0..J_pad-1
        first = self.rank * Jloc
        blk = st["blocks"].view((Jloc,) + shape)
        if first == 0:
            blk[0] = u0
            blk[1:] = rest[0, :Jloc - 1]
        else:
            blk.copy_(rest[0, first - 1:first - 1 + Jloc])
        st["last"].copy_(rest[0, J_real - 1])

    # ------------------------------------------------------------------
    # general (non-uniform) phases
    # ------------------------------------------------------------------

    def _gs_index(self, lvl, r):
        """This rank's blocks relaxed in Gauss-Seidel pass r (never the
        global first C-point)."""
        pos = self._loc(self.g_pos[lvl], lvl)
        sel = pos == r
        if self.rank == 0:
            sel = sel & (np.arange(sel.size) != 0)
        return self._index(("gs", lvl, r), np.nonzero(sel)[0])

    def _c_relax_g(self, lvl):
        st = self.state[lvl]
        w = self.weight_c
        blocks = st["blocks"]
        tp, tc = self._c_step_times(lvl)
        old_c = blocks[:, 0].clone()
        g_c = st["g_blocks"][:, 0] if lvl > 0 else None

        heads = old_c.clone()

        def upd(prev_vals, r):
            stepped = self._step_rows(lvl, prev_vals, tp, tc, g_c)
            if w != 1.0:
                self._combine(stepped, [stepped, old_c], [w, 1.0 - w])
            sel = self._gs_index(lvl, r)
            if sel.shape[0]:
                # heads[sel] = stepped[sel] (K21)
                self.ops.indexed_combine(_rows(heads), [_rows(stepped)], [1.0], io=sel, idx=[sel])

        # pass 0 (predecessors are F-points), then rmax Gauss-Seidel passes
        # (predecessor = the previous block's C-point, just relaxed)
        upd(self._prev_f(lvl), 0)
        for r in range(1, self.g_rmax[lvl] + 1):
            upd(self._halo(heads), r)
        blocks[:, 0] = heads
        if self.g_pos_last[lvl] >= 0:
            stepped = self._step_last(lvl, self._global_last_f(lvl),
                                      st["g_last"] if lvl > 0 else None)
            self._weighted_into(st["last"][None], stepped[None])

    def _coarse_tube_g(self, lvl):
        """Level lvl's full (nt, ...) tube on every rank (one all_gather,
        then K21)."""
        st = self.state[lvl]
        gathered = self.comm.all_gather(st["blocks"])
        nt = self.levels[lvl].nt
        flat = gathered.view((-1,) + tuple(gathered.shape[2:]))
        tube = torch.empty((nt,) + tuple(flat.shape[1:]), dtype=flat.dtype, device=flat.device)
        self.ops.indexed_combine(_rows(tube[:nt - 1]), [_rows(flat)], [1.0],
                                 idx=[self._index(("ub", lvl), self.g_ub_src[lvl])])
        tube[nt - 1] = st["last"]
        return tube

    def _tube_to_entry_g(self, tube, lvl):
        """A replicated (nt, ...) tube -> (this rank's blocks, last), the
        blocks through K21."""
        lp = self._index(("lp", lvl), self._loc(self.g_lane_pt[lvl], lvl).reshape(-1))
        blocks = self._gather(tube, lp)
        return (blocks.view((self.Jloc[lvl], self.m_eff[lvl]) + tuple(tube.shape[1:])),
                tube[self.levels[lvl].nt - 1].clone())

    def _heads_pad(self, lvl, vals):
        """A (>= J_real, ...) tube of head values -> this rank's (J_loc, ...)
        slab of the padded head axis (phantoms zero)."""
        J, Jloc = self.J_real[lvl], self.Jloc[lvl]
        out = torch.zeros((Jloc,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=self.device)
        first = self.rank * Jloc
        n = max(0, min(Jloc, J - first))
        if n:
            out[:n] = vals[first:first + n]
        return out

    def _fas_g(self, lvl):
        st, stc = self.state[lvl], self.state[lvl + 1]
        li, lc = self.levels[lvl], self.levels[lvl + 1]
        heads = st["blocks"][:, 0]
        r_heads = self._restrict(lvl, heads)
        tp, tc = self._c_step_times(lvl)
        inner = self._step_rows(lvl, self._prev_f(lvl), tp, tc)
        if lvl == 0:
            self._combine(inner, [inner, heads], [1.0, -1.0])
        else:
            self._combine(inner, [st["g_blocks"][:, 0], heads, inner], [1.0, -1.0, 1.0])
        inner = self._restrict(lvl, inner)
        gh = self.comm.all_gather(r_heads)
        gi = self.comm.all_gather(inner)
        J = self.J_real[lvl]
        if self.g_trailing[lvl]:
            u_c_tube = gh[:J]
            inner_c = gi[1:J]
        else:
            u_c_tube = torch.cat([gh[:J], self._restrict(lvl, st["last"][None])])
            inner_l = self._step_last(lvl, self._global_last_f(lvl))[None]
            if lvl == 0:
                self._combine(inner_l, [inner_l, st["last"][None]], [1.0, -1.0])
            else:
                self._combine(inner_l, [st["g_last"][None], st["last"][None], inner_l],
                              [1.0, -1.0, 1.0])
            inner_c = torch.cat([gi[1:J], self._restrict(lvl, inner_l)])
        stc["v_tube"] = u_c_tube.clone()
        t_c = lc.t
        stepped_c = self._step_rows(lvl + 1, u_c_tube[:-1], t_c[:-1], t_c[1:])
        g_tube = torch.zeros_like(u_c_tube)
        self._combine(g_tube[1:], [u_c_tube[1:], stepped_c, inner_c], [1.0, -1.0, 1.0])
        stc["blocks"], stc["last"] = self._tube_to_entry_g(u_c_tube, lvl + 1)
        stc["g_blocks"], stc["g_last"] = self._tube_to_entry_g(g_tube, lvl + 1)

    def _error_correction_g(self, lvl):
        st, stc = self.state[lvl], self.state[lvl + 1]
        u_c_tube = self._coarse_tube_g(lvl + 1)
        e_tube = torch.empty_like(u_c_tube)
        self._combine(e_tube, [u_c_tube, stc["v_tube"]], [1.0, -1.0])
        e_int = self._interp(lvl, e_tube)
        trailing = self.g_trailing[lvl]
        e_loc = self._heads_pad(lvl, e_int if trailing else e_int[:-1])
        if self.rank == 0:
            e_loc[0].zero_()                       # the IC receives no correction
        heads = st["blocks"][:, 0]
        self._combine(heads, [heads, e_loc], [1.0, 1.0])
        if not trailing:
            self._combine(st["last"][None], [st["last"][None], e_int[-1:]], [1.0, 1.0])

    # ------------------------------------------------------------------
    # cycles, nested iteration
    # ------------------------------------------------------------------

    def _cycle(self, lvl, cycle_type, first_f, lvl0_first):
        if lvl == self.lvl_max - 1:
            self._coarsest_solve()
            return
        if (lvl > 0 or lvl0_first) and first_f:
            self._f_relax(lvl)
        for _ in range(self.cf_iter[lvl]):
            self._c_relax(lvl)
            self._f_relax(lvl)
        self._fas(lvl)
        self._cycle(lvl + 1, cycle_type, True, lvl0_first)
        self._error_correction(lvl)
        self._f_relax(lvl)
        if lvl != 0 and cycle_type == 'F':
            self._cycle(lvl, 'V', False, lvl0_first)

    def _iteration(self, first):
        self._cycle(0, self.cycle_type, True, first)

    def _nested(self):
        """Nested iteration: the coarsest solve, then each finer level's
        C-points interpolated from the coarser level (the global first one
        kept), with a V-cycle on every intermediate level."""
        self._coarsest_solve()
        for lvl in range(self.lvl_max - 2, -1, -1):
            st, stc = self.state[lvl], self.state[lvl + 1]
            if self._general:
                interped = self._interp(lvl, self._coarse_tube_g(lvl + 1))
                trailing = self.g_trailing[lvl]
                vals = self._heads_pad(lvl, interped if trailing else interped[:-1])
                if not trailing:
                    st["last"].copy_(interped[-1])
            else:
                shape = (self.Jloc[lvl],) + tuple(stc["blocks"].shape[2:])
                vals = self._interp(lvl, stc["blocks"].view(shape))
                st["last"].copy_(self._interp(lvl, stc["last"][None])[0])
            lo = 1 if self.rank == 0 else 0
            st["blocks"][lo:, 0] = vals[lo:]
            if lvl > 0:
                self._cycle(lvl, 'V', True, True)

    # ------------------------------------------------------------------
    # convergence
    # ------------------------------------------------------------------

    def _conv_body(self, u_save):
        """(conv, all_below, new u_save): the t_norm aggregate of the
        per-C-point residual or jump norms (K3, or ``state_norm``) reduced
        over ranks, the local criteria's every-point-below-tol flag (device
        tensors), and the C-points the jump criteria compare with next."""
        st = self.state[0]
        c_now = st["blocks"][:, 0]
        trailing = self._general and self.g_trailing[0]
        if self.conv_crit in (0, 2):
            tp, tc = self._c_step_times(0)
            norms = self._row_norms(self._step_rows(0, self._prev_f(0), tp, tc), c_now)
            n_last = None if trailing else self._row_norms(
                self._step_last(0, self._global_last_f(0))[None], st["last"][None])[0]
        else:
            norms = self._row_norms(c_now, u_save["c"])
            n_last = None if trailing else self._row_norms(st["last"][None],
                                                           u_save["last"][None])[0]
            u_save = self._c_view()
        norms = torch.where(self._keep0, norms, torch.zeros((), dtype=norms.dtype,
                                                            device=norms.device))
        if n_last is None:
            n_last = torch.zeros((), dtype=norms.dtype, device=norms.device)
        worst = self.comm.all_reduce(torch.max(norms), "max")
        if self.t_norm == 2:
            total = self.comm.all_reduce(torch.sum(norms * norms), "sum")
            conv = sqrt_rn(total + n_last * n_last)
        elif self.t_norm == 1:
            conv = self.comm.all_reduce(torch.sum(norms), "sum") + n_last
        else:
            conv = torch.maximum(worst, n_last)
        all_below = torch.maximum(worst, n_last) < self.tol
        return conv, all_below, u_save

    def convergence_criterion(self, iteration: int) -> None:
        """Compute self.conv[iteration] (and the local criteria's
        every-point-below-tol flag).  Overridable; custom criteria apply to
        solve(), solve_compiled takes compiled_convergence_criterion."""
        conv, all_below, self._u_save = self._conv_body(self._u_save)
        self.conv[iteration] = float(conv)
        self._all_below = bool(all_below)

    # A subclass may set compiled_convergence_criterion to a function
    # (self, state, aux) -> (conv, done, aux): state is the solver's state
    # dict {level: {"blocks", "last", ...}} of this rank's slabs, aux what
    # compiled_conv_aux_init returns (split over the ranks on its leaves
    # that compiled_conv_aux_specs marks "time"); it may call self.comm's
    # collectives, and done must agree on every rank.
    compiled_convergence_criterion = None

    def compiled_conv_aux_init(self):
        """Initial aux of the custom criterion: a 0-d float64 zero."""
        return torch.zeros((), dtype=torch.float64, device=self.device)

    def compiled_conv_aux_specs(self, aux0):
        """For each aux leaf, "time" (its axis 0 is split over the ranks on
        the way in and gathered on the way out) or None (replicated, the
        default).  Override beside compiled_conv_aux_init when the aux
        carries per-C-point values."""
        return _pytree.tree_map(lambda x: None, aux0)

    def _aux_split(self, aux, specs):
        def split(x, spec):
            if spec is None:
                return x
            n = x.shape[0] // self.n_shards
            return x[self.rank * n:(self.rank + 1) * n].clone()
        return _pytree.tree_map(split, aux, specs, is_leaf=lambda s: s is None)

    def _aux_join(self, aux, specs):
        def join(x, spec):
            return x if spec is None else self.comm.all_gather(x)
        return _pytree.tree_map(join, aux, specs, is_leaf=lambda s: s is None)

    def solve_compiled(self) -> dict:
        """The iteration loop over device tensors, reading one flag per
        iteration to decide whether to stop (the flag is the same on every
        rank: every rank leaves the loop at the same iteration)."""
        custom = type(self).compiled_convergence_criterion
        aux0 = self.compiled_conv_aux_init()
        specs = self.compiled_conv_aux_specs(aux0)
        aux = self._aux_split(aux0, specs)
        u_save = self._u_save
        t0 = time.time()
        hist = []
        for it in range(self.iter_max):
            self._iteration(first=it == 0)
            if custom is not None:
                conv, done, aux = custom(self, self.state, aux)
                conv = torch.as_tensor(conv, dtype=torch.float64, device=self.device)
            else:
                conv, all_below, u_save = self._conv_body(u_save)
                done = conv < self.tol if self.global_conv_crit else all_below
            hist.append(conv.to(torch.float64))
            if bool(done):
                break
        self._u_save = u_save
        self._compiled_conv_aux = self._aux_join(aux, specs)
        hist = torch.stack(hist).cpu().numpy()
        it = hist.shape[0]
        self.conv = np.zeros(self.iter_max + 1)
        self.conv[1:it + 1] = hist
        self.runtime_solve = time.time() - t0
        self.solve_iter = it
        if self.rank == 0:
            for k in range(it):
                logging.info(f"sharded iter {k + 1} | conv: {hist[k]}")
        if self.output_lvl in (1, 2):
            self._call_output()
        return {'conv': self.conv[np.where(self.conv != 0)],
                'time_setup': self.runtime_setup, 'time_solve': self.runtime_solve}

    def solve(self) -> dict:
        t0 = time.time()
        for it in range(self.iter_max):
            self.solve_iter = it + 1
            self._iteration(first=it == 0)
            self.convergence_criterion(it + 1)
            conv = self.conv[it + 1]
            if self.rank == 0:
                logging.info(f"sharded iter {it + 1} | conv: {conv}")
            if self.output_lvl == 2:
                self._call_output()
            if (conv < self.tol) if self.global_conv_crit else self._all_below:
                break
        self.runtime_solve = time.time() - t0
        if self.output_lvl == 1:
            self._call_output()
        return {'conv': self.conv[np.where(self.conv != 0)],
                'time_setup': self.runtime_setup, 'time_solve': self.runtime_solve}

    # ------------------------------------------------------------------
    # the fine solution and the output hook
    # ------------------------------------------------------------------

    def fine_solution(self):
        """The fine level's (nt, ...) tube of whole states on every rank
        (collective: every rank calls it): one all_gather of the level-0
        blocks over time, then one of the slabs over space; in the
        application's structure for a multi-leaf state."""
        if self._general:
            return self._tree(0, self._space_gather(self._coarse_tube_g(0)))
        st = self.state[0]
        gathered = self.comm.all_gather(st["blocks"])
        flat = gathered.view((-1,) + tuple(gathered.shape[2:]))
        return self._tree(0, self._space_gather(
            torch.cat([flat[:self.J_real[0] * self.m_eff[0]], st["last"][None]])))

    def _call_output(self):
        """The user's output hook with the reference's views (self.t,
        self.index_local, self.u); gathers the fine solution (collective:
        it runs on every rank)."""
        if self.output_fcn is None:
            return
        self.t = [li.t for li in self.levels]
        self.index_local = [np.arange(li.nt) for li in self.levels]
        self.u = [self.fine_solution()]
        self.output_fcn(self)


class ShardedAtMgrit(ShardedMgrit):
    """AT-MGRIT in the sharded executor: the coarsest level solves
    distance-k truncated windows.  Each rank receives only the k-1 points
    before its slab (a chain of ceil((k-1)/J_loc) shifts) and one broadcast
    of the k-point tail window for the final point.  Where the coarsest
    application has ``affine_coeffs``, kernel K9 computes the rank's windows
    over its halo-extended slab; otherwise k-1 masked steps."""

    def __init__(self, k: int, *args, **kwargs):
        self.k = k
        super().__init__(*args, **kwargs)

    def _left_halo(self, flat, depth):
        """The ``depth`` entries before this rank's slab (global order),
        through chained shifts (zeros before global point 0).  Hop h moves
        the last rows of the slab of the rank h to the left, only as many
        as are still wanted: ``depth`` rows in all."""
        slabs, rolled, got = [], flat, 0
        while got < depth:
            take = min(depth - got, rolled.shape[0])
            rolled = self.comm.shift(rolled[rolled.shape[0] - take:])
            slabs.insert(0, rolled)
            got += take
        return torch.cat(slabs) if slabs else flat[:0]

    def _tail_window(self, flat, last, n, lvl):
        """The last n real points and the final point on every rank: one
        broadcast from each owner of the window's points."""
        Jloc, J_real = self.Jloc[lvl], self.J_real[lvl]
        idxs = np.arange(max(0, J_real - n), J_real)
        owners = idxs // Jloc
        out = torch.empty((idxs.size + 1,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                          device=flat.device)
        for o in np.unique(owners):
            at = np.nonzero(owners == o)[0]
            src = torch.as_tensor(idxs[at] % Jloc, device=flat.device)
            buf = flat[src].clone() if self.rank == o else out[at[0]:at[-1] + 1]
            out[at[0]:at[-1] + 1] = self.comm.broadcast(buf, int(o))
        out[-1] = last
        return out

    def _affine_rows(self, lvl, t_prev, t_curr, shape):
        """The coarsest application's affine steps over the given times as
        two (n, N) row views."""
        A, b = self.problem[lvl].affine_coeffs(t_prev, t_curr)
        lay = self._layouts[lvl]
        if lay is not None:
            like = lay.tree(torch.empty(shape, dtype=torch.float64, device="meta"))
            return tuple(lay.flat(vector._map(lambda a, z: torch.broadcast_to(a, z.shape), x, like))
                         for x in (A, b))
        n = int(np.prod(shape[1:], dtype=np.int64))       # a slab of one point has no step
        return tuple(torch.broadcast_to(x, shape).reshape(shape[0], n) for x in (A, b))

    def _coarsest_solve(self):
        lvl = self.lvl_max - 1
        st = self.state[lvl]
        nt, k = self.levels[lvl].nt, self.k
        J_real, Jloc = self.J_real[lvl], self.Jloc[lvl]
        H = min(k - 1, nt - 1)                               # halo depth
        t_pad = self.t_pad[lvl]
        u_flat = st["blocks"][:, 0]
        g_flat = st["g_blocks"][:, 0]
        base = self.rank * Jloc
        # the extended view covers global points [start, base + Jloc): the
        # window starts of this rank's points all lie in it, and it starts
        # at global point 0 on the ranks that hold the first windows (K9
        # clamps a window at row 0 of what it is given)
        start = max(0, base - H)
        uh = self._left_halo(u_flat, H)
        gh = self._left_halo(g_flat, H)
        u_ext = torch.cat([uh[H - (base - start):], u_flat])
        g_ext = torch.cat([gh[H - (base - start):], g_flat])
        n = u_ext.shape[0]
        out = torch.empty_like(u_ext)
        if getattr(self.problem[lvl], "affine_coeffs", None) is not None:
            A, b = self._affine_rows(lvl, t_pad[start:start + n - 1], t_pad[start + 1:start + n],
                                     u_ext[1:].shape)
            self.ops.affine_windows(_rows(u_ext), A, b, _rows(g_ext)[1:], _rows(out), k)
        else:
            self._masked_windows(lvl, u_ext, g_ext, start, out)

        # the replicated final point: the window of its last H points (from
        # the values before this solve)
        if H > 0:
            u_tail = self._tail_window(u_flat, st["last"], H, lvl)
            g_tail = self._tail_window(g_flat, st["g_last"], H, lvl)
            t = self.levels[lvl].t
            chain = torch.empty((1, H) + tuple(u_tail.shape[1:]), dtype=u_tail.dtype,
                                device=self.device)
            self._chain(lvl, u_tail[0:1], t[nt - 1 - H:nt - 1][:, None], t[nt - H:nt][:, None],
                        chain, g_tail[1:][None])
            st["last"].copy_(chain[0, -1])
        u_flat.copy_(out[base - start:])

    def _masked_windows(self, lvl, u_ext, g_ext, start, out):
        """k-1 masked steps over the extended view's lanes: lane p (global)
        starts from u[max(0, p-k+1)] and steps x <- g[i] + Phi(x) while
        i <= p."""
        t_pad = self.t_pad[lvl]
        n = u_ext.shape[0]
        pts = start + np.arange(n)
        ws = np.maximum(0, pts - self.k + 1)
        x = u_ext[torch.as_tensor(ws - start, device=self.device)]
        shape = (n,) + (1,) * (u_ext.dim() - 1)
        for s in range(1, max(self.k, 2)):
            i = ws + s
            ic = np.minimum(i, t_pad.size - 1)
            gi = g_ext[torch.as_tensor(np.minimum(i - start, n - 1), device=self.device)]
            stepped = self._step_rows(lvl, x, t_pad[ic - 1], t_pad[ic], gi)
            active = torch.as_tensor(i <= pts, device=self.device).view(shape)
            x = torch.where(active, stepped, x)
        out.copy_(x)
