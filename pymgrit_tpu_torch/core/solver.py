"""MGRIT solver in FAS formulation, on torch tensors.

Counterpart of ``pymgrit_tpu/core/solver.py``.  The iteration structure
(V-/F-cycles, FCF-relaxation, nested iteration, convergence criteria 0-3,
C-relaxation weight) and the condensed level-0 carry are the JAX
package's; the execution differs:

* Solution state per level is a *tube*: one tensor with a leading time
  axis.  The JAX code is functional; here every phase updates the tubes in
  place through strided row views (C-rows ``m::m``, F-blocks), which the
  kernels read and write directly.  Where a phase reads rows it also
  writes, it writes a fresh buffer first (Jacobi C-relaxation).
* F-relaxation hands all intervals of a level to the application's
  ``step_chain`` (Heat2D: kernel K2 ``theta_chain``), or loops over the
  intra-interval position with a batched step.
* ``solve_compiled`` is a Python loop over device tensors that reads one
  scalar per iteration to decide whether to stop.
* With ``coarsest_prefix=True`` the coarsest level is not marched step by
  step: the application's ``affine_coeffs`` give every step as an
  elementwise affine map and kernel K8 ``affine_prefix`` computes all
  states in a chunked scan (``ops/prefix.py``).
* Spatial transfers keep the JAX contract (one state, vmapped over a
  tube's rows); a ``batched`` transfer with the fused hooks of
  ``core/grid_transfer.py`` computes the FAS right-hand side, the
  correction and nested iteration's interpolation in one pass each (the
  heat transfers: kernels K18 and K19).
* A level whose C-points are not evenly strided (non-uniform coarsening,
  ``LevelInfo.uniform`` False) takes the JAX package's index-based route:
  the ragged F-chains run through ``step_chain`` over the padded times of
  ``FChains`` into a scratch buffer, runs of adjacent C-points relax
  Gauss-Seidel within a run, and every gather, drop-scatter and weighted
  sum at the C-rows goes through kernel K21 ``indexed_combine`` with index
  tensors cached on the device at setup (``_RaggedLevel``).

* ``precision='dd'`` (the application's template is a ``DD`` pair of
  float32 tensors, ``ops/dd.py``): every tube is one packed float32 tensor
  (nt, 2, ...), hi then lo on axis 1, so row views, gathers and copies
  work unchanged; every time value a stepper sees is split exactly from
  float64 (the models split their own step times), and every combine, the
  weighted C-update, the FAS right-hand side, the correction and the
  residual difference go through kernel K25 ``dd_arith`` (the residual as
  the float32 value of the DD difference, reduced by K3), never K4.  The
  models' ``step_chain`` and ``relax_interval`` take packed views; their
  ``step`` / ``step_batched`` take and return ``DD`` pairs; transfers get
  ``DD`` pairs (a per-state transfer through ``torch.vmap``, on CPU
  tensors) and the fused transfer hooks are not used.

States are single tensors or DD pairs (no tuple states) in this port.  The
device mesh and the lazy level-0 F-relaxation are not ported and raise
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import logging
import sys
import time
from typing import Callable, List

import numpy as np
import torch

from pymgrit_tpu_torch.core import prng, vector
from pymgrit_tpu_torch.core.application import Application
from pymgrit_tpu_torch.core.grid_transfer import GridTransfer, GridTransferCopy
from pymgrit_tpu_torch.core.levels import LevelInfo, build_level_infos, validate_hierarchy
from pymgrit_tpu_torch.ops import DISPATCH
from pymgrit_tpu_torch.ops import dd as _dd


def hook_accepts_kwarg(hook, name: str) -> bool:
    """True iff `hook` declares `name` as an explicit keyword parameter."""
    try:
        sig = inspect.signature(hook)
    except (TypeError, ValueError):
        return False
    return name in sig.parameters


def _over_rows(transfer: GridTransfer, fn: Callable, ops) -> Callable:
    """A transfer method on a (rows, ...) batch: the method itself (given
    the solver's kernel set where it takes ``ops``) if the transfer declares
    ``batched = True``, else its vmap over the rows."""
    if not getattr(transfer, "batched", False):
        return torch.vmap(fn)
    return functools.partial(fn, ops=ops) if hook_accepts_kwarg(fn, "ops") else fn


def _owner(obj, name: str):
    """The instance or class whose own attributes hold ``name``."""
    if name in vars(obj):
        return obj
    return next((c for c in type(obj).__mro__ if name in vars(c)), None)


def _fused_hook(transfer: GridTransfer, hook: str, method: str):
    """A batched transfer's fused hook where the class that defines it also
    defines the method it fuses, else None (an override of the method alone
    must not be bypassed by an inherited hook)."""
    fn = getattr(transfer, hook, None)
    if fn is None or not getattr(transfer, "batched", False):
        return None
    return fn if _owner(transfer, hook) is _owner(transfer, method) else None


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(R, ...) tube rows as an (R, N) view (never a copy)."""
    return t.view(t.shape[0], -1)


@dataclasses.dataclass(frozen=True)
class _RaggedLevel:
    """Device index tensors and (L, J) step times of a non-uniform level:
    built once at setup, so that a solve copies no index array to the
    device.  Chain and run outputs are laid out (J, L) and (K, R), lane
    major; padded slots carry the index nt (dropped by K21)."""

    cpts: torch.Tensor          # (nc,) C-points
    ci: torch.Tensor            # (nc-1,) C-points but the first
    ci_prev: torch.Tensor       # (nc-1,) their predecessors
    t_ci_prev: np.ndarray       # (nc-1,) times of ci_prev and ci
    t_ci: np.ndarray
    f_seed: torch.Tensor        # (J,) C-point seeding each F-chain
    f_out: torch.Tensor         # (J*Lmax,) F-point of each chain slot, padded with nt
    f_g: torch.Tensor           # (J*Lmax,) the same, clipped to nt-1 (g gather)
    f_tp: np.ndarray            # (Lmax, J) chain step times
    f_tc: np.ndarray
    c_seed: torch.Tensor        # (K,) predecessor of each run of adjacent C-points
    c_out: torch.Tensor         # (K*Rmax,) C-point of each run slot, padded with nt
    c_old: torch.Tensor         # (K*Rmax,) the same, clipped (u_old and g gathers)
    c_tp: np.ndarray            # (Rmax, K) run step times
    c_tc: np.ndarray

    @classmethod
    def build(cls, info: LevelInfo, device) -> "_RaggedLevel":
        def idx(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64).reshape(-1),
                                   device=device)

        def times(a):
            return np.ascontiguousarray(np.asarray(a, dtype=np.float64).T)

        nt, ch, cc = info.nt, info.chains, info.c_chains
        ci = info.cpts[1:]
        return cls(cpts=idx(info.cpts), ci=idx(ci), ci_prev=idx(ci - 1),
                   t_ci_prev=info.t[ci - 1], t_ci=info.t[ci],
                   f_seed=idx(ch.seed), f_out=idx(ch.f_idx),
                   f_g=idx(np.minimum(ch.f_idx, nt - 1)), f_tp=times(ch.t_prev),
                   f_tc=times(ch.t_curr), c_seed=idx(cc.seed_prev), c_out=idx(cc.c_idx),
                   c_old=idx(np.minimum(cc.c_idx, nt - 1)), c_tp=times(cc.t_prev),
                   c_tc=times(cc.t_curr))


class Mgrit:
    """MGRIT solver; constructor parameters mirror ``pymgrit_tpu.Mgrit``."""

    def __init__(self, problem: List[Application], transfer: List[GridTransfer] = None,
                 weight_c: float = 1.0, max_iter: int = 100, tol: float = 1e-7,
                 nested_iteration: bool = True, cf_iter=1, cycle_type: str = 'V',
                 mesh=None, logging_lvl: int = logging.INFO, output_fcn=None,
                 output_lvl: int = 1, t_norm: int = 2, random_init_guess: bool = False,
                 conv_crit: int = 0, rng_seed: int = 0,
                 lazy_f_relax: bool = False, condensed: bool = True,
                 coarsest_prefix: bool = False) -> None:
        logging.basicConfig(format='%(levelname)s - %(asctime)s - %(message)s',
                            datefmt='%d-%m-%y %H:%M:%S', level=logging_lvl, stream=sys.stdout)

        if transfer is None:
            transfer = [GridTransferCopy() for _ in range(len(problem) - 1)]

        # ---- validation (messages mirror the JAX package) ----
        if len(problem) != (len(transfer) + 1):
            raise Exception('There should be exactly one transfer operator for each level except the coarsest grid')
        validate_hierarchy([p.t for p in problem])
        if cycle_type not in ('V', 'F'):
            raise Exception("Cycle-type " + str(cycle_type) + " is not implemented. Choose 'V' or 'F'")
        if output_lvl not in [0, 1, 2]:
            raise Exception("Unknown output level. Choose 0, 1 or 2.")
        if t_norm not in [1, 2, 3]:
            raise Exception('Unknown norm. Please choose 1 (one norm), 2 (two-norm) or 3 (inf-norm)')
        if conv_crit not in [0, 1, 2, 3]:
            raise Exception(
                'Unknown convergence criterion. Please choose: '
                '0 (global space-time residual), '
                '1 (global jump)'
                '2 (local space-time residual)'
                '3 (local jump)')
        if isinstance(cf_iter, int):
            cf_iter = [cf_iter for _ in range(len(problem))]
        elif isinstance(cf_iter, list):
            if len(cf_iter) < len(problem) - 1:
                raise Exception(
                    'Too few cf_iter. '
                    'Specify a list of values for all but the coarsest level or an integer (used for all levels).')
        else:
            raise Exception(
                'Incorrect datatype cf_iter. '
                'Specify a list of values for all but the coarsest level or an integer ( used for all levels).')
        if mesh is not None:
            raise NotImplementedError("mesh= (time-sharded execution) is not ported yet (ROADMAP A7)")
        if lazy_f_relax:
            raise NotImplementedError(
                "lazy_f_relax=True is not ported (ROADMAP: not to port; the condensed carry replaces it)")

        self.problem = problem
        self.transfer = transfer
        self.weight_c = weight_c
        self.lvl_max = len(problem)
        self.tol = tol
        self.cf_iter = cf_iter
        self.cycle_type = cycle_type
        self.random_init_guess = random_init_guess
        self.iter_max = max_iter
        self.nes_it = nested_iteration
        self.conv = np.zeros(max_iter + 1)
        self.conv_crit = conv_crit
        self.global_conv_crit = conv_crit in (0, 1)
        self.t_norm_ord = {1: 1, 2: 2, 3: float('inf')}[t_norm]
        self.output_lvl = output_lvl
        self.output_fcn = output_fcn if (output_fcn is not None and callable(output_fcn)) else None
        self.solve_iter = 0
        self.runtime_solve = 0.0
        self.runtime_setup = 0.0
        self.ops = getattr(problem[0], "ops", DISPATCH)
        # precision='dd': float32-pair states, packed tubes (see above)
        self._dd = vector.contains_dd(problem[0].vector_template)

        # ---- static level structure ----
        runtime_setup_start = time.time()
        self.log_info("Start setup")
        self.levels: List[LevelInfo] = build_level_infos([p.t for p in problem])
        self.m = [li.m for li in self.levels]
        # Warn on non-uniform coarsening (the JAX package's message)
        for lvl in range(self.lvl_max - 1):
            d = np.diff(self.levels[lvl].cpts)
            if d.size and not np.all(d == d[0]):
                logging.warning('Non-uniform coarsening between level ' + str(lvl) + ' and ' + str(lvl + 1) +
                                '. Poorly tested.')
        self.step_fns: List[Callable] = [p.step for p in problem]
        # ---- parallel-prefix coarsest solve (ops/prefix.py, kernel K8):
        # opt-in; it requires the coarsest application to expose
        # affine_coeffs(t0, t1) -> (A, b) with step(u) == A*u + b ----
        self._coarsest_prefix = bool(coarsest_prefix)
        if self._coarsest_prefix:
            if getattr(problem[-1], "affine_coeffs", None) is None:
                raise Exception(
                    "coarsest_prefix=True requires the coarsest-level "
                    "application to define affine_coeffs(t_start, t_stop) "
                    "-> (A, b) with step(u, t_start, t_stop) == A*u + b "
                    "(elementwise per state leaf); "
                    + type(problem[-1]).__name__ + " does not")
            logging.info("Coarsest level uses the parallel-prefix "
                         "(associative-scan) forward solve")
        # per-state transfers run over a tube's rows through torch.vmap (the
        # JAX solver's jax.vmap); a batched transfer is called as it is
        self.restrict_fns: List[Callable] = [self._transfer_fn(tr, tr.restriction)
                                             for tr in transfer]
        self.interp_fns: List[Callable] = [self._transfer_fn(tr, tr.interpolation)
                                           for tr in transfer]
        # fused transfer hooks (core/grid_transfer.py), None where absent
        # (and for DD states, which the float64 hooks do not take)
        self._restrict_hooks = [None if self._dd else
                                _fused_hook(tr, "restrict_combine", "restriction")
                                for tr in transfer]
        self._interp_hooks = [None if self._dd else
                              _fused_hook(tr, "interpolate_combine", "interpolation")
                              for tr in transfer]
        self._block_cache = {}

        # ---- condensed level-0 carry: keep only the level-0 C-points; every
        # F-row consumer (C-relaxation, FAS restriction, residual) reads the
        # closed-form step to the next C-point through the fine
        # application's relax_interval hook; the full tube is materialized
        # once after convergence.  Same decision and decline reasons as the
        # JAX package, logged as one INFO line. ----
        self._condensed0 = False
        custom_criteria = type(self).convergence_criterion is not Mgrit.convergence_criterion
        self._cnd_decline_reason = None
        if condensed and self.lvl_max > 1:
            if custom_criteria:
                self._cnd_decline_reason = (
                    "a custom convergence criterion reads the raw level-0 state "
                    "and needs the full fine tube")
            elif self.output_fcn is not None and output_lvl == 2:
                self._cnd_decline_reason = (
                    "output_lvl=2 hands the full level-0 tube to output_fcn "
                    "every iteration")
            elif not self.levels[0].uniform:
                self._cnd_decline_reason = (
                    "level-0 C-points are not uniformly spaced "
                    "(index-non-uniform coarsening)")
            elif self.levels[0].m <= 1:
                self._cnd_decline_reason = "level-0 coarsening factor is 1"
            elif getattr(problem[0], "relax_interval", None) is None:
                self._cnd_decline_reason = (
                    "the fine application provides no relax_interval hook")
            else:
                self._condensed0 = self._probe_condensed0()
            if not self._condensed0 and self._cnd_decline_reason is not None:
                self.log_info(
                    "MGRIT: condensed level-0 fast path DISABLED: "
                    + self._cnd_decline_reason
                    + " (full-tube executor used; see docs/performance.md)")
        self._nc_store0 = self.levels[0].cpts.size if self._condensed0 else 0

        # ---- allocate tubes (float64, or packed float32 pairs for DD, on
        # the device of the templates) ----
        self.u: List = []
        self.v: List = []
        self.g: List = []
        for lvl in range(self.lvl_max):
            nt = self._nc_store0 if (lvl == 0 and self._condensed0) else self.levels[lvl].nt
            template = self._state(problem[lvl].vector_template)
            if lvl == 0 and random_init_guess:
                # the JAX package's draw (threefry2x32 keys split per row)
                tube = prng.random_tube(rng_seed, nt, tuple(template.shape), template.device) \
                    if not self._dd else prng.random_dd_tube(rng_seed, nt, tuple(template.shape[1:]),
                                                             template.device)
            else:
                tube = vector.tube_of(template, nt)
            tube[0] = self._state(problem[lvl].vector_t_start)
            self.u.append(tube)
            self.v.append(None if lvl == 0 else torch.zeros_like(tube))
            self.g.append(None if lvl == 0 else torch.zeros_like(tube))
        self.device = self.u[0].device
        # index route of the levels whose C-points are not evenly strided
        self._ragged = [_RaggedLevel.build(self.levels[lvl], self.device)
                        if lvl < self.lvl_max - 1 and not self.levels[lvl].uniform else None
                        for lvl in range(self.lvl_max)]

        for lvl, p in enumerate(problem):
            p.prepare_runtime(self.levels[lvl])

        if nested_iteration:
            self._nested_iteration()

        self.save_values_last_iter = None
        if conv_crit in (1, 3):
            self.save_values_last_iter = self._c_points(self.u[0])

        self._all_below = False
        self.t = [li.t for li in self.levels]
        self.index_local = [np.arange(li.nt) for li in self.levels]

        self.runtime_setup = time.time() - runtime_setup_start
        if self.output_fcn is not None and self.output_lvl == 2:
            self.output_fcn(self)
        self.log_info(f"Setup took {self.runtime_setup} s")

    def log_info(self, message: str) -> None:
        logging.info(message)

    # ------------------------------------------------------------------
    # states: float64 tensors, or packed DD pairs
    # ------------------------------------------------------------------

    def _state(self, x) -> torch.Tensor:
        """An application's state as a tube row: float64, or a DD pair
        packed (2, ...) float32."""
        if self._dd:
            return torch.stack([x.hi, x.lo])
        return vector.as_f64(x)

    def _pair(self, t: torch.Tensor, axis: int = 1):
        """The DD view of packed tube rows (the solver's kernel set)."""
        return _dd.pair(t, self.ops, axis)

    def _transfer_fn(self, transfer: GridTransfer, fn: Callable) -> Callable:
        """A transfer method on tube rows; in DD the rows are handed over as
        a DD pair and the result packed again."""
        rows_fn = _over_rows(transfer, fn, self.ops)
        if not self._dd:
            return rows_fn
        return lambda rows: _dd.packed(rows_fn(self._pair(rows)))

    # ------------------------------------------------------------------
    # level-0 condensed structure
    # ------------------------------------------------------------------

    def _block_times(self, lvl: int, rows: int):
        """Cached (rows, J) intra-interval step times of a uniform level:
        rows = m-1 (F-relaxation sweep) or m (step to the next C-point)."""
        key = (lvl, rows)
        if key not in self._block_cache:
            info = self.levels[lvl]
            nt, m, t = info.nt, info.m, info.t
            J = (nt - 1) // m
            tp = np.stack([t[j * m:j * m + rows] for j in range(J)], 1)
            tc = np.stack([t[j * m + 1:j * m + rows + 1] for j in range(J)], 1)
            self._block_cache[key] = (tp, tc)
        return self._block_cache[key]

    def _cnd_block_times(self, rows: int):
        return self._block_times(0, rows)

    def _probe_condensed0(self) -> bool:
        """Check with a one-interval dummy seed that the level-0 hook
        accepts this grid (it declines for non-uniform dt, a
        time-dependent rhs or an unsupported method)."""
        info = self.levels[0]
        m, t = info.m, info.t
        if len(t) < m + 1:
            self._cnd_decline_reason = "level-0 grid shorter than one interval"
            return False
        dts = np.diff(np.asarray(t, dtype=np.float64))
        if not np.allclose(dts, dts[0], rtol=1e-12, atol=0.0):
            self._cnd_decline_reason = (
                "level-0 dt is not globally uniform to rtol=1e-12 "
                f"(max |dt - dt0|/dt0 = {float(np.max(np.abs(dts / dts[0] - 1.0))):.2e}); "
                "regenerate t_interval with np.linspace to recover the fast path")
            return False
        tp = t[0:m][:, None]
        tc = t[1:m + 1][:, None]
        seed = vector.tube_of(self._state(self.problem[0].vector_template), 1)
        hook = self.problem[0].relax_interval
        if not hook_accepts_kwarg(hook, "only_last"):
            self._cnd_decline_reason = (
                "relax_interval hook does not accept only_last=")
            return False
        if not hook_accepts_kwarg(hook, "out"):
            self._cnd_decline_reason = "relax_interval hook does not accept out="
            return False
        ys = hook(seed, tp, tc, only_last=True)
        if ys is None:
            self._cnd_decline_reason = (
                "relax_interval hook declined this configuration "
                "(time-dependent rhs, or unsupported precision/method "
                "for the closed form)")
            return False
        return True

    def _cnd_c_step(self, u_c):
        """Closed-form Phi^m of every owning C-seed (K1 with one table row):
        a fresh (nc-1, ...) tensor."""
        nc = self.levels[0].cpts.size
        tp, tc = self._cnd_block_times(self.levels[0].m)
        return self.problem[0].relax_interval(u_c[:nc - 1], tp, tc, only_last=True)[0]

    def _sync_condensed0(self) -> None:
        """Re-condense self.u[0] to its C-rows if a previous solve left it
        materialized (the C rows of the full tube ARE the state)."""
        if not self._condensed0 or self.u[0].shape[0] == self._nc_store0:
            return
        self.u[0] = self.u[0][0:self.levels[0].nt:self.levels[0].m].clone()

    def _cnd_materialize_expr(self, u_c):
        """Condensed C-rows -> full (nt, ...) level-0 tube.  K1 writes every
        F-row and copies every seed straight into the preallocated tube
        (no concat or transpose temporaries); the last row is the last
        C-point."""
        info = self.levels[0]
        m, nt = info.m, info.nt
        J = info.cpts.size - 1
        tp, tc = self._cnd_block_times(m - 1)
        out = torch.empty((nt,) + tuple(u_c.shape[1:]), dtype=u_c.dtype, device=u_c.device)
        blocks = out[:J * m].view((J, m) + tuple(u_c.shape[1:]))
        if self.problem[0].relax_interval(u_c[:J], tp, tc, out=blocks[:, 1:],
                                          seed_out=blocks[:, 0]) is None:
            raise RuntimeError("relax_interval declined the materialization it accepted at setup")
        out[nt - 1].copy_(u_c[J])
        return out

    def _materialize_condensed0(self) -> None:
        if self._condensed0 and self.u[0].shape[0] == self._nc_store0:
            self.u[0] = self._cnd_materialize_expr(self.u[0])

    # ------------------------------------------------------------------
    # batched steps and row views
    # ------------------------------------------------------------------

    def _vstep(self, lvl):
        """Batched one-step map: the application's step_batched, else a
        vmap of its step."""
        batched = getattr(self.problem[lvl], "step_batched", None)
        if batched is not None:
            return batched
        return torch.vmap(self.step_fns[lvl])

    def _chain(self, lvl, seed, tp, tc, out, g=None):
        """J chains of L steps: out[:, k] = [g[:, k] +] Phi(out[:, k-1]) with
        out[:, -1] = seed; tp, tc: (L, J) numpy times; out, g: (J, L, ...)
        views that must not overlap seed.  Uses the application's
        step_chain (Heat2D: kernel K2) when it has one."""
        chain = getattr(self.problem[lvl], "step_chain", None)
        if chain is not None:
            chain(seed, tp, tc, out, g)
            return
        vstep = self._vstep(lvl)
        x = seed
        for k in range(tp.shape[0]):
            if self._dd:
                y = vstep(self._pair(x), self._t(tp[k]), self._t(tc[k]))
                if g is not None:
                    y = _dd.add(self._pair(g[:, k]), y)
                out[:, k, 0].copy_(y.hi)
                out[:, k, 1].copy_(y.lo)
                x = out[:, k]
                continue
            x = vstep(x, self._t(tp[k]), self._t(tc[k]))
            if g is not None:
                x = g[:, k] + x
            out[:, k] = x

    def _t(self, a):
        """Step times on the device: float64, or split exactly into DD
        pairs (the JAX package's ``_as_t``)."""
        if self._dd:
            return _dd.from_f64(np.asarray(a, dtype=np.float64), self.device, self.ops)
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device)

    def _step_rows(self, lvl, prev, t_prev, t_curr):
        """One step of every row of prev: a fresh tensor."""
        out = torch.empty(prev.shape, dtype=prev.dtype, device=prev.device)
        self._chain(lvl, prev, np.asarray(t_prev)[None], np.asarray(t_curr)[None], out[:, None])
        return out

    def _gather(self, tube, idx):
        """Rows idx of a tube as a fresh contiguous tube (K21)."""
        out = torch.empty((idx.shape[0],) + tuple(tube.shape[1:]), dtype=tube.dtype,
                          device=tube.device)
        self.ops.indexed_combine(_rows(out), [_rows(tube)], [1.0], idx=[idx])
        return out

    def _scatter(self, tube, idx, rows):
        """tube[idx] = rows, dropping the slots whose index is the tube's
        length (K21)."""
        self.ops.indexed_combine(_rows(tube), [_rows(rows)], [1.0], io=idx)

    def _c_rows(self, lvl, tube):
        """View of the C-point rows 1..nc-1 of a level tube."""
        if lvl == 0 and self._condensed0:
            return tube[1:self._nc_store0]
        info = self.levels[lvl]
        return tube[info.m:info.nt:info.m]

    def _c_points(self, tube):
        """Copy of all level-0 C-point rows (every row on a single level)."""
        if self._condensed0:
            return tube.clone()
        if self._ragged[0] is not None:
            return self._gather(tube, self._ragged[0].cpts)
        info = self.levels[0]
        return tube[0:info.nt:info.m].clone()

    def _combine(self, out, terms, coeffs):
        """out = sum_k coeffs[k] * terms[k] over row views (kernel K4; in DD
        the left-to-right DD sum, kernel K25)."""
        if self._dd:
            self.ops.dd_arith("combine", *[self._pair(t) for t in terms], coeffs=coeffs,
                              out=self._pair(out))
            return
        self.ops.cpoint_combine(_rows(out), [_rows(t) for t in terms], coeffs)

    def _icombine(self, out, terms, coeffs, io=None, idx=()):
        """out[io] = sum_k coeffs[k] * terms[k][idx[k]] over tube rows (K21;
        in DD the rows are gathered, combined by K25 and scattered)."""
        if not self._dd:
            self.ops.indexed_combine(_rows(out), [_rows(t) for t in terms], coeffs, io=io, idx=idx)
            return
        idx = list(idx) + [None] * (len(terms) - len(idx))
        rows = [t if i is None else self._gather(t, i) for t, i in zip(terms, idx)]
        if io is None:
            self._combine(out, rows, coeffs)
            return
        res = torch.empty(rows[0].shape, dtype=out.dtype, device=out.device)
        self._combine(res, rows, coeffs)
        self._scatter(out, io, res)

    def _row_norms(self, a, b):
        """Per-row 2-norm of a - b over two tube views (K3; in DD of the
        float32 value of the DD difference, which K25 writes)."""
        if not self._dd:
            return self.ops.residual_row_norms(_rows(a), _rows(b))
        diff = torch.empty((a.shape[0],) + tuple(a.shape[2:]), dtype=a.dtype, device=a.device)
        self.ops.dd_arith("resid", self._pair(a), self._pair(b), out=diff)
        d = _rows(diff)
        zero = torch.zeros(d.shape[1], dtype=d.dtype, device=d.device).expand(d.shape)
        return self.ops.residual_row_norms(d, zero)

    def _weighted_into(self, dst, stepped):
        """dst <- w*stepped + (1-w)*dst (weighted-Jacobi C update)."""
        if self.weight_c == 1.0:
            dst.copy_(stepped)
        else:
            self._combine(dst, [stepped, dst], [self.weight_c, 1.0 - self.weight_c])

    # ------------------------------------------------------------------
    # relaxation, FAS, correction (in place on self.u / v / g)
    # ------------------------------------------------------------------

    def _f_relax(self, lvl, u, g):
        """All F-intervals of a level relax at once (sequential within an
        interval)."""
        if lvl == 0 and self._condensed0:
            return u          # F-rows are implicit functions of the C-seeds
        info = self.levels[lvl]
        if info.chains is None or info.chains.lmax == 0:
            return u
        if self._ragged[lvl] is not None:
            return self._f_relax_ragged(lvl, u, g)
        return self._f_relax_uniform(lvl, u, g)

    def _f_relax_ragged(self, lvl, u, g):
        """The ragged F-chains of a non-uniform level: every chain steps
        through the padded (Lmax, J) times into a (J, Lmax) scratch buffer
        (the g rows gathered first on a coarse level); the valid slots are
        scattered to their F-points and the padding, which lies after each
        chain's last valid step, is dropped (JAX's masked carry)."""
        rg, ch = self._ragged[lvl], self.levels[lvl].chains
        J, L = ch.seed.size, ch.lmax
        out = torch.empty((J, L) + tuple(u.shape[1:]), dtype=u.dtype, device=u.device)
        gb = self._gather(g, rg.f_g).view(out.shape) if lvl > 0 else None
        self._chain(lvl, self._gather(u, rg.f_seed), rg.f_tp, rg.f_tc, out, gb)
        self._scatter(u, rg.f_out, out.view((J * L,) + tuple(u.shape[1:])))
        return u

    def _f_relax_uniform(self, lvl, u, g):
        info = self.levels[lvl]
        nt, m = info.nt, info.m
        J = (nt - 1) // m
        shape = (J, m) + tuple(u.shape[1:])
        x = u[0:nt - 1:m]                                  # owning C-points
        tp, tc = self._block_times(lvl, m - 1)
        out = u[1:nt].view(shape)[:, :m - 1]               # the F-rows
        if lvl == 0:
            hook = getattr(self.problem[0], "relax_interval", None)
            if hook is not None and hook_accepts_kwarg(hook, "out") \
                    and hook(x, tp, tc, out=out) is not None:
                return u
            self._chain(0, x, tp, tc, out)
            return u
        self._chain(lvl, x, tp, tc, out, g[1:nt].view(shape)[:, :m - 1])
        return u

    def _c_relax(self, lvl, u, g):
        """Weighted C-relaxation.  Jacobi: the new C values are computed
        into a fresh buffer before they are written."""
        if lvl == 0 and self._condensed0:
            self._weighted_into(u[1:self._nc_store0], self._cnd_c_step(u))
            return u
        if self._ragged[lvl] is not None:
            return self._c_relax_ragged(lvl, u, g)
        info = self.levels[lvl]
        nt, m, t = info.nt, info.m, info.t
        prev = u[m - 1:nt - 1:m]
        stepped = torch.empty(prev.shape, dtype=u.dtype, device=u.device)
        self._chain(lvl, prev, t[m - 1:nt - 1:m][None], t[m:nt:m][None], stepped[:, None],
                    g[m:nt:m][:, None] if lvl > 0 else None)
        self._weighted_into(u[m:nt:m], stepped)
        return u

    def _c_relax_ragged(self, lvl, u, g):
        """C-relaxation of a non-uniform level.  Runs of adjacent C-points
        relax Gauss-Seidel within a run (each point from the run's freshly
        relaxed predecessor), distinct runs at once; the seeds, the g rows
        and the u_old of the weighted update are read from the tube before
        any write, and the new values are scattered once at the end.  With
        no adjacent C-points this is one batched step (JAX's rmax == 1)."""
        rg, cc = self._ragged[lvl], self.levels[lvl].c_chains
        if cc is None or cc.c_idx.size == 0:
            return u
        w = self.weight_c
        if cc.rmax == 1:
            stepped = torch.empty((rg.ci.shape[0],) + tuple(u.shape[1:]), dtype=u.dtype,
                                  device=u.device)
            self._chain(lvl, self._gather(u, rg.ci_prev), rg.t_ci_prev[None], rg.t_ci[None],
                        stepped[:, None], self._gather(g, rg.ci)[:, None] if lvl > 0 else None)
            if w == 1.0:
                self._scatter(u, rg.ci, stepped)
            else:
                self._icombine(u, [stepped, u], [w, 1.0 - w], io=rg.ci, idx=[None, rg.ci])
            return u
        K, R = cc.c_idx.shape
        shape = tuple(u.shape[1:])
        ys = torch.empty((K, R) + shape, dtype=u.dtype, device=u.device)
        gb = self._gather(g, rg.c_old).view(ys.shape) if lvl > 0 else None
        x = self._gather(u, rg.c_seed)
        if w == 1.0:
            self._chain(lvl, x, rg.c_tp, rg.c_tc, ys, gb)
        else:
            u_old = self._gather(u, rg.c_old).view((K, R) + shape)
            for k in range(R):
                self._chain(lvl, x, rg.c_tp[k:k + 1], rg.c_tc[k:k + 1], ys[:, k:k + 1],
                            None if gb is None else gb[:, k:k + 1])
                x = ys[:, k]
                self._combine(x, [x, u_old[:, k]], [w, 1.0 - w])
        self._scatter(u, rg.c_out, ys.view((K * R,) + shape))
        return u

    def _affine_rows(self, lvl, shape):
        """The coarsest application's affine steps t[i-1] -> t[i] as two
        (nt-1, N) row views (row stride 0 where the application broadcasts
        one row)."""
        t = self.levels[lvl].t
        A, b = self.problem[lvl].affine_coeffs(t[:-1], t[1:])
        return tuple(torch.broadcast_to(x, shape).reshape(shape[0], -1) for x in (A, b))

    def _forward_solve(self, lvl, u, g):
        """Time stepping on the coarsest level: one sequential chain, or all
        states at once by the parallel-prefix scan (kernel K8)."""
        info = self.levels[lvl]
        nt, t = info.nt, info.t
        if nt <= 1:
            return u
        if self._coarsest_prefix and lvl == self.lvl_max - 1:
            A, b = self._affine_rows(lvl, u[1:nt].shape)
            rows = _rows(u)
            self.ops.affine_prefix(A, b, rows[0], rows[1:nt],
                                   _rows(g)[1:nt] if lvl > 0 else None)
            return u
        self._chain(lvl, u[0:1], t[:-1][:, None], t[1:][:, None], u[1:nt][None],
                    g[1:nt][None] if lvl > 0 else None)
        return u

    def _fas_residual(self, lvl):
        """Restriction + FAS right-hand side into u, v, g of level lvl+1."""
        info = self.levels[lvl]
        nc = info.cpts.size
        nt, m, t_f = info.nt, info.m, info.t
        t_c = self.levels[lvl + 1].t
        u_f, g_f = self.u[lvl], self.g[lvl]
        u_c, v_c, g_c = self.u[lvl + 1], self.v[lvl + 1], self.g[lvl + 1]
        restrict = self.restrict_fns[lvl]
        fused = self._restrict_hooks[lvl]
        rg = self._ragged[lvl]

        if rg is not None:
            # C-rows gathered into contiguous tubes (K21), which the fused
            # hook and the transfer take as they take strided views
            u_at_c = self._gather(u_f, rg.cpts)
            u_c.copy_(restrict(u_at_c))
            stepped_f = self._step_rows(lvl, self._gather(u_f, rg.ci_prev), rg.t_ci_prev,
                                        rg.t_ci)
            u_ci = u_at_c[1:]
        else:
            u_c.copy_(restrict(u_f[:nc] if lvl == 0 and self._condensed0 else u_f[0:nt:m]))
            if lvl == 0 and self._condensed0:
                stepped_f = self._cnd_c_step(u_f)
            else:
                stepped_f = self._step_rows(lvl, u_f[m - 1:nt - 1:m], t_f[m - 1:nt - 1:m],
                                            t_f[m:nt:m])
            u_ci = self._c_rows(lvl, u_f)
        # the saved FAS iterate is a copy: the coarse cycle updates u_c in place
        v_c.copy_(u_c)
        if fused is not None:
            # g_c[1:] = R(inner) + (v_c[1:] - Phi_c(v_c[:-1])) in one pass, with
            # inner = Phi(u_f[cm-1]) - u_f[cm] (level 0) or
            # (g_f[cm] - u_f[cm]) + Phi(u_f[cm-1])
            stepped_c = self._step_rows(lvl + 1, v_c[:nc - 1], t_c[:-1], t_c[1:])
            g_ci = None if lvl == 0 else (self._gather(g_f, rg.ci) if rg is not None
                                          else self._c_rows(lvl, g_f))
            terms, coeffs = (([stepped_f, u_ci], [1.0, -1.0]) if lvl == 0 else
                             ([g_ci, u_ci, stepped_f], [1.0, -1.0, 1.0]))
            fused(g_c[1:nc], terms, coeffs, [v_c[1:nc], stepped_c], [1.0, -1.0], ops=self.ops)
            return
        if lvl == 0:
            self._combine(stepped_f, [stepped_f, u_ci], [1.0, -1.0])
        elif rg is not None:
            # inner = (g_f[ci] - u_f[ci]) + Phi(u_f[ci-1]), g read at its C-rows
            self._icombine(stepped_f, [g_f, u_ci, stepped_f], [1.0, -1.0, 1.0], idx=[rg.ci])
        else:
            self._combine(stepped_f, [self._c_rows(lvl, g_f), u_ci, stepped_f], [1.0, -1.0, 1.0])
        r = restrict(stepped_f).contiguous()      # K4 takes rows with a contiguous last axis
        stepped_c = self._step_rows(lvl + 1, v_c[:nc - 1], t_c[:-1], t_c[1:])
        # g_c[1:] = r + (v_c[1:] - Phi_c(v_c[:-1])); g_c[0] is never written
        self._combine(g_c[1:nc], [v_c[1:nc], stepped_c, r], [1.0, -1.0, 1.0])

    def _error_correction(self, lvl):
        """Coarse-grid correction at the C-points: u_f += P(u_c - v_c)."""
        nc = self.levels[lvl].cpts.size
        if nc <= 1:
            return
        u_c, v_c = self.u[lvl + 1], self.v[lvl + 1]
        fused = self._interp_hooks[lvl]
        rg = self._ragged[lvl]
        if fused is not None and rg is None:
            fused(self._c_rows(lvl, self.u[lvl]), u_c[1:nc], v_c[1:nc], ops=self.ops)
            return
        diff = torch.empty(u_c[1:nc].shape, dtype=u_c.dtype, device=u_c.device)
        self._combine(diff, [u_c[1:nc], v_c[1:nc]], [1.0, -1.0])
        if rg is not None:
            # u_f[ci] = u_f[ci] + P(diff), an indexed add (K21)
            u_f = self.u[lvl]
            self._icombine(u_f, [u_f, self.interp_fns[lvl](diff).contiguous()], [1.0, 1.0],
                           io=rg.ci, idx=[rg.ci])
            return
        dst = self._c_rows(lvl, self.u[lvl])
        self._combine(dst, [dst, self.interp_fns[lvl](diff).contiguous()], [1.0, 1.0])

    # ------------------------------------------------------------------
    # cycles
    # ------------------------------------------------------------------

    def _cycle(self, lvl, cycle_type, first_f, lvl0_first_f):
        """One recursive MGRIT cycle."""
        u, g = self.u, self.g
        if lvl == self.lvl_max - 1:
            self._forward_solve(lvl, u[lvl], g[lvl])
            return
        if (lvl > 0 or lvl0_first_f) and first_f:
            self._f_relax(lvl, u[lvl], g[lvl])
        for _ in range(self.cf_iter[lvl]):
            self._c_relax(lvl, u[lvl], g[lvl])
            self._f_relax(lvl, u[lvl], g[lvl])
        self._fas_residual(lvl)
        self._cycle(lvl + 1, cycle_type, True, lvl0_first_f)
        self._error_correction(lvl)
        self._f_relax(lvl, u[lvl], g[lvl])
        if lvl != 0 and cycle_type == 'F':
            self._cycle(lvl, 'V', False, lvl0_first_f)

    def _iteration(self, lvl0_first_f):
        self._cycle(0, self.cycle_type, True, lvl0_first_f)

    def _nested_iteration(self):
        """Nested iteration initialization: coarsest forward solve, then
        interpolate upward with a V-cycle on every intermediate level."""
        top = self.lvl_max - 1
        self._forward_solve(top, self.u[top], self.g[top])
        for lvl in range(self.lvl_max - 2, -1, -1):
            nc = self.levels[lvl].cpts.size
            coarse = self.u[lvl + 1][1:nc]
            fused = self._interp_hooks[lvl]
            if self._ragged[lvl] is not None:
                self._scatter(self.u[lvl], self._ragged[lvl].ci,
                              self.interp_fns[lvl](coarse).contiguous())
            elif fused is not None:
                fused(self._c_rows(lvl, self.u[lvl]), coarse, ops=self.ops)
            else:
                self._c_rows(lvl, self.u[lvl]).copy_(self.interp_fns[lvl](coarse))
            if lvl > 0:
                self._cycle(lvl, 'V', True, True)

    # ------------------------------------------------------------------
    # convergence criteria
    # ------------------------------------------------------------------

    def _point_residual_norms(self, u0):
        """Per-C-point 2-norm of Phi(u_{c-1}) - u_c (kernel K3)."""
        rg = self._ragged[0]
        if self._condensed0:
            stepped = self._cnd_c_step(u0)
        elif rg is not None:
            stepped = self._step_rows(0, self._gather(u0, rg.ci_prev), rg.t_ci_prev, rg.t_ci)
            return self._row_norms(stepped, self._gather(u0, rg.ci))
        else:
            info = self.levels[0]
            nt, m, t = info.nt, info.m, info.t
            stepped = self._step_rows(0, u0[m - 1:nt - 1:m], t[m - 1:nt - 1:m], t[m:nt:m])
        return self._row_norms(stepped, self._c_rows(0, u0))

    def _reduce(self, norms):
        conv = torch.linalg.vector_norm(norms, ord=self.t_norm_ord)
        return conv, torch.all(norms < self.tol)

    def _residual_conv_fn(self):
        return self._reduce(self._point_residual_norms(self.u[0]))

    def _jump_conv_fn(self, u_save):
        u_c = self._c_points(self.u[0])
        norms = self._row_norms(u_c[1:], u_save[1:])
        conv, all_below = self._reduce(norms)
        return conv, all_below, u_c

    # ------------------------------------------------------------------
    # solve loops
    # ------------------------------------------------------------------

    def convergence_criterion(self, iteration: int) -> None:
        """Compute self.conv[iteration].  Overridable."""
        if self.conv_crit in (0, 2):
            conv, all_below = self._residual_conv_fn()
        else:
            conv, all_below, self.save_values_last_iter = self._jump_conv_fn(
                self.save_values_last_iter)
        self.conv[iteration] = float(conv)
        self._all_below = bool(all_below)

    def solve(self) -> dict:
        self.log_info("Start solve")
        self._sync_condensed0()
        runtime_solve_start = time.time()
        for iteration in range(self.iter_max):
            self.solve_iter = iteration + 1
            time_it_start = time.time()
            self._iteration(lvl0_first_f=iteration == 0)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            time_it_stop = time.time()

            self.convergence_criterion(iteration + 1)

            if iteration == 0:
                self.log_info('{0: <7}'.format(f"iter {iteration + 1}") +
                              '{0: <32}'.format(f" | conv: {self.conv[iteration + 1]}") +
                              '{0: <37}'.format(" | conv factor: -") +
                              '{0: <35}'.format(f" | runtime: {time_it_stop - time_it_start} s"))
            else:
                self.log_info('{0: <7}'.format(f"iter {iteration + 1}") +
                              '{0: <32}'.format(f" | conv: {self.conv[iteration + 1]}") +
                              '{0: <37}'.format(
                                  f" | conv factor: {self.conv[iteration + 1] / self.conv[iteration]}") +
                              '{0: <35}'.format(f" | runtime: {time_it_stop - time_it_start} s"))

            if self.output_fcn is not None and self.output_lvl == 2:
                self.output_fcn(self)

            if self.global_conv_crit:
                if self.conv[iteration + 1] < self.tol or iteration == self.iter_max - 1:
                    break
            else:
                if self._all_below or iteration == self.iter_max - 1:
                    break

        self._materialize_condensed0()
        self.runtime_solve = time.time() - runtime_solve_start
        self.log_info(f"Solve took {self.runtime_solve} s")
        if self.output_fcn is not None and self.output_lvl == 1:
            self.output_fcn(self)
        self.ouput_run_information()
        return {'conv': self.conv[np.where(self.conv != 0)], 'time_setup': self.runtime_setup,
                'time_solve': self.runtime_solve}

    def solve_compiled(self) -> dict:
        """Solve with the iteration loop kept on the device: the history
        stays in device tensors and the loop reads one scalar (the stop
        flag) per iteration."""
        self.log_info("Start solve (compiled loop)")
        self._sync_condensed0()
        use_jump = self.conv_crit in (1, 3)
        u_save = self.save_values_last_iter
        runtime_solve_start = time.time()
        hist = []
        for it in range(self.iter_max):
            if it == 0:
                self._f_relax(0, self.u[0], self.g[0])
            self._iteration(lvl0_first_f=False)
            if use_jump:
                conv, all_below, u_save = self._jump_conv_fn(u_save)
            else:
                conv, all_below = self._residual_conv_fn()
            hist.append(conv)
            done = conv < self.tol if self.global_conv_crit else all_below
            if bool(done):
                break
        self._materialize_condensed0()
        hist = torch.stack(hist).cpu().numpy()
        it = hist.shape[0]
        if use_jump:
            self.save_values_last_iter = u_save
        self.conv = np.zeros(self.iter_max + 1)
        self.conv[1:it + 1] = hist
        self.solve_iter = it
        self.runtime_solve = time.time() - runtime_solve_start
        for k in range(it):
            self.log_info('{0: <7}'.format(f"iter {k + 1}") +
                          '{0: <32}'.format(f" | conv: {hist[k]}"))
        self.log_info(f"Solve took {self.runtime_solve} s")
        if self.output_fcn is not None and self.output_lvl in (1, 2):
            self.output_fcn(self)
        self.ouput_run_information()
        return {'conv': self.conv[np.where(self.conv != 0)], 'time_setup': self.runtime_setup,
                'time_solve': self.runtime_solve}

    # ------------------------------------------------------------------
    # checkpoint / resume: the JAX package's .npz layout (leaves u[0..L-1],
    # v[1..L-1], g[1..L-1], then conv and solve_iter)
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Save all level tubes + convergence history to an .npz file (a DD
        tube as two leaves, hi then lo, as the JAX package flattens it)."""
        leaves = [x for t in self.u + self.v[1:] + self.g[1:]
                  for x in ((t[:, 0], t[:, 1]) if self._dd else (t,))]
        arrays = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)}
        arrays["conv"] = self.conv
        arrays["solve_iter"] = np.asarray(self.solve_iter)
        np.savez(path, **arrays)

    def load_checkpoint(self, path: str) -> None:
        """Restore solver state saved by save_checkpoint (either package)."""
        from pymgrit_tpu_torch.interop import state_from_numpy
        with np.load(path) as data:
            n = sum(1 for key in data.files if key.startswith("leaf_"))
            state_from_numpy(self, [data[f"leaf_{i}"] for i in range(n)])
            self.conv = data["conv"]
            self.solve_iter = int(data["solve_iter"])

    # ------------------------------------------------------------------
    # reporting (the reference's spelling: ouput_run_information)
    # ------------------------------------------------------------------

    def ouput_run_information(self) -> None:
        msg = ['Run parameter overview',
               '  ' + '{0: <25}'.format('time interval') + ' : ' + '[' + str(self.problem[0].t[0]) + ', ' + str(
                   self.problem[0].t[-1]) + ']',
               '  ' + '{0: <25}'.format('number of time points ') + ' : ' + str(len(self.problem[0].t)),
               '  ' + '{0: <25}'.format('max dt ') + ' : ' + str(
                   np.max(self.problem[0].t[1:] - self.problem[0].t[:-1])),
               '  ' + '{0: <25}'.format('number of levels') + ' : ' + str(self.lvl_max),
               '  ' + '{0: <25}'.format('coarsening factors') + ' : ' + str(self.m[:-1]),
               '  ' + '{0: <25}'.format('relaxation weight') + ' : ' + str(self.weight_c),
               '  ' + '{0: <25}'.format('cf_iter') + ' : ' + str(self.cf_iter[:self.lvl_max - 1]),
               '  ' + '{0: <25}'.format('nested iteration') + ' : ' + str(self.nes_it),
               '  ' + '{0: <25}'.format('cycle type') + ' : ' + str(self.cycle_type),
               '  ' + '{0: <25}'.format('stopping tolerance') + ' : ' + str(self.tol),
               '  ' + '{0: <25}'.format('convergence criterion') + ' : ' + str(self.conv_crit)]
        self.log_info(message='\n'.join(msg))
