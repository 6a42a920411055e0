"""Machine-specific MGRIT solvers.

Counterpart of ``pymgrit_tpu/models/induction_machine/solvers.py``:

* reference src/pymgrit/induction_machine/mgrit_machine.py:11-52 --
  ``MgritMachine``: nested iteration runs with the sinusoidal voltage source
  (PWM flag temporarily disabled) so the coarse initialization is smooth.
* reference src/pymgrit/induction_machine/mgrit_machine_conv_jl.py:14-147 --
  ``MgritMachineConvJl``: joule-loss relative-change convergence criterion
  (98-118), in ``solve`` and, as ``compiled_convergence_criterion`` with the
  previous C-point joule losses as a device tensor, in ``solve_compiled``;
  optional F-relaxation post-processing after convergence (119-147).

The reference's ``f_exchange``/``c_exchange`` calls are stale against its
own core API and are not replicated.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from pymgrit_tpu_torch.core.solver import Mgrit


class MgritMachine(Mgrit):
    """MGRIT with sin-source nested iteration for PWM machine problems
    (reference mgrit_machine.py:22-52: fopt[-1] = 0 during nested iteration,
    restored afterwards)."""

    def _nested_iteration(self):
        change = False
        tmp_pwm = np.zeros(len(self.problem))
        if getattr(self.problem[0], 'pwm', 0):
            change = True
            for lvl in range(len(self.problem)):
                tmp_pwm[lvl] = self.problem[lvl].pwm
                self.problem[lvl].fopt[-1] = 0
        super()._nested_iteration()
        # the GetDP steps read fopt when they run: let every queued
        # nested-iteration step finish before the PWM flag comes back
        self._sync_device()
        if change:
            for lvl in range(len(self.problem)):
                self.problem[lvl].fopt[-1] = tmp_pwm[lvl]


class MgritMachineConvJl(Mgrit):
    """MGRIT with joule-loss convergence criterion and optional final
    F-relaxation post-processing."""

    def __init__(self, compute_f_after_convergence: bool = True, *args, **kwargs):
        self.compute_f_after_convergence = compute_f_after_convergence
        self.last_it = np.array([])
        super().__init__(*args, **kwargs)
        self._cpts = torch.as_tensor(self.levels[0].cpts, device=self.device)
        self.last_it = np.zeros(len(self.levels[0].cpts))
        self.convergence_criterion(0)

    def convergence_criterion(self, iteration: int) -> None:
        """Relative change of the joule losses at C-points in percent
        (reference mgrit_machine_conv_jl.py:98-118)."""
        cpts = self.levels[0].cpts
        if len(self.last_it) != len(cpts):
            self.last_it = np.zeros(len(cpts))
        # scalars leaf ordering: [jl, ia, ib, ic, ua, ub, uc, tr]
        new = self.u[0]["scalars"][self._cpts, 0].cpu().numpy()
        tmp = 100 * np.max(
            np.abs(np.abs(np.divide((new - self.last_it), new,
                                    out=np.zeros_like(self.last_it),
                                    where=new != 0))))
        self.conv[iteration] = tmp
        self._all_below = bool(tmp < self.tol)
        self.last_it = np.copy(new)

    def compiled_convergence_criterion(self, state, aux):
        """The joule-loss criterion on the device for ``solve_compiled``:
        aux holds the previous iterate's C-point joule losses."""
        new = state[0][0]["scalars"][self._cpts, 0]
        rel = torch.where(new != 0, torch.abs((new - aux) / new), 0.0)
        conv = 100.0 * torch.max(torch.abs(rel))
        return conv, conv < self.tol, new

    def compiled_conv_aux_init(self):
        # post-setup joule losses (convergence_criterion(0) in __init__
        # stored them in last_it), matching the eager solve()'s baseline
        return torch.as_tensor(self.last_it, dtype=torch.float64, device=self.device)

    def _post_process(self) -> None:
        """Recompute all level-0 F-points once (reference
        mgrit_machine_conv_jl.py:119-147)."""
        if self.compute_f_after_convergence:
            logging.info("Start post-processing: F-relax")
            runtime_pp_start = time.time()
            self._f_relax(0, self._u[0], self._g[0])
            logging.info(f"Post-processing took {time.time() - runtime_pp_start} s")

    def solve_compiled(self) -> dict:
        """Device-loop solve with the joule-loss criterion inline; applies
        the same optional F-relax post-processing as solve()."""
        conv0 = self.conv[0] if len(self.conv) else 0.0
        tmp_output_fcn = self.output_fcn
        self.output_fcn = None
        super().solve_compiled()
        self.output_fcn = tmp_output_fcn
        self.conv[0] = conv0                      # keep the setup baseline
        self.last_it = self._compiled_conv_aux.cpu().numpy()
        self._post_process()
        if self.output_fcn is not None:
            self.output_fcn(self)
        return {'conv': self.conv[np.where(self.conv != 0)],
                'time_setup': self.runtime_setup, 'time_solve': self.runtime_solve}

    def solve(self) -> dict:
        """Solve, then optionally recompute all F-points once."""
        tmp_output_fcn = self.output_fcn
        self.output_fcn = None
        super().solve()
        self.output_fcn = tmp_output_fcn
        self._post_process()
        self.last_it = np.zeros_like(self.last_it)
        if self.output_fcn is not None:
            self.output_fcn(self)
        return {'conv': self.conv[np.where(self.conv != 0)],
                'time_setup': self.runtime_setup, 'time_solve': self.runtime_solve}
