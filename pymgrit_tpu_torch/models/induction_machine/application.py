"""Induction machine application: GetDP FEM binary driven as a black-box Phi.

Counterpart of ``pymgrit_tpu/models/induction_machine/application.py``
(reference src/pymgrit/induction_machine/induction_machine.py:20-195): the
stepper writes a .res seed file, runs the GetDP binary twice
(preprocessing, then a -restart solve) in a temporary directory, and reads
back the DOF vector plus the 8 scalar outputs from the resolution and
result files.

The GetDP round trip runs on the host through ``coupling/callback.py``:
``step_batched`` copies a batch of states to the host once, runs one round
trip per lane in lane order (the JAX package's
``vmap_method='sequential'``) and copies the results back once.  Requires
the GetDP binary and the im_3kW model data; raises at construction when
absent (reference induction_machine.py:44-49, 68-70).
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from subprocess import PIPE
from typing import Dict

import numpy as np

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.coupling.callback import host_lanes, host_one
from pymgrit_tpu_torch.models.induction_machine.io_getdp import (
    get_preresolution, get_values_from, getdp_read_resolution, pre_file,
    set_resolution)
from pymgrit_tpu_torch.models.induction_machine.machine_state import (
    SCALARS, MachineState, machine_norm, zero_state)


def _is_numeric(obj) -> bool:
    try:
        obj + 0
        return True
    except TypeError:
        return False


class InductionMachine(Application):
    """im_3kW induction machine via the external GetDP binary.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    solver's states; every GetDP round trip runs on the host."""

    def __init__(self, grid: str, path_im3kw: str, path_getdp: str,
                 imposed_speed: int = 1, nb_trelax: int = 2, analysis_type: int = 1,
                 nb_max_iter: int = 60, relaxation_factor: float = 0.5,
                 stop_criterion: float = 1e-6, nonlinear: bool = False,
                 pwm: bool = False, pro_file: str = 'im_3kW.pro',
                 verbose: bool = False, steps_per_solve: int = 1, *args, device=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.device = model_device(device)
        self.pro_path = path_im3kw + pro_file
        if not os.path.isfile(self.pro_path):
            raise Exception('Found no valid .pro file in', self.pro_path)
        self.getdp_path = path_getdp
        if not os.path.isfile(self.getdp_path):
            raise Exception('Getdp not found (http://getdp.info/)')

        self.nl = int(nonlinear)
        self.pwm = int(pwm)
        self.mesh = grid + '.msh'
        self.pre = grid + '.pre'
        self.further_unknowns_front = 8
        self.further_unknowns_back = 15
        self.steps_per_solve = steps_per_solve

        cor_to_un, un_to_cor, boundary = pre_file(path_im3kw + self.pre)
        self.middle_size = len(un_to_cor)
        self.nx = self.middle_size + self.further_unknowns_front + self.further_unknowns_back

        self.gopt = {'Verbose': int(verbose),
                     'TimeStep': (self.t[1] - self.t[0]) / self.steps_per_solve,
                     'Executable': self.getdp_path, 'PreProcessing': '#1'}
        self.fopt = ['Flag_AnalysisType', analysis_type, 'Flag_NL', self.nl,
                     'Flag_ImposedSpeed', imposed_speed, 'Nb_max_iter', nb_max_iter,
                     'relaxation_factor', relaxation_factor, 'stop_criterion',
                     stop_criterion, 'NbTrelax', nb_trelax, 'Flag_PWM', self.pwm]

        version_test = subprocess.run([self.getdp_path, '--version'], stdout=PIPE, stderr=PIPE)
        if version_test.returncode:
            raise Exception('getdp not found.')

        self.vector_template = zero_state(self.further_unknowns_front,
                                          self.middle_size,
                                          self.further_unknowns_back, self.device)
        self.vector_t_start = zero_state(self.further_unknowns_front,
                                         self.middle_size,
                                         self.further_unknowns_back, self.device)
        self.state_norm = machine_norm

    # ------------------------------------------------------------------

    def _host(self, u, t_start: float, t_stop: float):
        """One GetDP round trip on a host state (numpy leaves)."""
        flat = np.concatenate([np.asarray(u["front"]), np.asarray(u["middle"]),
                               np.asarray(u["back"])])
        soli = self.run_getdp(u_start=flat, t_start=t_start, t_stop=t_stop)
        y = soli['y'][-1]
        scalars = np.array([soli[k][-1] for k in SCALARS])
        return MachineState(y[:self.further_unknowns_front],
                            y[self.further_unknowns_front:-self.further_unknowns_back],
                            y[-self.further_unknowns_back:], scalars)

    def step(self, u_start, t_start, t_stop):
        return host_one(self._host, u_start, t_start, t_stop)

    def step_batched(self, u_start, t_start, t_stop):
        return host_lanes(self._host, u_start, t_start, t_stop)

    def run_getdp(self, u_start: np.ndarray, t_start: float, t_stop: float) -> Dict:
        """GetDP round-trip (reference induction_machine.py:96-195)."""
        if np.max(np.isnan(u_start)):
            raise Exception('Approximation contains nan')

        fdir, file = os.path.split(self.pro_path)
        fname, _ = os.path.splitext(file)

        funargs = []
        for i in range(0, len(self.fopt), 2):
            flag = '-setnumber' if _is_numeric(self.fopt[i + 1]) else '-setstring'
            funargs += [flag, str(self.fopt[i]), str(self.fopt[i + 1])]

        mshfile = os.path.join(fdir, self.mesh)
        with tempfile.TemporaryDirectory() as tmpdir:
            tmp_name = os.path.join(tmpdir, fname)
            resdir = os.path.join(tmpdir, 'res')
            prefile = os.path.join(tmpdir, fname + '.pre')
            resfile = os.path.join(tmpdir, fname + '.res')
            result_files = {k: os.path.join(tmpdir, 'res' + suffix + '.dat')
                            for k, suffix in (('jl', 'JL'), ('ua', 'Ua'), ('ub', 'Ub'),
                                              ('uc', 'Uc'), ('ia', 'Ia'), ('ib', 'Ib'),
                                              ('ic', 'Ic'), ('tr', 'Tr'))}

            common = ['-msh', mshfile, '-name', tmp_name, '-res', resfile,
                      '-setnumber', 'timemax', str(t_stop),
                      '-setnumber', 'dtime', str(self.gopt['TimeStep']),
                      '-setstring', 'ResDir', resdir] + funargs

            pre_cmd = [self.gopt['Executable'], self.pro_path,
                       '-pre', self.gopt['PreProcessing']] + common
            kw = {} if self.gopt['Verbose'] == 1 else {'stdout': PIPE, 'stderr': PIPE}
            if subprocess.run(pre_cmd, **kw).returncode:
                raise Exception('preprocessing failed')

            num_dofs = np.size(u_start)
            num_pres = get_preresolution(file=prefile)
            if num_dofs != np.sum(num_pres):
                raise Exception('u_start has wrong size: ' + str(num_dofs) +
                                ' instead of ' + str(num_pres) + ': ' + str(prefile))

            set_resolution(file=resfile, t_start=t_start, u_start=u_start,
                           num_dofs=num_dofs)

            solve_cmd = [self.gopt['Executable'], self.pro_path, '-restart'] + common
            if subprocess.run(solve_cmd, **kw).returncode:
                raise Exception('getdp solving failed')

            t, y = getdp_read_resolution(file=resfile, num_dofs=num_dofs)
            out = {'x': t, 'y': y}
            for k, path in result_files.items():
                out[k] = get_values_from(file=path)
        return out
