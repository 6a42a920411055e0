"""Induction machine model family "im_3kW" (GetDP coupling).

Counterpart of ``pymgrit_tpu/models/induction_machine`` (reference
src/pymgrit/induction_machine/*): the machine state (``machine_state.py``),
GetDP file-format IO and mesh utilities (``io_getdp.py``), the mesh-to-mesh
spatial transfer (``grid_transfer_machine.py``), the machine-specific
solvers (``solvers.py``) and the application shelling out to the GetDP FEM
binary (``application.py``), whose step runs on the host through
``coupling/callback.py``.
"""

from pymgrit_tpu_torch.models.induction_machine.machine_state import MachineState, machine_norm
from pymgrit_tpu_torch.models.induction_machine.grid_transfer_machine import GridTransferMachine
from pymgrit_tpu_torch.models.induction_machine.solvers import MgritMachine, MgritMachineConvJl
from pymgrit_tpu_torch.models.induction_machine.application import InductionMachine

__all__ = ["MachineState", "machine_norm", "GridTransferMachine",
           "MgritMachine", "MgritMachineConvJl", "InductionMachine"]
