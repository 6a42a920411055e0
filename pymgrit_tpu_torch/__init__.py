"""pymgrit_tpu_torch — Multigrid-Reduction-in-Time on PyTorch, with
hand-written CUDA and Triton kernels for NVIDIA Hopper.

A port of ``pymgrit_tpu`` (JAX), which stays the reference.  This package
imports ``torch`` and never ``jax``; it sets no global torch state (default
dtype, TF32 flags) when imported.  Tubes are float64.
"""

from pymgrit_tpu_torch.core import vector
from pymgrit_tpu_torch.core.application import Application
from pymgrit_tpu_torch.core.grid_transfer import GridTransfer, GridTransferCopy
from pymgrit_tpu_torch.core.hierarchy import simple_setup_problem
from pymgrit_tpu_torch.core.solver import Mgrit
from pymgrit_tpu_torch.core.at_mgrit import AtMgrit
from pymgrit_tpu_torch.models.advection_1d import Advection1D
from pymgrit_tpu_torch.models.allen_cahn import AllenCahn
from pymgrit_tpu_torch.models.arenstorf_orbit import ArenstorfOrbit
from pymgrit_tpu_torch.models.brusselator import Brusselator
from pymgrit_tpu_torch.models.burgers import Burgers1D, Burgers2D
from pymgrit_tpu_torch.models.dahlquist import Dahlquist
from pymgrit_tpu_torch.models.diffusion_2d import Diffusion2D
from pymgrit_tpu_torch.models.gray_scott_2d import GrayScott2D
from pymgrit_tpu_torch.models.grid_transfer_heat import GridTransferHeat, GridTransferHeat2D
from pymgrit_tpu_torch.models.heat_1d import Heat1D
from pymgrit_tpu_torch.models.heat_1d_2pts import Heat1DBDF1, Heat1DBDF2, PairState
from pymgrit_tpu_torch.models.heat_2d import Heat2D

__all__ = [
    "Mgrit",
    "AtMgrit",
    "Application",
    "GridTransfer",
    "GridTransferCopy",
    "simple_setup_problem",
    "vector",
    "Advection1D",
    "AllenCahn",
    "ArenstorfOrbit",
    "Brusselator",
    "Burgers1D",
    "Burgers2D",
    "Dahlquist",
    "Diffusion2D",
    "GrayScott2D",
    "GridTransferHeat",
    "GridTransferHeat2D",
    "Heat1D",
    "Heat1DBDF1",
    "Heat1DBDF2",
    "PairState",
    "Heat2D",
]
