"""Problem ("application") abstraction.

Counterpart of ``pymgrit_tpu/core/application.py``: a problem owns a time
grid (a numpy array), an initial state, a template state and a time
integrator ``step``.  States are torch tensors; the solver allocates its
tubes on the device and in the dtype of ``vector_template``.

``step(u, t_start, t_stop) -> u`` must be a pure function of tensors.  The
solver calls it batched over many intervals at once through
``torch.vmap``, unless the application provides ``step_batched`` or
``step_chain`` (see ``core/solver.py``).
"""

from __future__ import annotations

import abc

import numpy as np
import torch

from pymgrit_tpu_torch.core import vector


def model_device(device=None) -> torch.device:
    """The device a model places its state and tables on: ``device`` if
    given (``"cpu"`` asks for the CPU), else the current CUDA device.  With
    no device given and no CUDA device present it raises: a model never
    moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' to build the model "
                           "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class MetaApplication(abc.ABCMeta):
    """Enforces presence of required attributes after construction."""

    required_attributes = ["vector_template", "vector_t_start"]

    def __call__(cls, *args, **kwargs):
        obj = super().__call__(*args, **kwargs)
        for attr_name in MetaApplication.required_attributes:
            if getattr(obj, attr_name, None) is None:
                raise ValueError("required attribute (%s) not set" % attr_name)
        return obj


class Application(metaclass=MetaApplication):
    """Base class for user problems.

    Subclasses must set ``self.vector_template`` (zero state tensor) and
    ``self.vector_t_start`` (initial-condition tensor) in __init__ and
    implement ``step``.
    """

    required_attributes = ["vector_template", "vector_t_start"]

    def __init__(self, t_start: float = None, t_stop: float = None, nt: int = None,
                 t_interval: np.ndarray = None) -> None:
        if t_interval is None:
            if t_start is None or t_stop is None or nt is None:
                raise Exception('Specify an interval by t_start, t_stop and nt or by t_interval')
            self.t_start = t_start
            self.t_end = t_stop
            self.nt = nt
            self.t = np.linspace(self.t_start, self.t_end, nt)
        else:
            if not isinstance(t_interval, np.ndarray):
                raise Exception('t_interval has the wrong type. Should be a numpy array')
            self.t_start = t_interval[0]
            self.t_end = t_interval[-1]
            self.nt = len(t_interval)
            self.t = t_interval

        self.vector_template = None
        self.vector_t_start = None

    @abc.abstractmethod
    def step(self, u_start, t_start, t_stop):
        """Evolve state u_start from t_start to t_stop.

        :param u_start: state tensor at t_start
        :param t_start: scalar time (float or 0-d tensor)
        :param t_stop: scalar time (float or 0-d tensor)
        :return: state tensor at t_stop
        """

    def initial_tube(self, nt: int):
        """A zero tube of nt states (override for custom init)."""
        return vector.tube_of(self.vector_template, nt)

    def prepare_runtime(self, level_info) -> None:
        """Pre-build level-structure-dependent tables at solver setup.

        Called by the solver with this level's ``LevelInfo``.  Default:
        nothing to prepare.
        """
