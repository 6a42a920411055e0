"""Black-box stepper escape hatch: drive arbitrary host code from the solver.

Counterpart of ``pymgrit_tpu/coupling/callback.py``.  The reference couples
to external solver stacks by calling into them from ``step`` (PETSc KSP
solves, Firedrake Newton solves, the GetDP FEM binary through
``subprocess.run``); the JAX package runs such a host ``step`` inside its
jitted sweeps through ``jax.pure_callback`` with
``vmap_method='sequential'``: the batched states go to the host, the
Python ``step`` runs once per lane in lane order, and the results return
to the device.

The port has no traced program, and a host call cannot run under
``torch.vmap`` (it reads tensor values), so the application hands the
solver ``step_batched``, which the solver prefers to a vmap of ``step``:
the batch of states and its step times are copied to the host once
(``to_host``), ``host_step`` runs once per lane in lane order, and the
stacked results are copied back once (``to_device``), onto the batch's
device and dtype.  ``step`` does the same for one state.  ``host_step``
receives and returns numpy pytrees and Python floats, as in the JAX
package, so one user function drives both packages.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.core.vector import _flatten


def to_host(tree):
    """The tensors of a pytree as numpy arrays: one device-to-host copy a
    leaf (numpy leaves and Python numbers pass as arrays)."""
    leaves, spec = _flatten(tree)
    return _pytree.tree_unflatten([x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                                   else np.asarray(x) for x in leaves], spec)


def to_device(tree, like):
    """numpy leaves as tensors with the structure, dtypes and devices of the
    tensors of ``like``: one host-to-device copy a leaf."""
    leaves, _ = _flatten(tree)
    like_leaves, spec = _flatten(like)
    if len(leaves) != len(like_leaves):
        raise ValueError(f"host_step returned {len(leaves)} leaves, the state has "
                         f"{len(like_leaves)}")
    return _pytree.tree_unflatten(
        [torch.as_tensor(np.asarray(a), dtype=x.dtype, device=x.device).reshape(x.shape)
         for a, x in zip(leaves, like_leaves)], spec)


def host_lanes(host_step: Callable, u, t_start, t_stop):
    """``host_step`` on every lane of the batch u (every leaf (rows, ...)),
    in lane order, from t_start[i] to t_stop[i] (tensors, arrays or floats
    broadcast to the rows): the batch goes to the host and back once."""
    u_h, t0, t1 = to_host((u, t_start, t_stop))
    leaves, spec = _pytree.tree_flatten(u_h)
    rows = leaves[0].shape[0]
    t0, t1 = (np.broadcast_to(np.asarray(t, dtype=np.float64), (rows,)) for t in (t0, t1))
    outs = [_flatten(host_step(_pytree.tree_unflatten([x[i] for x in leaves], spec),
                               float(t0[i]), float(t1[i])))[0] for i in range(rows)]
    stacked = [np.stack([np.asarray(o[k]) for o in outs]) for k in range(len(leaves))]
    return to_device(_pytree.tree_unflatten(stacked, spec), u)


def host_one(host_step: Callable, u, t_start, t_stop):
    """``host_step`` on one state: to the host and back once."""
    return to_device(host_step(to_host(u), float(t_start), float(t_stop)), u)


class CallbackApplication(Application):
    """Application whose step runs on the host.

    :param host_step: ``f(u: np-pytree, t_start: float, t_stop: float) -> np-pytree``
        executed outside the solver's device work.  Must be pure (same
        inputs -> same outputs); called once per batched lane per
        relaxation sweep, in lane order.
    :param vector_template: pytree of numpy arrays defining the state shape
    :param vector_t_start: initial state (pytree of numpy arrays)
    :param device: where the solver keeps the states (the CUDA card unless
        ``"cpu"`` is asked for)
    """

    # its steps run on the host: a 'space' mesh axis would repeat them on
    # every space rank, so ``ShardedMgrit`` refuses n_space > 1
    host_coupled = True

    def __init__(self, host_step: Callable, vector_template, vector_t_start,
                 *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.host_step = host_step
        self.device = model_device(device)
        self.vector_template = self._tensors(vector_template)
        self.vector_t_start = self._tensors(vector_t_start)

    def _tensors(self, tree):
        leaves, spec = _flatten(tree)
        return _pytree.tree_unflatten([torch.as_tensor(np.asarray(x), device=self.device)
                                       for x in leaves], spec)

    def step(self, u_start, t_start, t_stop):
        return host_one(self.host_step, u_start, t_start, t_stop)

    def step_batched(self, u_start, t_start, t_stop):
        return host_lanes(self.host_step, u_start, t_start, t_stop)
