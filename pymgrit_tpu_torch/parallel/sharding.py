"""The time mesh of the sharded executor.

Counterpart of ``pymgrit_tpu/parallel/sharding.py``'s
``make_time_space_mesh``.  There a mesh is an array of devices with the
axes ('time', 'space') and one process drives all of them.  Here one
process runs each time shard: a ``TimeMesh`` is a ``torch.distributed``
process group, this process's rank in it and the group's size, with
``shape`` as JAX's mesh has it (``{"time": n, "space": 1}``).

A user starts one process a time shard and calls
``torch.distributed.init_process_group`` in each (gloo on the CPU; NCCL with
one GPU a rank; a world of several ranks on one GPU takes gloo, whose
collectives ``parallel.comm`` stages through the host), then
``make_time_space_mesh()`` and ``ShardedMgrit(problem, mesh)`` in each.

The 'space' axis (JAX gives it to GSPMD, which partitions each
application's dense linear algebra) is not ported: ``n_space > 1`` raises
(ROADMAP A7b).  The GSPMD helpers ``leaf_spec``, ``state_shardings`` and
``shard_state`` serve only ``Mgrit(mesh=...)``, which the port routes to
``ShardedMgrit``; they are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TimeMesh:
    """A 1-D 'time' mesh: the process group, this process's rank in it and
    its size.  The solver takes its device from the problem and its
    backend from the group."""

    group: object
    rank: int
    size: int

    @property
    def shape(self) -> dict:
        return {"time": self.size, "space": 1}


def make_time_space_mesh(n_time: Optional[int] = None, n_space: int = 1,
                         group=None) -> Optional[TimeMesh]:
    """A ('time', 'space') mesh over the initialized default process group,
    or over ``group``: n_time ranks (all of the group's by default) on the
    'time' axis.  Where n_time is less than the group's size, the first
    n_time ranks form a new group; every rank of the group must make that
    call, and the others get None."""
    if not dist.is_initialized():
        raise RuntimeError("make_time_space_mesh needs an initialized torch.distributed "
                           "process group (torch.distributed.init_process_group)")
    group = group if group is not None else dist.group.WORLD
    size = dist.get_world_size(group)
    if n_time is None:
        n_time = size // n_space
    if n_time * n_space > size:
        raise Exception(f"Mesh {n_time}x{n_space} needs more than the "
                        f"{size} available devices")
    if n_space != 1:
        raise NotImplementedError(
            "a 'space' mesh axis (n_space > 1) is not ported (ROADMAP A7b): the port shards "
            "time only")
    if n_time < size:
        ranks = dist.get_process_group_ranks(group)[:n_time]
        group = dist.new_group(ranks=ranks)
        if dist.get_rank() not in ranks:
            return None
    return TimeMesh(group=group, rank=dist.get_rank(group), size=n_time)
