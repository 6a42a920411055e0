"""The ('time', 'space') process grid of the sharded executor.

Counterpart of ``pymgrit_tpu/parallel/sharding.py``'s
``make_time_space_mesh``.  There a mesh is an array of devices with the
axes ('time', 'space') and one process drives all of them.  Here one
process runs each cell of the grid: a ``ProcessMesh`` holds the
``torch.distributed`` group of its time axis (the ranks with the same space
index), that of its space axis (the ranks with the same time index; None
where n_space is 1), this process's index on each axis and the axes'
sizes, with ``shape`` as JAX's mesh has it.  The process of cell (t, s) is
rank ``t * n_space + s`` of the group the grid is made from, as JAX
reshapes its device list.

A user starts one process a cell and calls
``torch.distributed.init_process_group`` in each (gloo on the CPU; NCCL with
one GPU a rank; a world of several ranks on one GPU takes gloo, whose
collectives ``parallel.comm`` stages through the host), then
``make_time_space_mesh(n_time, n_space)`` and ``ShardedMgrit(problem,
mesh)`` in each.

JAX gives the 'space' axis to GSPMD, which partitions each application's
dense linear algebra; the port partitions the state's
``space_sharding_axis`` into slabs itself, through the application's space
route (``Heat2D``; ROADMAP A7b).  The GSPMD helpers ``leaf_spec``,
``state_shardings`` and ``shard_state`` serve only ``Mgrit(mesh=...)``,
which the port routes to ``ShardedMgrit``; they are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A ('time', 'space') grid of processes: the time axis's group, this
    process's index on it and its size (``group``, ``rank``, ``size``), and
    the space axis's (``space_group``, None where ``n_space`` is 1,
    ``space_rank``, ``n_space``).  The solver takes its device from the
    problem and each group's backend from the group."""

    group: object
    rank: int
    size: int
    space_group: object = None
    space_rank: int = 0
    n_space: int = 1

    @property
    def shape(self) -> dict:
        return {"time": self.size, "space": self.n_space}


def make_time_space_mesh(n_time: Optional[int] = None, n_space: int = 1,
                         group=None) -> Optional[ProcessMesh]:
    """A ('time', 'space') mesh over the initialized default process group,
    or over ``group``: its first n_time * n_space ranks (n_time: all of the
    group's over n_space by default), cell (t, s) on rank t * n_space + s.
    The time groups and the space groups are new groups where the grid needs
    them: every rank of the world must make the call, and a rank outside
    the grid gets None."""
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
    ranks = dist.get_process_group_ranks(group)
    me = dist.get_rank()
    if n_space == 1:
        if n_time < size:
            ranks = ranks[:n_time]
            group = dist.new_group(ranks=ranks)
            if me not in ranks:
                return None
        return ProcessMesh(group=group, rank=dist.get_rank(group), size=n_time)
    # every rank makes every group, in the same order (new_group is collective)
    time_groups = [dist.new_group(ranks=[ranks[t * n_space + s] for t in range(n_time)])
                   for s in range(n_space)]
    space_groups = [dist.new_group(ranks=[ranks[t * n_space + s] for s in range(n_space)])
                    for t in range(n_time)]
    grid = ranks[:n_time * n_space]
    if me not in grid:
        return None
    t, s = divmod(grid.index(me), n_space)
    return ProcessMesh(group=time_groups[s], rank=t, size=n_time, space_group=space_groups[t],
                       space_rank=s, n_space=n_space)
