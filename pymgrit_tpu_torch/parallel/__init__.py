"""The sharded executor over ``torch.distributed`` (one process a cell of a
('time', 'space') grid): ``make_time_space_mesh``, ``ShardedMgrit``,
``ShardedAtMgrit``."""

from pymgrit_tpu_torch.parallel.sharding import ProcessMesh, make_time_space_mesh
from pymgrit_tpu_torch.parallel.shard_solver import ShardedAtMgrit, ShardedMgrit

__all__ = ["ProcessMesh", "make_time_space_mesh", "ShardedMgrit", "ShardedAtMgrit"]
