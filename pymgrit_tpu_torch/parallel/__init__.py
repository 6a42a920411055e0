"""The time-sharded executor over ``torch.distributed`` (one process a
time shard): ``make_time_space_mesh``, ``ShardedMgrit``, ``ShardedAtMgrit``."""

from pymgrit_tpu_torch.parallel.sharding import TimeMesh, make_time_space_mesh
from pymgrit_tpu_torch.parallel.shard_solver import ShardedAtMgrit, ShardedMgrit

__all__ = ["TimeMesh", "make_time_space_mesh", "ShardedMgrit", "ShardedAtMgrit"]
