"""Multi-device and multi-process runs: the mesh-sharded scan
(distributed.py), the sharded streaming scan across processes
(multihost.py, shard.py) and its process launcher (procspawn.py)."""

from deequ_tpu_torch.parallel import multihost
from deequ_tpu_torch.parallel.distributed import (
    DeviceMesh,
    DistributedScanPass,
    data_mesh,
    run_distributed_analysis,
)
from deequ_tpu_torch.parallel.multihost import run_sharded_analysis
from deequ_tpu_torch.parallel.shard import ShardAssignment, ShardPlan, plan_shards

__all__ = [
    "DeviceMesh",
    "DistributedScanPass",
    "ShardAssignment",
    "ShardPlan",
    "data_mesh",
    "multihost",
    "plan_shards",
    "run_distributed_analysis",
    "run_sharded_analysis",
]
