"""The port's parallel layer (counterpart of `dvg_tpu/parallel`): process
groups over `torch.distributed` (one process per rank), meshes with named
axes, data-parallel training and the sample- and (sample, data)-sharded
diverse eval. `dryrun.dryrun_multiproc(n)` runs both on n gloo ranks on
the CPU against the one-process run."""

from dvg_tpu_torch.parallel.collectives import (all_gather, all_reduce_mean_,
                                                all_reduce_sum, broadcast_,
                                                world_size)
from dvg_tpu_torch.parallel.mesh import (broadcast_state, distributed_init,
                                         is_coordinator, make_mesh,
                                         mesh_layout, rank_device,
                                         shard_diverse_metrics)

__all__ = ["all_gather", "all_reduce_mean_", "all_reduce_sum", "broadcast_",
           "world_size", "broadcast_state", "distributed_init",
           "is_coordinator", "make_mesh", "mesh_layout", "rank_device",
           "shard_diverse_metrics"]
