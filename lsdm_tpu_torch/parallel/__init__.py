"""Multi-GPU training and sampling on ``torch.distributed``.

Counterpart of ``lsdm_tpu/parallel``: a 2-D (data, model) mesh of ranks,
the batch split on the data axis, the flattened object-cloud axis of the
PointNet++ backbone split over both axes, parameters replicated, and the
gradient reduction written out (``train/trainer.py``) where XLA's SPMD
partitioner inserts it.
"""

from lsdm_tpu_torch.parallel.mesh import (
    BatchShard,
    batch_sharding,
    cloud_shard_map,
    initialize_distributed,
    make_mesh,
    replicated,
    shard_batch,
    sharded_config,
)

__all__ = ["BatchShard", "batch_sharding", "cloud_shard_map",
           "initialize_distributed", "make_mesh", "replicated", "shard_batch",
           "sharded_config"]
