"""Parallelism (counterpart of ``coarse_fine_networks_tpu/parallel``):
data parallelism over a ``torch.distributed`` process group
(:mod:`.mesh`: the ranks, their rows, the collectives), the
tensor-parallel fine tower for serving's extract (:mod:`.tensor`, imported
from there: it builds on the models, which import :mod:`.mesh`) and
sequence-parallel fusion over fine time (:mod:`.sequence`).

The JAX package annotates a device mesh and lets XLA's partitioner insert
the collectives; here a training rank is a process holding its rows of
the global batch and the reductions are written where the math needs
them, while serving stays one process that drives a list of devices.
"""

from .mesh import (all_reduce_grads, all_reduce_sum, gather_rows,
                   process_shard, rank, replicate, run_data_parallel,
                   shard_batch, spawn, world)
from .sequence import sequence_sharded_reweight, shard_time

__all__ = [
    "all_reduce_grads",
    "all_reduce_sum",
    "gather_rows",
    "process_shard",
    "rank",
    "replicate",
    "run_data_parallel",
    "sequence_sharded_reweight",
    "shard_batch",
    "shard_time",
    "spawn",
    "world",
]
