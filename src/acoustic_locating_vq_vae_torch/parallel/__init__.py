"""Data parallelism over ``torch.distributed`` process groups.

Counterpart of the data axis of ``acoustic_locating_vq_vae_tpu/parallel``: a
process per card (``torchrun``), each rank training on its block of the
global batch, with the gradients, the scalar metrics and the vector
quantizers' codebook statistics reduced over the ranks so that a step is the
global batch's step. Sequence sharding, tensor sharding and multi-slice
layouts are the next slice (``check_mesh`` raises for them).
"""

from .dp_step import global_rows, make_dp_train_step, reduce_gradients, reduce_metrics
from .mesh import (
    DataParallel,
    check_mesh,
    check_replicated,
    init_data_parallel,
    local_mesh,
    rank_seed,
    replicate,
    shard_batch,
)

__all__ = [
    "DataParallel", "check_mesh", "check_replicated", "global_rows", "init_data_parallel", "local_mesh",
    "make_dp_train_step", "rank_seed", "reduce_gradients", "reduce_metrics", "replicate",
    "shard_batch",
]
