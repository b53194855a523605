"""Parallelism over ``torch.distributed`` process groups.

Counterpart of ``acoustic_locating_vq_vae_tpu/parallel``: a process per card
(``torchrun``) laid out as the JAX ``(data, model, seq)`` mesh
(``mesh.make_mesh``). The data axis trains each rank on its block of the
global batch, with the gradients, the scalar metrics and the vector
quantizers' codebook statistics reduced over the ranks; the sequence axis
shards the time axis of the conv stacks, with halo exchanges between
neighbours (``sequence.py``); the model axis shards the large parameters,
Megatron-style, by the JAX partition rules (``sharding_rules.py``,
``tensor.py``). Multi-node layouts keep every model and sequence group
within one node.
"""

from .dp_step import global_rows, make_dp_train_step, reduce_gradients, reduce_metrics
from .mesh import (
    DataParallel,
    check_replicated,
    init_data_parallel,
    local_mesh,
    make_mesh,
    mesh_layout,
    rank_seed,
    replicate,
    shard_batch,
)
from .sequence import halo_exchange, sequence_parallel_apply, sequence_sharded_conv, sharded_conv1d
from .sharding_rules import param_partition_spec, sharded_dim
from .tensor import full_state_dict, shard_model

__all__ = [
    "DataParallel", "check_replicated", "full_state_dict", "global_rows", "halo_exchange", "init_data_parallel",
    "local_mesh", "make_dp_train_step", "make_mesh", "mesh_layout", "param_partition_spec", "rank_seed",
    "reduce_gradients", "reduce_metrics", "replicate", "sequence_parallel_apply", "sequence_sharded_conv",
    "shard_batch", "shard_model", "sharded_conv1d", "sharded_dim",
]
