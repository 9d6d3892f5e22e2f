"""Parallelism over torch.distributed: meshes, the multi-process runtime,
exact data-parallel solves and training, and grid-sharded circulant solves.

Counterpart of `hipgp_tpu/parallel/`: one process per device (SPMD), each
rank holding its block of the rows or of the expanded grid.  Not ported
yet: the model-parallel HIP-GP of `mp.py` (ROADMAP.md section A item 10)."""
from . import launch, multihost
from .dp import (
    dp_batch_solve,
    dp_elbo_and_grads,
    dp_svigp_fit,
    make_dp_data_shard_fn,
    make_dp_train_step,
    round_batch_to_mesh,
)
from .fft_sharded import (
    GridShardInfo,
    host_weights,
    local_circulant_apply,
    local_mask,
    local_spectrum_weights,
    local_whiten,
    local_whiten_diff,
    shard_multiples,
    sharded_gram_solve,
    sharded_inv_matmul,
    sharded_matmul_by_K,
    weights_shard,
)
from .mesh import make_mesh, shard_batch

__all__ = [
    "launch",
    "multihost",
    "make_mesh",
    "shard_batch",
    "dp_batch_solve",
    "dp_elbo_and_grads",
    "dp_svigp_fit",
    "make_dp_data_shard_fn",
    "make_dp_train_step",
    "round_batch_to_mesh",
    "GridShardInfo",
    "host_weights",
    "local_circulant_apply",
    "local_mask",
    "local_spectrum_weights",
    "local_whiten",
    "local_whiten_diff",
    "shard_multiples",
    "sharded_gram_solve",
    "sharded_inv_matmul",
    "sharded_matmul_by_K",
    "weights_shard",
]
