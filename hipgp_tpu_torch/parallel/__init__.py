"""Parallelism over torch.distributed: meshes, the multi-process runtime,
exact data-parallel solves and training, and grid-sharded circulant solves.

Counterpart of `hipgp_tpu/parallel/`: one process per device (SPMD), each
rank holding its block of the rows (`dp.py`), of the expanded grid
(`fft_sharded.py`), or of both at once: the model-parallel HIP-GP of
`mp.py`, its whitened state split over a 'grid' mesh axis and its rows over
'dp'."""
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
from .mp import (
    grid_state_spec,
    make_mp_kn_fn,
    mp_batch_solve,
    mp_elbo_and_grads,
    mp_gather_state,
    mp_predict,
    mp_shard_state,
    mp_svigp_fit,
)

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
    "mp_batch_solve",
    "mp_predict",
    "mp_shard_state",
    "mp_gather_state",
    "grid_state_spec",
    "make_mp_kn_fn",
    "mp_elbo_and_grads",
    "mp_svigp_fit",
]
