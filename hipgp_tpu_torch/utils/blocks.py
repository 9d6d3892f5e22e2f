"""Block-ordering index tables for the block-diagonal variational family.

Counterpart of `hipgp_tpu/utils/blocks.py`.  Two orderings of the grid's
points coexist: the C (meshgrid) ordering, and a block ordering that groups
neighbouring chunks of the grid so that each chunk owns one dense covariance
block.  The tables are built on the host in numpy (int64); a model moves
them to its device once, and the conversions are gathers.  Any number of
grid dimensions.
"""
from __future__ import annotations

from itertools import product
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["block_indices", "interleaved_block_indices", "to_blocks", "from_blocks"]


def block_indices(dims: Sequence[int],
                  chunk_sizes: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(blk_idx, inverse) grouping a C-ordered grid of shape ``dims`` into
    chunks of ``chunk_sizes`` (each must divide its dimension, else
    ValueError).  ``blk_idx`` (num_blocks, block_size) holds the flat
    indices of each block's points (blocks in C order of their chunk
    coordinates, points in C order within a block); ``inverse`` (M,)
    restores the C order from the flattened block order."""
    dims = tuple(int(d) for d in dims)
    chunk_sizes = tuple(int(c) for c in chunk_sizes)
    if len(dims) != len(chunk_sizes):
        raise ValueError(f"dims ndim {len(dims)} != chunk ndim {len(chunk_sizes)}")
    for d, c in zip(dims, chunk_sizes):
        if d % c != 0:
            raise ValueError(f"grid dim {d} not divisible by chunk size {c}")
    nd = len(dims)
    flat = np.arange(int(np.prod(dims)), dtype=np.int64)
    # each axis split into (n_chunks, chunk), the chunk-count axes first
    split = flat.reshape([n for d, c in zip(dims, chunk_sizes) for n in (d // c, c)])
    perm = list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2))
    blk = np.transpose(split, perm).reshape(-1, int(np.prod(chunk_sizes)))
    inverse = np.argsort(blk.reshape(-1), kind="stable")
    return blk, inverse.astype(np.int64)


def to_blocks(v: torch.Tensor, blk_idx: torch.Tensor) -> torch.Tensor:
    """(..., M) in C order -> (..., num_blocks, block_size) in block order."""
    return v[..., blk_idx]


def from_blocks(vb: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """(..., num_blocks, block_size) in block order -> (..., M) in C order."""
    return vb.reshape(vb.shape[:-2] + (-1,))[..., inverse]


def interleaved_block_indices(dims: Sequence[int], num_blocks_per_dim: int) -> np.ndarray:
    """Strided grouping: block (b_1, ..., b_D) owns every
    ``num_blocks_per_dim``-th point from its offset along each axis.
    (num_blocks, block_size) int64 flat indices in C order."""
    dims = tuple(int(d) for d in dims)
    nb = int(num_blocks_per_dim)
    for d in dims:
        if d % nb != 0:
            raise ValueError(f"grid dim {d} not divisible by {nb}")
    flat = np.arange(int(np.prod(dims)), dtype=np.int64).reshape(dims)
    return np.stack([flat[tuple(slice(o, None, nb) for o in offs)].reshape(-1)
                     for offs in product(range(nb), repeat=len(dims))])
