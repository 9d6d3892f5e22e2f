"""The multi-process runtime: one process per device over torch.distributed.

Counterpart of `hipgp_tpu/parallel/multihost.py`.  JAX joins the hosts of a
pod slice with ``jax.distributed.initialize`` and then drives a global mesh
of devices from each process.  In torch a process drives one device, so
multi-host and multi-device are the same mechanism: every rank calls
:func:`initialize` (torchrun's environment, or an explicit coordinator),
builds the same mesh (:func:`global_mesh`) and feeds only its own rows.

Usage, one process per device (``torchrun --nproc-per-node N script.py``):

    from hipgp_tpu_torch.parallel import multihost, dp_batch_solve
    multihost.initialize()                  # torchrun's environment
    mesh = multihost.global_mesh(("dp",))
    sl = multihost.process_slice(N)
    xg = multihost.global_batch(mesh, x_all[sl], n_global=N)
    wg = multihost.global_row_weights(mesh, N)
    dp_batch_solve(model, state, xg, yg, sg, mesh, row_weights=wg)

Torch has no global array: :func:`global_batch` returns a
:class:`GlobalBatch`, this rank's block padded to the common block size
together with the global row count, which `dp.dp_batch_solve` takes in place
of a full array.  `launch.run` starts a world of ranks on one machine (the
tests and the chip script use it).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as _mesh

__all__ = ["initialize", "is_initialized", "global_mesh",
           "global_batch", "global_row_weights", "process_slice", "on_coordinator",
           "sync_global", "GlobalBatch", "free_port", "DEFAULT_TIMEOUT_S"]

# the process group's timeout: a collective that waits longer for a rank
# (one that died or hangs) fails instead of hanging its peers
DEFAULT_TIMEOUT_S = 300.0

def free_port() -> int:
    """A free TCP port on this machine (for a coordinator on localhost)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resolve_device(device) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` unless the caller names one."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank)
    return device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join (or create) the world of ranks; idempotent.

    With no ``coordinator_address`` it reads torchrun's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``); without that environment it makes a world of one
    process and says so.  Otherwise it joins ``tcp://coordinator_address``
    as rank ``process_id`` of ``num_processes``.  The rank computes on
    ``device`` (default ``cuda:LOCAL_RANK``; the CUDA device is made
    current); ``backend`` defaults to NCCL for a CUDA device and gloo for
    the CPU.  NCCL cannot put two ranks on one GPU: several ranks on one
    card take gloo, asked for explicitly."""
    if dist.is_initialized():
        return
    dev = _resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        print("multihost: no torchrun environment (RANK, WORLD_SIZE): running "
              "as a world of one process", flush=True)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0, timeout=timeout)


def is_initialized() -> bool:
    return dist.is_initialized()


def global_mesh(axis_names=("dp",), shape=None):
    """A mesh over every rank of the world (one device each)."""
    return _mesh.make_mesh(None, tuple(axis_names), shape)


def _blocks(mesh, mesh_axis: str):
    """(this rank's block, the number of blocks) of rows: the world rank
    and size, or with a mesh the rank's position on ``mesh_axis`` and that
    axis's size (the ranks that share a position, the grid ranks of a
    model-parallel mesh, hold the same rows)."""
    if mesh is None:
        return dist.get_rank(), dist.get_world_size()
    return _mesh.axis_index(mesh, mesh_axis), _mesh.axis_size(mesh, mesh_axis)


def process_slice(n_global: int, mesh=None, mesh_axis: str = "dp") -> slice:
    """Rows of a length-n_global dataset owned by this rank: contiguous
    ceil(n / nprocs) blocks, one a rank of the world, or with ``mesh`` one a
    position on ``mesh_axis`` (the last may be shorter; :func:`global_batch`
    pads it back to the common size)."""
    p, nprocs = _blocks(mesh, mesh_axis)
    per = -(-n_global // nprocs)
    lo = min(p * per, n_global)
    return slice(lo, min(lo + per, n_global))


@dataclasses.dataclass
class GlobalBatch:
    """This rank's block of a global array whose leading axis is split over
    the ranks of a mesh axis, in rank order.  ``local``: the block, padded
    to the common block size; ``n_global``: the global row count, pad rows
    included (every rank's block has ``n_global / nprocs`` rows)."""

    local: torch.Tensor
    n_global: int

    @property
    def shape(self):
        return (self.n_global,) + tuple(self.local.shape[1:])


def _rows_per_process(mesh, mesh_axis: str, n_global: int) -> int:
    """The common block size: ceil(n / blocks), one block a position on
    ``mesh_axis`` (one device, one process)."""
    return -(-n_global // _mesh.axis_size(mesh, mesh_axis))


def global_batch(mesh, local_rows, mesh_axis: str = "dp",
                 n_global: Optional[int] = None, fill: float = 0.0) -> GlobalBatch:
    """This rank's rows (see :func:`process_slice`) as its block of the global
    array.  Every rank must pass the same block shape unless ``n_global``,
    the true row count, is given: then each block is padded with ``fill``
    rows to the common size and the pad rows are masked by
    :func:`global_row_weights`.  Use ``fill=1.0`` for noise-std arrays, so
    that 1 / s^2 stays finite on the pads."""
    local = torch.as_tensor(np.asarray(local_rows))
    nblocks = _mesh.axis_size(mesh, mesh_axis)
    if n_global is None:
        return GlobalBatch(local, local.shape[0] * nblocks)
    per = _rows_per_process(mesh, mesh_axis, n_global)
    pad = per - local.shape[0]
    if pad:
        tail = torch.full((pad,) + tuple(local.shape[1:]), fill, dtype=local.dtype)
        local = torch.cat([local, tail])
    return GlobalBatch(local, per * nblocks)


def global_row_weights(mesh, n_global: int, mesh_axis: str = "dp",
                       dtype=np.float64) -> GlobalBatch:
    """0/1 weights of a :func:`global_batch` block: 1 on this rank's real
    rows, 0 on its pad rows."""
    sl = process_slice(n_global, mesh, mesh_axis)
    return global_batch(mesh, np.ones((sl.stop - sl.start,), dtype), mesh_axis,
                        n_global=n_global, fill=0.0)


def on_coordinator() -> bool:
    """True on rank 0 (and in a process with no world): the rank that writes
    checkpoints, CSVs and figures."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_global(x) -> float:
    """The sum of ``x`` over every device of the world (one per rank), on
    every rank; also a barrier."""
    # NCCL reduces on the rank's (current) CUDA device, gloo on the CPU
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([float(x)], dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return float(t[0])
