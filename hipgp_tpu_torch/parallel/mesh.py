"""Device meshes and the collectives over their axes.

Counterpart of `hipgp_tpu/parallel/mesh.py`.  The JAX package runs one
process that drives a named mesh of devices through ``shard_map`` and
``psum``.  The port runs one process per device (SPMD over
``torch.distributed``): every rank holds its own block of the data or of the
expanded grid and calls the collectives below explicitly.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world of the default
process group (`multihost.initialize`), with the JAX axis names; every
collective takes the process group of one axis (:func:`axis_group`).

JAX's ``P``, ``NamedSharding`` and ``replicated`` place a global array on
the mesh.  Torch has no global array, so they have no counterpart here:
:func:`shard_batch` returns this rank's block instead.

The collectives count the bytes of the buffers this rank hands them in
:data:`COMM`, by kind.  gloo takes CUDA tensors for every collective here
(it moves them through host memory itself), so several ranks on one card
run them on the card's tensors unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "shard_batch", "axis_size", "axis_index", "axis_group",
           "all_reduce", "sum_over", "all_to_all", "all_gather", "COMM", "reset_comm"]

# bytes of the buffers this process handed each kind of collective since
# reset_comm() (an all_to_all's piece for this rank itself included;
# "all_reduce" counts the sums, the MAX and MIN reductions and sum_over)
COMM = {"all_reduce": 0, "all_to_all": 0, "all_gather": 0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def reset_comm() -> None:
    for k in COMM:
        COMM[k] = 0


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("dp",),
              shape: Optional[Sequence[int]] = None):
    """A DeviceMesh over the world of the default process group, one device
    per rank, with ``axis_names`` (default shape: every rank on the first
    axis).  ``n_devices`` must be the world size: a rank outside the mesh
    could not take part in its collectives."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}: a mesh spans the whole world "
                         f"of {world} ranks (one device per rank)")
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def axis_group(mesh, axis: str):
    """The process group of the mesh axis ``axis``."""
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's position along ``axis``."""
    return mesh.get_local_rank(axis)


def shard_batch(mesh, t: torch.Tensor, axis: int = 0, mesh_axis: str = "dp"):
    """This rank's block of ``t`` along ``axis`` when that axis is split
    evenly over ``mesh_axis`` (JAX: the array placed with ``axis`` sharded)."""
    n, i = axis_size(mesh, mesh_axis), axis_index(mesh, mesh_axis)
    if t.shape[axis] % n:
        raise ValueError(f"axis {axis} of length {t.shape[axis]} does not split "
                         f"evenly over {n} ranks")
    per = t.shape[axis] // n
    return t.narrow(axis, i * per, per)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(tensors, group=None, inplace: bool = False, op: str = "sum"):
    """Sum each tensor over the ranks of ``group`` (``op`` 'max' or 'min':
    the elementwise extremum, JAX's ``pmax`` / ``pmin``): one collective for
    the whole list (packed into one buffer when there are several).  Returns
    a list of new tensors in the dtypes and shapes given, not part of any
    autograd graph (:func:`sum_over` is the differentiable sum);
    ``inplace`` (one contiguous tensor) reduces into it instead, without a
    copy."""
    tensors = list(tensors)
    if op not in _OPS:
        raise ValueError(f"op={op!r}; choose 'sum', 'max' or 'min'")
    if inplace:
        (buf,) = tensors
        COMM["all_reduce"] += _nbytes(buf)
        dist.all_reduce(buf, op=_OPS[op], group=group)
        return [buf]
    if len(tensors) == 1:
        buf = tensors[0].detach().clone()
    else:
        buf = torch.cat([t.detach().reshape(-1).to(tensors[0].dtype) for t in tensors])
    COMM["all_reduce"] += _nbytes(buf)
    dist.all_reduce(buf, op=_OPS[op], group=group)
    if len(tensors) == 1:
        return [buf]
    out, o = [], 0
    for t in tensors:
        out.append(buf[o:o + t.numel()].reshape(t.shape).to(t.dtype))
        o += t.numel()
    return out


class _SumOver(torch.autograd.Function):
    """The sum over a group's ranks, with the identity as its backward.

    Every rank of the group goes on with the same sum and differentiates
    the same objective of it, so the cotangent that reaches the sum on each
    rank is already the cotangent of that rank's summand (JAX's ``psum``
    transposes to the broadcast, not to a second ``psum``).  What a rank
    then gets for its inputs is its share of the gradient: the shares sum
    to the whole over the group."""

    @staticmethod
    def forward(ctx, group, *tensors):
        # the packed buffer's pieces are views of one tensor: own copies
        return tuple(t.clone() for t in all_reduce(tensors, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + grads


def sum_over(tensors, group):
    """Each tensor summed over the ranks of ``group`` in one collective (as
    :func:`all_reduce`), differentiably: see `_SumOver` for the gradient's
    convention.  Returns a list."""
    tensors = list(tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_SumOver.apply(group, *tensors))
    return all_reduce(tensors, group)


def _exchange(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``split_axis`` cut into one piece per rank,
    piece j sent to rank j, the pieces received concatenated along
    ``concat_axis`` in rank order."""
    n = dist.get_world_size(group)
    nd = x.ndim
    sa, ca = split_axis % nd, concat_axis % nd
    if x.shape[sa] % n:
        raise ValueError(f"axis {sa} of length {x.shape[sa]} does not split over {n} ranks")
    pieces = x.unflatten(sa, (n, x.shape[sa] // n)).movedim(sa, 0)
    send = torch.view_as_real(pieces.contiguous()) if x.is_complex() else pieces.contiguous()
    COMM["all_to_all"] += _nbytes(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if x.is_complex():
        recv = torch.view_as_complex(recv)
    return recv.movedim(0, ca).flatten(ca, ca + 1)


class _AllToAll(torch.autograd.Function):
    """The exchange with its adjoint as the backward: the same exchange
    with the split and concatenation axes swapped."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _exchange(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _exchange(g, group, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    """JAX's ``jax.lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)`` over ``group``; differentiable in ``x``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, group, split_axis, concat_axis)
    return _exchange(x, group, split_axis, concat_axis)


def all_gather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis`` in rank order."""
    n = dist.get_world_size(group)
    send = x.detach().contiguous()
    COMM["all_gather"] += _nbytes(send)
    parts = [torch.empty_like(send) for _ in range(n)]
    dist.all_gather(parts, send, group=group)
    return torch.cat(parts, dim=axis)
