"""Serving-side tiered placement on the mesh: the mesh-aware plan's
realization.

Counterpart of the serving half of ``src/repro/launch/sharding.py``
(`tiered_remote_spec`, `shard_tiered_params`, `remote_pool_spec`).  A spec
is the reference's ``PartitionSpec`` as a tuple: one entry per dimension,
the mesh axis name on the sharded one and None elsewhere, ``()`` for
replicated.  Local partitions and plain leaves replicate (every rank
computes the whole batch and built them itself); each remote partition
keeps only this rank's disjoint 1/P slice along its split axis, pinned on a
CUDA device, beside a fixed buffer of its whole extent on the device that
the fetch-once broadcast fills every step (`kernels.ops.mesh_fetch_params`).
A remote extent or a page size that P does not divide stays whole on every
rank: the divisibility fallback, fetched naively.

The training specs of the reference module wait for the training stack.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tiering import TieredTensor
from repro_torch.launch.mesh import Mesh


def split_spec(shape: tuple[int, ...], axis: int, mesh: Mesh, axis_name: str) -> tuple:
    """The spec of a tensor of `shape` sharded along `axis` when P divides
    that extent (a zero extent included as replicated), else ``()``."""
    dim = shape[axis]
    if dim == 0 or dim % mesh.shape[axis_name] != 0:
        return ()
    spec: list[Any] = [None] * len(shape)
    spec[axis % len(shape)] = axis_name
    return tuple(spec)


def tiered_remote_spec(leaf: TieredTensor, mesh: Mesh, axis_name: str) -> tuple:
    """Spec of a `TieredTensor`'s host partition: 1/P slices along the split
    axis when the remote extent divides the mesh axis, else replicated."""
    return split_spec(tuple(leaf.remote.shape), leaf.axis, mesh, axis_name)


def host_slice(full_shape: tuple[int, ...], axis: int, mesh: Mesh,
               axis_name: str) -> tuple[int, int]:
    """(start, length) of this rank's slice of an extent sharded along `axis`."""
    n = full_shape[axis] // mesh.shape[axis_name]
    return mesh.axis_index(axis_name) * n, n


def pin_like(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of `t` in this rank's host tier: pinned,
    device-mapped host memory when `device` is a card, a CPU tensor on the
    CPU."""
    if device.type != "cuda":
        return t.to("cpu", copy=True).contiguous()
    from repro_torch.kernels import _build

    out = _build.pinned_empty(tuple(t.shape), t.dtype)
    out.copy_(t)
    return out


def sharded_tiered(local: torch.Tensor, full_remote_shape: tuple[int, ...],
                   shard: torch.Tensor, axis: int, axis_name: str) -> TieredTensor:
    """A mesh-sharded operand: `shard` is this rank's host slice; ``remote``
    a fixed buffer of the whole remote extent beside the local tier."""
    buf = torch.zeros(full_remote_shape, dtype=local.dtype, device=local.device)
    return TieredTensor(local=local, remote=buf, axis=axis, mesh_axes=axis_name, shard=shard)


def shard_tiered(leaf: TieredTensor, mesh: Mesh, axis_name: str) -> TieredTensor:
    """`leaf` committed to the mesh: its remote tier cut to this rank's
    slice (the rest dropped by the caller), or left whole where P does not
    divide it.  A leaf already sharded on `axis_name` passes through."""
    if leaf.mesh_axes == axis_name or not tiered_remote_spec(leaf, mesh, axis_name):
        return leaf
    ax = leaf.axis % leaf.remote.ndim
    start, n = host_slice(tuple(leaf.remote.shape), ax, mesh, axis_name)
    shard = pin_like(leaf.remote.narrow(ax, start, n), leaf.local.device)
    return sharded_tiered(leaf.local, tuple(leaf.remote.shape), shard, leaf.axis, axis_name)


def shard_tiered_params(params: Any, mesh: Mesh, axis_name: str) -> Any:
    """Place a partitioned params tree on the serving mesh: every remote
    partition P divides keeps this rank's 1/P host slice and gains its
    device buffer, tagged with ``mesh_axes``; everything else replicates as
    it is.  Returns a new tree (nested dicts copied)."""
    if isinstance(params, dict):
        return {k: shard_tiered_params(v, mesh, axis_name) for k, v in params.items()}
    if isinstance(params, TieredTensor):
        return shard_tiered(params, mesh, axis_name)
    return params


def remote_pool_spec(pool_shape: tuple[int, ...], mesh: Mesh, axis_name: str) -> tuple:
    """Spec for a remote KV page pool ``[L, pages+1, page_size, Kh, hd]``:
    sharded on the in-page sequence axis (each rank holds 1/P of every
    remote page), replicated when the page size does not divide."""
    if len(pool_shape) < 3 or pool_shape[2] % mesh.shape[axis_name] != 0:
        return ()
    return tuple([None, None, axis_name] + [None] * (len(pool_shape) - 3))
