"""Sharding policy: specs for params / optimizer / batches / caches, and
the serving-side tiered placement on the mesh.

Counterpart of ``src/repro/launch/sharding.py``.  A spec is the
reference's ``PartitionSpec`` as a tuple: one entry per dimension, the
mesh axis name (or a tuple of names) on a sharded one and None elsewhere,
``()`` for replicated.  Specs are computed against `Mesh.shape`.

Training specs (`param_specs`, `train_strategy`, `opt_specs`,
`batch_specs`, `cache_specs`): ``model`` carries tensor/expert parallelism
(heads, d_ff, vocab, experts); ``data`` (+ ``pod``) carries batch and FSDP
parameter sharding.  Every assignment is guarded by a divisibility check,
so any (arch x shape x mesh) combination gets a legal spec; GQA caches
whose kv-head count is smaller than the model axis fall back to
sequence(split-K)-sharded KV.  The one-process train driver applies none
of them; they are the policy a multi-rank trainer places by.

`named` turns a spec tree into DTensor placements on a mesh's
``DeviceMesh`` (the dry run's fake production mesh), the counterpart of
the reference's ``NamedSharding`` tree.

Serving (`tiered_remote_spec`, `shard_tiered_params`, `remote_pool_spec`):
local partitions and plain leaves replicate (every rank
computes the whole batch and built them itself); each remote partition
keeps only this rank's disjoint 1/P slice along its split axis, pinned on a
CUDA device, beside a fixed buffer of its whole extent on the device that
the fetch-once broadcast fills every step (`kernels.ops.mesh_fetch_params`).
A remote extent or a page size that P does not divide stays whole on every
rank: the divisibility fallback, fetched naively.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.tiering import TieredTensor
from repro_torch.launch.mesh import Mesh, axis_size, data_axes
from repro_torch.tree import tree_map, tree_map_with_path

# param-name classes
_LAST_DIM_MODEL = {"wq", "wq_b", "wkv_b", "wi", "shared_wi", "z_proj",
                   "x_proj", "concat_proj", "lm_head"}
_PENULT_DIM_MODEL = {"wo", "wdown", "shared_wdown", "ssm_out"}
_FSDP_ONLY = {"wkv", "wq_a", "wkv_a", "router", "vision_proj", "in_proj",
              "bc_proj", "dt_proj"}


def _path_name(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def _ok(dim: int, mesh: Mesh, axes) -> bool:
    if axes is None:
        return True
    ax = (axes,) if isinstance(axes, str) else tuple(axes)
    return dim % axis_size(mesh, ax) == 0


def _entry(axes: Any) -> Any:
    """A spec entry as ``PartitionSpec`` normalizes it: one axis in a tuple
    is that axis' name."""
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _assign(shape: tuple[int, ...], mesh: Mesh, wants: dict[int, Any]) -> tuple:
    """A spec placing `wants[dim]=axes` where divisible."""
    spec: list[Any] = [None] * len(shape)
    for dim, axes in wants.items():
        d = dim % len(shape)
        if axes is not None and _ok(shape[d], mesh, axes):
            spec[d] = _entry(axes)
    return tuple(spec)


def param_specs(cfg: ModelConfig, params_shapes: Any, mesh: Mesh, *, fsdp: bool = True) -> Any:
    """Spec tree matching the params tree (of anything with a ``shape``:
    tensors, meta tensors)."""
    dax = data_axes(mesh)
    fs = dax if fsdp else None

    def rule(path, leaf):
        name = _path_name(path)
        shp = tuple(leaf.shape)
        if len(shp) <= 1 or name in {"dt_bias", "A_log", "D"}:
            return ()
        if name in _LAST_DIM_MODEL:
            return _assign(shp, mesh, {-1: "model", -2: fs})
        if name in _PENULT_DIM_MODEL:
            return _assign(shp, mesh, {-2: "model", -1: fs})
        if name == "experts_wi":
            # TP inside every expert (ff over model): the grouped dispatch
            # stays batch-local, one activation all-reduce per layer
            return _assign(shp, mesh, {-1: "model", 1: fs})
        if name == "experts_wdown":
            return _assign(shp, mesh, {-2: "model", 1: fs})
        if name in _FSDP_ONLY:
            return _assign(shp, mesh, {-1: fs})
        if name == "embed":
            # d_model (not vocab) carries the model axis: token gathers from
            # a vocab-sharded table force full rematerialization
            return _assign(shp, mesh, {0: fs, 1: "model"})
        # norms / biases / small leftovers: replicate beyond fsdp on last dim
        if len(shp) >= 2 and name.startswith(("b", "ln", "final")):
            return ()
        return _assign(shp, mesh, {-1: fs})

    return tree_map_with_path(rule, params_shapes)


def train_strategy(cfg: ModelConfig, mesh: Mesh) -> str:
    """ZeRO-1 (replicated params, sharded grads/optimizer) for models whose
    bf16 weights fit comfortably replicated; ZeRO-3/FSDP otherwise."""
    return "zero1" if cfg.param_count() * 2 <= 8e9 else "fsdp"


def opt_specs(param_spec_tree: Any) -> dict[str, Any]:
    """Optimizer state mirrors param sharding; the step counter replicates."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": ()}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> dict[str, tuple]:
    dax = data_axes(mesh)
    bspec = _entry(dax) if shape.global_batch % axis_size(mesh, dax) == 0 else None
    out: dict[str, tuple] = {}
    if cfg.family == "encoder":
        out["frames"] = (bspec, None, None)
    elif cfg.family == "vlm":
        out["tokens"] = (bspec, None)
        out["patches"] = (bspec, None, None)
    else:
        out["tokens"] = (bspec, None)
    if shape.step == "train":
        out["labels"] = (bspec, None)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh) -> Any:
    """Spec tree matching `models.model.init_cache`'s structure.

    Decode batches shard over data; the KV sequence shards over `model`
    (split-K attention).  batch==1 long-context shards the sequence over
    every axis instead."""
    dax = data_axes(mesh)
    batch_ok = shape.global_batch % axis_size(mesh, dax) == 0
    b_ax = dax if batch_ok else None
    s_ax: Any = "model" if batch_ok else tuple([*dax, "model"])

    specs: dict[str, Any] = {}
    if cfg.family in ("ssm", "hybrid"):
        nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
        conv_dim = cfg.ssm_expand * cfg.d_model + 2 * cfg.ssm_n_groups * cfg.ssm_state
        specs["conv"] = _assign((cfg.n_layers, shape.global_batch, cfg.ssm_conv_width - 1,
                                 conv_dim), mesh, {1: b_ax, 3: "model"})
        specs["state"] = _assign((cfg.n_layers, shape.global_batch, nh, cfg.ssm_head_dim,
                                  cfg.ssm_state), mesh, {1: b_ax, 2: "model"})
    if cfg.use_mla:
        specs["ckv"] = _assign((cfg.n_layers, shape.global_batch, shape.seq_len,
                                cfg.kv_lora_rank), mesh, {1: b_ax, 2: s_ax})
        specs["krope"] = _assign((cfg.n_layers, shape.global_batch, shape.seq_len,
                                  cfg.rope_head_dim), mesh, {1: b_ax, 2: s_ax})
    elif cfg.family in ("dense", "moe", "vlm", "hybrid"):
        n_entries = (cfg.n_layers // cfg.hybrid_attn_every
                     if cfg.family == "hybrid" else cfg.n_layers)
        kv_shape = (n_entries, shape.global_batch, shape.seq_len,
                    cfg.n_kv_heads, cfg.resolved_head_dim)
        spec = _assign(kv_shape, mesh, {1: b_ax, 2: s_ax})
        specs["k"] = spec
        specs["v"] = spec
    return specs


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec realized on a DTensor ``DeviceMesh``: one placement per mesh
    dimension."""

    mesh: Any
    placements: tuple


def placements(dim_names: tuple[str, ...], spec: tuple) -> tuple:
    """DTensor placements of `spec` on a DeviceMesh whose dims are named
    `dim_names` (`launch.mesh.fake_mesh`: "pod.data" carries both batch
    axes): a tensor dim whose entry names an axis is ``Shard(dim)`` on the
    mesh dim that carries it; an entry such as ("pod", "data") shards one
    tensor dim over the dims of its axes, the first outermost (which
    DTensor takes in mesh order, so the axes must come in that order; a
    merged dim must be named whole); every other mesh dim is
    ``Replicate()``.  ``()`` is replicated everywhere."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import mesh_dim

    out: list[Any] = [Replicate()] * len(dim_names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = sorted({mesh_dim(dim_names, a) for a in axes},
                     key=[mesh_dim(dim_names, a) for a in axes].index)
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of mesh order "
                             f"{dim_names}")
        for i in idx:
            if sorted(a for a in axes if a in dim_names[i].split(".")) != \
                    sorted(dim_names[i].split(".")):
                raise ValueError(f"spec entry {entry!r} names part of mesh dim "
                                 f"{dim_names[i]!r}")
            out[i] = Shard(dim)
    return tuple(out)


def named(mesh: Mesh, spec_tree: Any) -> Any:
    """Spec tree -> `NamedSharding` tree on `mesh.device_mesh`."""
    dm = mesh.device_mesh
    if dm is None:
        raise ValueError(f"{mesh!r} has no DeviceMesh (launch.mesh.fake_mesh makes one)")
    return tree_map(lambda spec: NamedSharding(dm, placements(dm.mesh_dim_names, spec)),
                    spec_tree)


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
    from repro_torch.kernels import _build

    return _build.host_tier(tuple(t.shape), t.dtype, device, fill=t)


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
