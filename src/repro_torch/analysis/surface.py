"""Abstract model surface for the static verifier.

The materialization lint must trace *full-size* configs (llama2-7B ...
DeepSeek-V2-236B) without ever allocating their parameters.  On the
``meta`` device a tensor has a shape and a dtype and no storage, and every
aten op the port's steps run computes its output's shape there, so the
full-size parameter tree, its tiered split and the KV pools are built on
it.  A structural mirror of ``TieringPlan.partition`` splits the abstract
leaves into ``TieredTensor(local, remote)`` pairs, and the remote tiers are
marked (:func:`mark_remote`) so the lint can recover, from the flattened
argument list alone, which inputs hold host-resident data.

Counterpart of ``src/repro/analysis/surface.py``: meta tensors play the
role of ``ShapeDtypeStruct``, a marked meta tensor that of ``RemoteLeaf``,
and :func:`flatten` walks a tree in ``jax.tree_util``'s order.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import tiering
from repro_torch.core.engine import TieringPlan
from repro_torch.core.tiering import TieredTensor
from repro_torch.models import model as M
from repro_torch.models.registry import operand_registry, resolve

_REMOTE = "_dak_remote"


def mark_remote(t: torch.Tensor) -> torch.Tensor:
    """Mark `t` as host-tier (remote) data for the lint; returns `t`."""
    setattr(t, _REMOTE, True)
    return t


def is_remote(t: Any) -> bool:
    return bool(getattr(t, _REMOTE, False))


def remote_leaf(shape: tuple[int, ...], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A marked remote tensor of `shape` on the meta device (no storage)."""
    return mark_remote(torch.empty(tuple(shape), dtype=dtype, device="meta"))


def flatten(tree: Any) -> list[tuple[Any, bool]]:
    """``(leaf, remote)`` pairs of `tree` in ``jax.tree_util.tree_leaves``
    order: dict keys sorted, tuples and lists in order, a `TieredTensor` as
    its local tier, its remote tier and its shard (where it has one), None
    no leaf.  ``remote`` flags a tiered operand's remote tier or shard and
    any tensor marked by :func:`mark_remote`."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in flatten(v)]
    if isinstance(tree, TieredTensor):
        return flatten(tree.local) + [(t, True) for t in (tree.remote, tree.shard)
                                      if t is not None]
    return [] if tree is None else [(tree, is_remote(tree))]


def abstract_params(cfg) -> dict[str, Any]:
    """The full-size fp32 param tree of `models.init_params` on the meta
    device (no allocation): the top-level leaves and the stacked layers."""
    src = M.layer_source(cfg, None, device="meta")
    layers = {k: torch.empty((src.n_layers, *v.shape), dtype=v.dtype, device="meta")
              for k, v in src.shapes.items()}
    return {"layers": layers, **src.top}


def partition_abstract(cfg, plan: TieringPlan, params: Any = None, *,
                       align: int = 1) -> dict[str, Any]:
    """Structural mirror of ``TieringPlan.partition`` over abstract leaves.

    Reuses the plan's registry, ratio lookup and ``lcm(align, P)`` mesh
    rounding (`TieringPlan._split_spec`) and `tiering.split_sizes`, so the
    mirrored extents are exactly what the real partitioner realizes; only
    the leaves differ: fresh meta tensors, the remote one marked."""
    if params is None:
        params = abstract_params(cfg)
    out = _copy_tree(params)
    for od in plan.registry:
        split = plan._split_spec(od, align)
        if split is None:
            continue
        leaf = resolve(params, od.path)
        axis = od.axis % leaf.dim()
        n_local, n_remote = tiering.split_sizes(leaf.shape[axis], *split)
        if n_remote == 0:
            continue
        local_shape, remote_shape = list(leaf.shape), list(leaf.shape)
        local_shape[axis], remote_shape[axis] = n_local, n_remote
        _set_path(out, od.path, TieredTensor(
            local=torch.empty(local_shape, dtype=leaf.dtype, device="meta"),
            remote=remote_leaf(tuple(remote_shape), leaf.dtype), axis=od.axis))
    return out


def operand_shapes(cfg, params: Any = None) -> dict[str, tuple[int, ...]]:
    """Registry ``path_str`` -> full (unsplit) leaf shape, abstractly."""
    if params is None:
        params = abstract_params(cfg)
    shapes: dict[str, tuple[int, ...]] = {}
    for od in operand_registry(cfg):
        try:
            shapes[od.path_str] = tuple(resolve(params, od.path).shape)
        except KeyError:
            continue  # registry names an optional leaf this config lacks
    return shapes


def abstract_kv_pools(cfg, *, local_pages: int, remote_pages: int,
                      page_size: int) -> dict[str, torch.Tensor]:
    """Abstract fp32 ``PagedTieredCache.pools`` with the remote pools marked
    (layout from ``serving.paged_cache``: +1 sink page per pool; MLA's
    single latent ``k`` of one kv head; a hybrid's attention layers only)."""
    if getattr(cfg, "use_mla", False):
        kv_names: tuple[str, ...] = ("k",)
        kh, hd = 1, cfg.kv_lora_rank + cfg.rope_head_dim
    else:
        kv_names = ("k", "v")
        kh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    n_layers = cfg.n_layers
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        n_layers = cfg.n_layers // cfg.hybrid_attn_every
    pools: dict[str, torch.Tensor] = {}
    for name in kv_names:
        for suffix, pages in (("local", local_pages), ("remote", remote_pages)):
            shape = (n_layers, pages + 1, page_size, kh, hd)
            pools[f"{name}_{suffix}"] = (remote_leaf(shape) if suffix == "remote"
                                         else torch.empty(shape, device="meta"))
    return pools


def _copy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _set_path(tree: dict[str, Any], path: tuple[str, ...], value: Any) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value
