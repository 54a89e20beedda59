"""Distributed-optimization collectives over ``torch.distributed``:
compression and the explicit FSDP decomposition.

Counterpart of ``src/repro/distributed/collectives.py``.  The reference
calls its collectives inside ``shard_map`` by axis name; here each takes
the process group of that axis (`launch.mesh.Mesh.group`), and every rank
of the group calls it.

* ``compressed_psum`` — int8-quantized all-reduce with per-tensor scales;
  cuts gradient all-reduce bytes 4x against fp32.
* ``ErrorFeedback`` — residual accumulation, so compression error is
  carried into the next step instead of lost (1-bit/EF-SGD style).
* ``reduce_scatter_grads`` / ``all_gather_params`` — the FSDP
  decomposition spelled out, tiled along the leading axis.

Trees are nested dicts of tensors, as the port's params are.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def single_tensor_collective(name: str, old: str) -> Callable:
    """``torch.distributed``'s single-tensor collective `name`, or `old`, the
    name it had before (the card's PyTorch may predate the new one)."""
    return getattr(dist, name, None) or getattr(dist, old)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8 all-reduce: quantize locally, sum as int32, dequantize with the
    mean of the ranks' scales."""
    q, scale = quantize_int8(x.to(torch.float32))
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    scale_sum = scale.clone()
    dist.all_reduce(scale_sum, group=group)
    n = dist.get_world_size(group)
    return (total.to(torch.float32) * (scale_sum / n)).to(x.dtype)


class ErrorFeedback:
    """Residual-carrying compression: g_t' = C(g_t + e_t); e_{t+1} = g_t + e_t - g_t'."""

    @staticmethod
    def init(grads: Any) -> Any:
        return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                         grads)

    @staticmethod
    def apply(grads: Any, residual: Any) -> tuple[Any, Any]:
        """(compressed grads, new residual), each a tree like `grads`."""
        if isinstance(grads, dict):
            pairs = {k: ErrorFeedback.apply(v, residual[k]) for k, v in grads.items()}
            return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
        corrected = grads.to(torch.float32) + residual
        q, scale = quantize_int8(corrected)
        deq = dequantize_int8(q, scale)
        return deq.to(grads.dtype), corrected - deq


def reduce_scatter_grads(grads: Any, group=None) -> Any:
    """Sum every gradient over the group and keep this rank's 1/P block of
    its leading axis (tiled), or the whole sum where P does not divide it."""
    n = dist.get_world_size(group)
    reduce_scatter = single_tensor_collective("reduce_scatter_single",
                                              "reduce_scatter_tensor")

    def one(g: torch.Tensor) -> torch.Tensor:
        if g.dim() >= 1 and g.shape[0] % n == 0:
            out = torch.empty((g.shape[0] // n, *g.shape[1:]), dtype=g.dtype, device=g.device)
            reduce_scatter(out, g.contiguous(), group=group)
            return out
        out = g.clone()
        dist.all_reduce(out, group=group)
        return out

    return tree_map(one, grads)


def all_gather_params(params: Any, group=None) -> Any:
    """Every rank's block of each leaf, concatenated along the leading axis."""
    n = dist.get_world_size(group)
    all_gather = single_tensor_collective("all_gather_single", "all_gather_into_tensor")

    def one(p: torch.Tensor) -> torch.Tensor:
        out = torch.empty((p.shape[0] * n, *p.shape[1:]), dtype=p.dtype, device=p.device)
        all_gather(out, p.contiguous(), group=group)
        return out

    return tree_map(one, params)
