"""Self-contained AdamW (+ cosine schedule, global-norm clipping).

Counterpart of ``src/repro/optim/adamw.py``, the same math as plain
functions over the port's nested-dict trees (not ``torch.optim.AdamW``,
whose schedule and decay differ): the schedule is read at the step before
the increment, the bias corrections use the incremented step, weight decay
joins every leaf's step (no mask), the moments are fp32 whatever the
parameter dtype, and clipping casts back to each gradient's dtype.  The
step counter is a 0-d int32 tensor on the parameters' device.

`update` writes the new parameters and moments in place (the reference's
jitted step donates them) and returns them.  It walks each leaf in slices
of at most `CHUNK` elements, so the fp32 temporaries alive at a time are a
few slices, not a few copies of the largest stacked leaf: StarCoder2-3B's
``wi`` alone is 1.13 G elements, 4.5 GB in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch

from repro_torch.tree import leaves, tree_map

CHUNK = 1 << 25          # elements of one leaf slice (128 MB in fp32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def init(params: Any) -> dict[str, Any]:
    first = leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr * ((step + 1) / max(1, cfg.warmup_steps)).clamp(max=1.0)
    t = ((step - cfg.warmup_steps)
         / max(1, cfg.total_steps - cfg.warmup_steps)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * torch.where(step < cfg.warmup_steps, torch.ones_like(cos), cos)


def _slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of `t` along its leading axis of at most `CHUNK` elements each
    (a whole row where one row is larger); a 0-d tensor whole, and a DTensor
    whole (its shards are what a device holds; slicing a sharded axis would
    gather it)."""
    if t.dim() == 0 or t.numel() <= CHUNK or hasattr(t, "_local_tensor"):
        yield t
        return
    rows = max(1, CHUNK // max(1, t[0].numel()))
    yield from t.split(rows)


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of each leaf's fp32 sum
    of squares."""
    total = 0
    for g in leaves(grads):
        total = total + sum(s.float().square().sum() for s in _slices(g))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return (max_norm / (gnorm + 1e-9)).clamp(max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(g * scale).astype(g.dtype)``, as fp32."""
    out = g.float() * scale
    return out if g.dtype == torch.float32 else out.to(g.dtype).float()


def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def update(
    params: Any, grads: Any, state: dict[str, Any], cfg: AdamWConfig
) -> tuple[Any, dict[str, Any], torch.Tensor]:
    """Returns (new_params, new_state, grad_norm): `params` and the moments of
    `state` updated in place, the step counter a new tensor."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, state["step"])
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v)):
            g32 = _clipped(gs, scale)
            ms.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
            vs.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
            del g32
            step_ = (ms / b1c).div_((vs / b2c).sqrt_().add_(cfg.eps))
            p32 = ps.float()
            step_.add_(p32, alpha=cfg.weight_decay)
            ps.copy_(p32.sub_(step_.mul_(lr)))
        return p

    new_params = tree_map(upd, params, grads, state["m"], state["v"])
    return new_params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
