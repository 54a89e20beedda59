"""Tiered decode path for dense decoders: the paper's system end to end.

Counterpart of the single-chip dense part of
``src/repro/serving/tiered_decode.py``.  Params come from
``TieringPlan.partition`` (stacked leaves, tierable operands wrapped in
`TieredTensor`); dispatch is by operand type: every tiered weight goes
through the direct-access GEMM (`kernels.ops.tiered_matmul`) and the KV
cache is attended by the paged tiered attention kernel
(`kernels.ops.paged_decode_attention`), both under the congestion
``window`` passed per step (it paces copies, never changes results).

Not ported yet: MLA, MoE, SSM and hybrid steps, the mesh fetch, and the
deprecated batch-split ``tiered_decode_step``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiering import TieredTensor
from repro_torch.kernels import ops
from repro_torch.kernels.splitk_flashattn import scatter_rows
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.model import layer_slice
from repro_torch.serving.paged_cache import LOCAL, REMOTE


def _mm(x: torch.Tensor, w: Any, window: int) -> torch.Tensor:
    if isinstance(w, TieredTensor):
        return ops.tiered_matmul(x, w, window=window)
    return x @ w


# A `write_and_attend(layer, q, k_new, v_new, scale=None)` callback writes the
# new K/V row of every slot into the cache and attends (q [B,Hq,w];
# k_new/v_new [B,1,Kh,w]; returns attn [B,Hq,w]).
WriteAndAttend = Callable[..., torch.Tensor]


def _gqa_attend(cfg: ModelConfig, lp: dict[str, Any], hn: torch.Tensor,
                positions: torch.Tensor, idx: int, window: int,
                write_and_attend: WriteAndAttend) -> torch.Tensor:
    """GQA attention over the injected cache: returns [B,1,Hp*hd] (pre-wo)."""
    hd, hp = cfg.resolved_head_dim, cfg.padded_heads
    b = hn.shape[0]
    q, k_new, v_new = L.qkv_project(cfg, hn, lp, mm=lambda a, w: _mm(a, w, window))
    q, k_new = L._maybe_qk_norm(cfg, q, k_new, lp)
    rot = int(hd * cfg.rope_fraction)
    if rot:
        cos, sin = L.rope_cos_sin(positions[:, None], rot, cfg.rope_theta)
        q = L.apply_rope(q, cos, sin, rot)
        k_new = L.apply_rope(k_new, cos, sin, rot)
    attn = write_and_attend(idx, q[:, 0], k_new, v_new)     # [B,Hp,hd]
    return attn.reshape(b, 1, hp * hd)


def _head(cfg: ModelConfig, params: dict[str, Any], x: torch.Tensor,
          window: int) -> torch.Tensor:
    return M.lm_head(cfg, params, x, mm=lambda a, w: _mm(a, w, window))


def _decode_transformer(
    cfg: ModelConfig,
    params: dict[str, Any],          # stacked tree from TieringPlan.partition
    tokens: torch.Tensor,            # [B,1] int
    positions: torch.Tensor,         # [B] int per-slot write positions
    window: int,
    write_and_attend: WriteAndAttend,
) -> torch.Tensor:
    """Decode body of the dense decoder: tiered weights run the
    direct-access GEMM, attention runs through `write_and_attend`."""
    x = params["embed"][tokens.long()]                # [B,1,d]

    def kmm(a, w):
        return _mm(a, w, window)

    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        hn = L.norm(cfg, x, lp, "ln1")
        attn = _gqa_attend(cfg, lp, hn, positions, i, window, write_and_attend)
        x = x + _mm(attn, lp["wo"], window)
        x = x + L.mlp_block(cfg, L.norm(cfg, x, lp, "ln2"), lp, mm=kmm)
    return _head(cfg, params, x, window)


def _paged_writer(
    pools: dict[str, torch.Tensor],
    table: torch.Tensor, tier: torch.Tensor, attn_lens: torch.Tensor,
    wr_tier: torch.Tensor, wr_idx: torch.Tensor, wr_off: torch.Tensor,
    sink_local: int, sink_remote: int, window: int,
) -> WriteAndAttend:
    """write_and_attend over a paged tiered pool set (writes `pools` in
    place).  Each slot's row goes to its target page in one tier; on the
    CPU the other tier's sink receives it too, as in the reference (never
    read back), while the CUDA writer skips that write.  Attention reads
    each slot's pages from the tier its page table names, masked to
    ``attn_lens``.  ``v_new=None`` means a K-only cache: V reads the K
    pool."""

    def write_and_attend(i, q, k_new, v_new, scale=None):
        rows = (("k", k_new),) if v_new is None else (("k", k_new), ("v", v_new))
        for name, new in rows:
            for suffix, tier_sel, sink in (("local", LOCAL, sink_local),
                                           ("remote", REMOTE, sink_remote)):
                pool = pools[f"{name}_{suffix}"][i]
                scatter_rows(pool, new[:, 0].to(pool.dtype).contiguous(), wr_tier,
                             wr_idx, wr_off, tier_sel, sink, remote=suffix == "remote")
        v_name = "k" if v_new is None else "v"
        layer_pools = {"k_local": pools["k_local"][i],
                       "k_remote": pools["k_remote"][i],
                       "v_local": pools[f"{v_name}_local"][i],
                       "v_remote": pools[f"{v_name}_remote"][i]}
        return ops.paged_decode_attention(q, layer_pools, table, tier, attn_lens,
                                          window=window, scale=scale)

    return write_and_attend


def paged_tiered_decode_step(
    cfg: ModelConfig,
    params: dict[str, Any],          # stacked tree from TieringPlan.partition
    pools: dict[str, torch.Tensor],  # PagedTieredCache.pools {k,v}_{local,remote}
    tokens: torch.Tensor,            # [B,1] int
    positions: torch.Tensor,         # [B] int32 — per-slot write position
    attn_lens: torch.Tensor,         # [B] int32 — post-write lengths (0 = idle)
    table: torch.Tensor,             # [B, MP] int32 page table
    tier: torch.Tensor,              # [B, MP] int32 page tiers
    wr_tier: torch.Tensor,           # [B] int32 write-target tier
    wr_idx: torch.Tensor,            # [B] int32 write-target page index
    wr_off: torch.Tensor,            # [B] int32 in-page offset
    *,
    sink_local: int,
    sink_remote: int,
    window: int = 2,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One ragged decode step over tiered weights + paged tiered KV.

    Every slot writes its new K/V row into the page named by
    (wr_tier, wr_idx, wr_off); idle slots must be pointed at a sink page
    by the caller.  The pools are updated in place and returned."""
    pools = dict(pools)
    write_and_attend = _paged_writer(
        pools, table, tier, attn_lens, wr_tier, wr_idx, wr_off,
        sink_local, sink_remote, window)
    logits = _decode_transformer(cfg, params, tokens, positions, window,
                                 write_and_attend)
    return logits, pools
