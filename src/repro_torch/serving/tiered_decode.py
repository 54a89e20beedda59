"""Tiered decode path for every decoder family the port serves: the
paper's system end to end.

Counterpart of the single-chip part of ``src/repro/serving/tiered_decode.py``.
Params come from ``TieringPlan.partition`` (stacked leaves, tierable
operands wrapped in `TieredTensor`); dispatch is by operand type: every
column-split weight goes through the direct-access GEMM
(`kernels.ops.tiered_matmul`), and a tiered MoE expert stack runs
`models.layers.tiered_expert_ffn`, whose remote experts go through the
grouped GEMM (`kernels.splitk_gemm.splitk_gemm_grouped`, one launch per
expert matrix a layer), all under the congestion ``window`` passed per step
(it paces copies, never changes results).  Every step takes an optional
``tuner`` (`kernels.autotune.Autotuner`), threaded into each GEMM and
attention call as the reference threads its own.  The steps:

* ``paged_tiered_decode_step`` — dense, MoE and MLA decoders: the serving
  engine's ragged step over the paged tiered cache, attended by the paged
  kernel (`kernels.ops.paged_decode_attention`): GQA, or MLA's latent
  ``[ckv | k_rope]`` as single-head K-only pages attended in absorbed form
  with the model's ``(nd+rd)**-0.5`` scale.
* ``tiered_ssm_decode_step`` — pure-SSM decoders (no KV cache): recurrent
  Mamba-2 steps whose projections run through the tiered GEMM; the conv
  window and SSD state stay in HBM, one row per slot.
* ``tiered_hybrid_decode_step`` — Zamba2-style hybrids: each group's shared
  attention + MLP block (GQA over the group's layer of the paged tiered
  cache, its projections tiered) and then its tiered SSM layers.
* ``split_cache_batch`` + ``tiered_decode_step`` — the paper's §5
  slot-aligned layout, kept for the kernel experiments (GQA decoders only, as
  in the reference): a dense cache split along the batch, remote requests'
  rows in pinned host memory, attended by the batch-split kernel
  (`kernels.ops.tiered_decode_attention`).

Not ported: the reference's deprecated ``partition_dense_params`` shim and
its ``TIERABLE`` list (``TieringPlan.partition`` is the one partition path
here).  Not ported yet: the mesh fetch (``fetch_remote_shards``).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiering import TieredTensor
from repro_torch.kernels import _build, ops
from repro_torch.kernels.splitk_flashattn import scatter_rows
from repro_torch.kernels.splitk_gemm import splitk_gemm_grouped
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.model import layer_slice
from repro_torch.serving.paged_cache import LOCAL, REMOTE


def split_cache_batch(cache: dict[str, torch.Tensor], kv_ratio: float,
                      align: int = 1) -> dict[str, torch.Tensor]:
    """Batch-split a dense KV cache {k, v: [L, B, S, Kh, hd]} across tiers
    (paper §5: SplitK_FlashAttn partitions the KV cache along the batch).

    Requests [0, B_loc) stay local and the last B_rem ~ kv_ratio * B go
    remote.  Both halves are fresh copies: the local one on the cache's
    device, the remote one, on a CUDA device, in one exact-size pinned,
    device-mapped host buffer (`kernels._build.pinned_empty`).  A caller
    that drops the unsplit cache frees it, so the remote half does not stay
    in HBM."""
    b = cache["k"].shape[1]
    b_rem = int(round(b * kv_ratio / align)) * align
    b_loc = b - b_rem
    out = {}
    for name in ("k", "v"):
        full = cache[name]
        out[f"{name}_local"] = full[:, :b_loc].clone(memory_format=torch.contiguous_format)
        remote = full[:, b_loc:]
        if full.device.type == "cuda":
            out[f"{name}_remote"] = _build.pinned_empty(remote.shape, remote.dtype)
            out[f"{name}_remote"].copy_(remote)
        else:
            out[f"{name}_remote"] = remote.clone(memory_format=torch.contiguous_format)
    return out


def _mm(x: torch.Tensor, w: Any, window: int, tuner: Any = None) -> torch.Tensor:
    if isinstance(w, TieredTensor):
        return ops.tiered_matmul(x, w, window=window, tuner=tuner)
    return x @ w


def kernel_grouped_mm(window: int) -> Callable[..., torch.Tensor]:
    """The grouped remote-expert product every tiered MoE path runs,
    ``(x [E, M, K], w_remote [E, K, N], counts [E]) -> [E, M, N]``: the
    grouped direct-access GEMM, one launch over the expert stack."""
    return lambda x, w, counts: splitk_gemm_grouped(x, w, counts, window=window)


def kernel_mm(window: int, tuner: Any = None) -> Callable[[torch.Tensor, Any], torch.Tensor]:
    """The tier-aware matmul every tiered path runs, as an ``mm`` for the
    model's layers: the direct-access GEMM for a tiered weight (tuned by
    ``tuner`` when one is given), a plain product otherwise; its
    ``grouped`` is `kernel_grouped_mm` at the same window, for a tiered
    expert stack (which takes no tuned knob)."""
    def mm(a: torch.Tensor, w: Any) -> torch.Tensor:
        return _mm(a, w, window, tuner)

    mm.grouped = kernel_grouped_mm(window)
    return mm


# A `write_and_attend(layer, q, k_new, v_new, scale=None)` callback writes the
# new K/V row of every slot into the cache and attends (q [B,Hq,w];
# k_new/v_new [B,1,Kh,w]; returns attn [B,Hq,w]).
WriteAndAttend = Callable[..., torch.Tensor]


def _gqa_attend(cfg: ModelConfig, lp: dict[str, Any], hn: torch.Tensor,
                positions: torch.Tensor, idx: int, window: int,
                write_and_attend: WriteAndAttend, tuner: Any = None) -> torch.Tensor:
    """GQA attention over the injected cache: returns [B,1,Hp*hd] (pre-wo)."""
    hd, hp = cfg.resolved_head_dim, cfg.padded_heads
    b = hn.shape[0]
    q, k_new, v_new = L.qkv_project(cfg, hn, lp, mm=kernel_mm(window, tuner))
    q, k_new = L._maybe_qk_norm(cfg, q, k_new, lp)
    rot = int(hd * cfg.rope_fraction)
    if rot:
        cos, sin = L.rope_cos_sin(positions[:, None], rot, cfg.rope_theta)
        q = L.apply_rope(q, cos, sin, rot)
        k_new = L.apply_rope(k_new, cos, sin, rot)
    attn = write_and_attend(idx, q[:, 0], k_new, v_new)     # [B,Hp,hd]
    return attn.reshape(b, 1, hp * hd)


def _mla_attend(cfg: ModelConfig, lp: dict[str, Any], hn: torch.Tensor,
                positions: torch.Tensor, idx: int, window: int,
                write_and_attend: WriteAndAttend, tuner: Any = None) -> torch.Tensor:
    """Absorbed-form MLA over latent-width pages: returns [B,1,H*vd] (pre-wo).

    The page row is the latent ``[ckv | k_rope]`` (one kv head, width
    rank+rd); q is the absorbed ``[q·W_uk | q_rope]``, so the kernel's
    scores and accumulation run in latent space (`layers.mla_decode`'s
    arithmetic).  V aliases the K page (``v_new=None``): probs @
    ``[ckv | k_rope]`` sliced to ``:rank`` is probs @ ckv, so the latent is
    stored once.  ``wkv_b`` is HBM-resident (not in the registry)."""
    h, rd, vd = cfg.n_heads, cfg.rope_head_dim, cfg.v_head_dim
    rank = cfg.kv_lora_rank
    b = hn.shape[0]
    kmm = kernel_mm(window, tuner)
    q_nope, q_rope = L.mla_project_q(cfg, hn, lp, mm=kmm)         # [B,1,H,*]
    c_kv, k_rope = L.mla_project_kv_latent(cfg, hn, lp, mm=kmm)   # [B,1,*]
    cos, sin = L.rope_cos_sin(positions[:, None], rd, cfg.rope_theta)
    q_rope = L.apply_rope(q_rope, cos, sin, rd)
    k_rope = L.apply_rope(k_rope[..., None, :], cos, sin, rd)[..., 0, :]
    w_uk, w_uv = L.mla_absorbed_weights(cfg, lp)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)      # [B,H,rank]
    q_cat = torch.cat([q_lat, q_rope[:, 0]], dim=-1)              # [B,H,rank+rd]
    k_new = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]      # [B,1,1,rank+rd]
    o = write_and_attend(idx, q_cat, k_new, None, scale=(cfg.nope_head_dim + rd) ** -0.5)
    return torch.einsum("bhr,rhv->bhv", o[..., :rank], w_uv).reshape(b, 1, h * vd)


def _head(cfg: ModelConfig, params: dict[str, Any], x: torch.Tensor,
          window: int, tuner: Any = None) -> torch.Tensor:
    return M.lm_head(cfg, params, x, mm=kernel_mm(window, tuner))


def _decode_transformer(
    cfg: ModelConfig,
    params: dict[str, Any],          # stacked tree from TieringPlan.partition
    tokens: torch.Tensor,            # [B,1] int
    positions: torch.Tensor,         # [B] int per-slot write positions
    window: int,
    write_and_attend: WriteAndAttend,
    tuner: Any = None,
) -> torch.Tensor:
    """Shared decode body of the dense, MoE and MLA decoders: the
    attention flavour and the FFN are picked per family; tiered weights run
    the direct-access GEMM, attention runs through `write_and_attend`."""
    x = params["embed"][tokens.long()]                # [B,1,d]
    kmm = kernel_mm(window, tuner)
    attend = _mla_attend if cfg.use_mla else _gqa_attend
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        hn = L.norm(cfg, x, lp, "ln1")
        attn = attend(cfg, lp, hn, positions, i, window, write_and_attend, tuner)
        x = x + _mm(attn, lp["wo"], window, tuner)
        hn2 = L.norm(cfg, x, lp, "ln2")
        if cfg.family == "moe":
            x = x + L.moe_block(cfg, hn2, lp, mm=kmm)
        else:
            x = x + L.mlp_block(cfg, hn2, lp, mm=kmm)
    return _head(cfg, params, x, window, tuner)


def tiered_decode_step(
    cfg: ModelConfig,
    params: dict[str, Any],          # stacked tiered params
    cache: dict[str, torch.Tensor],  # from split_cache_batch
    tokens: torch.Tensor,            # [B,1] int
    pos: int,
    *,
    window: int = 2,
    tuner: Any = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One slot-aligned decode step over tiered weights + batch-split KV
    (the paper's §5 layout; GQA decoders, dense or MoE, as in the
    reference).  Every request writes its new K/V row at ``pos`` in its own
    tier, in place, and attends positions [0, pos]; returns (logits
    [B,1,vocab], the cache)."""
    if cfg.use_mla:
        raise NotImplementedError("the batch-split layout takes GQA caches, not MLA's latent")
    b = tokens.shape[0]
    b_loc = cache["k_local"].shape[1]
    b_rem = b - b_loc
    dev = tokens.device
    # Remote rows go through the row writer, each remote request's
    # [S, Kh, hd] cache seen as one page of S rows (a CUDA index_put_ cannot
    # write host memory): request r writes page r at offset pos.
    wr_tier = torch.zeros(b_rem, dtype=torch.int32, device=dev)
    wr_idx = torch.arange(b_rem, dtype=torch.int32, device=dev)
    wr_off = torch.full((b_rem,), pos, dtype=torch.int32, device=dev)

    def write_and_attend(i, q, k_new, v_new, scale=None):   # GQA: no scale override
        for name, new in (("k", k_new), ("v", v_new)):
            local, remote = cache[f"{name}_local"][i], cache[f"{name}_remote"][i]
            if b_loc:
                local[:, pos] = new[:b_loc, 0].to(local.dtype)
            if b_rem:
                scatter_rows(remote, new[b_loc:, 0].to(remote.dtype).contiguous(), wr_tier,
                             wr_idx, wr_off, 0, b_rem, remote=True)
        layer = {key: cache[key][i] for key in ("k_local", "v_local", "k_remote", "v_remote")}
        return ops.tiered_decode_attention(q, layer, kv_len=pos + 1, window=window,
                                           tuner=tuner)

    positions = torch.full((b,), pos, dtype=torch.int32, device=dev)
    logits = _decode_transformer(cfg, params, tokens, positions, window, write_and_attend,
                                 tuner)
    return logits, cache


def _paged_writer(
    pools: dict[str, torch.Tensor],
    table: torch.Tensor, tier: torch.Tensor, attn_lens: torch.Tensor,
    wr_tier: torch.Tensor, wr_idx: torch.Tensor, wr_off: torch.Tensor,
    sink_local: int, sink_remote: int, window: int, tuner: Any = None,
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
                                          window=window, scale=scale, tuner=tuner)

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
    tuner: Any = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One ragged decode step over tiered weights + paged tiered KV.

    Every slot writes its new K/V row into the page named by
    (wr_tier, wr_idx, wr_off); idle slots must be pointed at a sink page
    by the caller.  The pools are updated in place and returned."""
    pools = dict(pools)
    write_and_attend = _paged_writer(
        pools, table, tier, attn_lens, wr_tier, wr_idx, wr_off,
        sink_local, sink_remote, window, tuner)
    logits = _decode_transformer(cfg, params, tokens, positions, window,
                                 write_and_attend, tuner)
    return logits, pools


def tiered_ssm_decode_step(
    cfg: ModelConfig,
    params: dict[str, Any],          # stacked tree from TieringPlan.partition
    cache: dict[str, torch.Tensor],  # {conv: [L,B,W-1,C], state: [L,B,H,P,S]}
    tokens: torch.Tensor,            # [B,1] int
    *,
    window: int = 2,
    tuner: Any = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One recurrent decode step for pure-SSM decoders over tiered weights.

    No KV cache: the conv window and SSD state are per-slot recurrent
    state, in HBM; the offloaded operands are the projection stacks
    (``ssm_in`` / ``ssm_out``) and lm_head, computed by the tiered GEMM.
    Every slot steps, idle ones too (their state is overwritten when a
    request is admitted).  The cache is updated in place, a layer at a
    time; returns (logits [B,1,vocab], the cache)."""
    return _recurrent_step(cfg, params, cache, tokens, window, None, None, tuner)


def tiered_hybrid_decode_step(
    cfg: ModelConfig,
    params: dict[str, Any],          # stacked tree from TieringPlan.partition
    cache: dict[str, torch.Tensor],  # SSM state {conv, state} (all layers)
    pools: dict[str, torch.Tensor],  # paged KV pools (one layer per group)
    tokens: torch.Tensor,            # [B,1] int
    positions: torch.Tensor,         # [B] int32 — per-slot write position
    attn_lens: torch.Tensor,         # [B] int32 — post-write lengths (0 = idle)
    table: torch.Tensor,
    tier: torch.Tensor,
    wr_tier: torch.Tensor,
    wr_idx: torch.Tensor,
    wr_off: torch.Tensor,
    *,
    sink_local: int,
    sink_remote: int,
    window: int = 2,
    tuner: Any = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """One ragged decode step for Zamba2-style hybrids: each group runs its
    shared attention + MLP block (GQA over the group's paged tiered KV
    layer, written through the paged writer) and then
    ``hybrid_attn_every`` tiered SSM layers.  Returns (logits, the SSM
    cache and the pools, both updated in place)."""
    pools = dict(pools)
    write_and_attend = _paged_writer(
        pools, table, tier, attn_lens, wr_tier, wr_idx, wr_off,
        sink_local, sink_remote, window, tuner)
    logits, cache = _recurrent_step(cfg, params, cache, tokens, window, positions,
                                    write_and_attend, tuner)
    return logits, cache, pools


def _recurrent_step(cfg: ModelConfig, params: dict[str, Any], cache: dict[str, torch.Tensor],
                    tokens: torch.Tensor, window: int, positions: torch.Tensor | None,
                    write_and_attend: WriteAndAttend | None, tuner: Any = None
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The body of both recurrent steps: a hybrid's shared block before
    each group (`models.model.shared_block`), then every tiered SSM layer,
    whose new conv window and state overwrite its slice of `cache`."""
    x = params["embed"][tokens.long()]
    h0 = x
    kmm = kernel_mm(window, tuner)
    for i in range(cfg.n_layers):
        sp = M.shared_block(cfg, params, i)
        if sp is not None:
            z = M.shared_in(x, h0, sp)
            attn = _gqa_attend(cfg, sp, L.norm(cfg, z, sp, "ln1"), positions,
                               i // cfg.hybrid_attn_every, window, write_and_attend, tuner)
            x = M.shared_out(cfg, x, z + _mm(attn, sp["wo"], window, tuner), sp, kmm)
        lp = layer_slice(params["layers"], i)
        y, conv_i, state_i = S.ssm_block_decode(
            cfg, L.norm(cfg, x, lp, "ln1"), lp, cache["conv"][i], cache["state"][i], mm=kmm)
        x = x + y
        cache["conv"][i] = conv_i
        cache["state"][i] = state_i
    return _head(cfg, params, x, window, tuner), cache
