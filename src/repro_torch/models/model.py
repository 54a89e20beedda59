"""Dense, MoE and MLA decoders: init / prefill / decode in PyTorch.

Counterpart of the attention-decoder branches of ``src/repro/models/model.py``
(dense GQA, MoE with GQA, DeepSeek-V2's MLA with MoE).  Layer parameters
are stacked along a leading ``n_layers`` axis (the reference's layout, so
bridged weights and `TieringPlan.partition` line up); where the reference
scans over that axis, the port loops.  `prefill` and `decode_step`
together are the plain per-request reference the serving engine is
checked against.  Every entry point takes ``mm``, the tier-aware matmul,
so the engine can run the same code through the direct-access kernel.
Not ported yet: the ssm, hybrid, encoder and vlm families.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = dict[str, Any]
Cache = dict[str, torch.Tensor]

_INIT_STD = 0.02


SERVED_FAMILIES = ("dense", "moe")     # MoE with or without MLA


def require_served(cfg: ModelConfig) -> None:
    """Refuse the families the port does not run yet."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"the PyTorch port serves dense and MoE decoders (MLA included) so far, "
            f"not {cfg.name} ({cfg.family}); ssm, hybrid, encoder and vlm are still "
            f"to be ported")


def layer_slice(layers: Any, i: int) -> Any:
    """Layer `i` of a stacked (possibly tiered) layer tree."""
    return {k: v[i] for k, v in layers.items()}


# ==========================================================================
# Init
# ==========================================================================
def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """Random weights with the reference's layout and std: N(0, 0.02) for
    matrices, ones for norm weights, zeros beyond `n_heads` in the padded
    query heads and for biases.  Drawn in fp32 from `generator` (which must
    live on `device`) and cast leaf by leaf, so the fp32 copy of only one
    leaf is alive at a time.  The layer tree is the reference's
    (`_attn_params` or `_mla_params`, then `_mlp_params` or `_moe_params`)."""
    require_served(cfg)
    device = torch.device(device)

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device) * _INIT_STD
        return w.to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    nl, d, hd, hp = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim, cfg.padded_heads
    layers: Params = {"ln1_w": ones(nl, d), "ln2_w": ones(nl, d)}
    if cfg.norm == "layernorm":
        layers["ln1_b"], layers["ln2_b"] = zeros(nl, d), zeros(nl, d)
    if cfg.use_mla:
        h, nd, rd, vd = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        layers.update({
            "wkv_a": dense(nl, d, cfg.kv_lora_rank + rd),
            "kv_a_norm_w": ones(nl, cfg.kv_lora_rank),
            "wkv_b": dense(nl, cfg.kv_lora_rank, h * (nd + vd)),
            "wo": dense(nl, h * vd, d),
        })
        if cfg.q_lora_rank:
            layers["wq_a"] = dense(nl, d, cfg.q_lora_rank)
            layers["q_a_norm_w"] = ones(nl, cfg.q_lora_rank)
            layers["wq_b"] = dense(nl, cfg.q_lora_rank, h * (nd + rd))
        else:
            layers["wq_b"] = dense(nl, d, h * (nd + rd))
    else:
        wq, wo = dense(nl, d, hp * hd), dense(nl, hp * hd, d)
        if hp > cfg.n_heads:
            # padded query heads: zero weights beyond n_heads — numerically exact
            wq[..., cfg.n_heads * hd:] = 0
            wo[..., cfg.n_heads * hd:, :] = 0
        layers.update({"wq": wq, "wkv": dense(nl, d, 2 * cfg.n_kv_heads * hd), "wo": wo})
        if cfg.qkv_bias:
            layers["bq"] = zeros(nl, hp * hd)
            layers["bkv"] = zeros(nl, 2 * cfg.n_kv_heads * hd)
        if cfg.qk_norm:
            layers["q_norm_w"] = ones(nl, hd)
            layers["k_norm_w"] = ones(nl, hd)
    if cfg.family == "moe":
        e, ff = cfg.n_experts, cfg.moe_d_ff
        layers.update({
            "router": dense(nl, d, e),
            "experts_wi": dense(nl, e, d, 2 * ff),
            "experts_wdown": dense(nl, e, ff, d),
        })
        if cfg.n_shared_experts:
            sf = ff * cfg.n_shared_experts
            layers["shared_wi"] = dense(nl, d, 2 * sf)
            layers["shared_wdown"] = dense(nl, sf, d)
    else:
        mult = 2 if cfg.mlp == "swiglu" else 1
        layers["wi"] = dense(nl, d, mult * cfg.d_ff)
        layers["wdown"] = dense(nl, cfg.d_ff, d)
        if cfg.norm == "layernorm":       # bias-ful families
            layers["bi"], layers["bdown"] = zeros(nl, mult * cfg.d_ff), zeros(nl, d)
    p: Params = {"layers": layers, "embed": dense(cfg.vocab, d), "final_w": ones(d)}
    if cfg.norm == "layernorm":
        p["final_b"] = zeros(d)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense(d, cfg.vocab)
    return p


# ==========================================================================
# Embedding / head
# ==========================================================================
def embed_inputs(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor]) -> torch.Tensor:
    return params["embed"][batch["tokens"].long()]


def lm_head(cfg: ModelConfig, params: Params, x: torch.Tensor,
            mm: L.Matmul = L.matmul) -> torch.Tensor:
    x = (L.layernorm(x, params["final_w"], params["final_b"], cfg.norm_eps)
         if cfg.norm == "layernorm" else L.rmsnorm(x, params["final_w"], cfg.norm_eps))
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mm(x, w)


# ==========================================================================
# KV cache
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32, device="cuda") -> Cache:
    """Zeroed dense cache: {k, v: [L, B, S, Kh, hd]}, or MLA's latent
    {ckv: [L, B, S, rank], krope: [L, B, S, rd]}."""
    require_served(cfg)
    nl = cfg.n_layers
    if cfg.use_mla:
        return {"ckv": torch.zeros((nl, batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                   device=device),
                "krope": torch.zeros((nl, batch, max_len, cfg.rope_head_dim), dtype=dtype,
                                     device=device)}
    shape = (nl, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ffn(cfg: ModelConfig, x: torch.Tensor, lp: Params, mm: L.Matmul) -> torch.Tensor:
    """The layer's FFN on its normed input: MoE or the dense MLP."""
    h = L.norm(cfg, x, lp, "ln2")
    return L.moe_block(cfg, h, lp, mm=mm) if cfg.family == "moe" else L.mlp_block(cfg, h, lp, mm=mm)


# ==========================================================================
# Prefill: forward pass that also fills the cache
# ==========================================================================
def prefill(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            max_len: int | None = None,
            mm: L.Matmul = L.matmul) -> tuple[torch.Tensor, Cache]:
    """Whole-prompt forward.  Returns (logits [B,1,vocab] at the last
    position, the cache of `init_cache`'s layout zero-padded past the
    prompt).  Attention is plain PyTorch, as in the reference."""
    require_served(cfg)
    x = embed_inputs(cfg, params, batch)
    bsz, t = x.shape[:2]
    max_len = max_len or t
    positions = torch.arange(t, device=x.device)
    rot = int(cfg.resolved_head_dim * cfg.rope_fraction)
    entries: dict[str, list[torch.Tensor]] = {}
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        hn = L.norm(cfg, x, lp, "ln1")
        if cfg.use_mla:
            ckv, krope = L.mla_project_kv_latent(cfg, hn, lp, mm=mm)
            rd = cfg.rope_head_dim
            cos, sin = L.rope_cos_sin(positions, rd, cfg.rope_theta)
            krope = L.apply_rope(krope[..., None, :], cos, sin, rd)[..., 0, :]
            x = x + L.mla_attention_block(cfg, hn, lp, positions, causal=True, mm=mm)
            layer_cache = {"ckv": ckv, "krope": krope}
        else:
            q, k, v = L.qkv_project(cfg, hn, lp, mm=mm)
            q, k = L._maybe_qk_norm(cfg, q, k, lp)
            if rot:
                cos, sin = L.rope_cos_sin(positions, rot, cfg.rope_theta)
                q = L.apply_rope(q, cos, sin, rot)
                k = L.apply_rope(k, cos, sin, rot)
            attn = L.attend(cfg, q, k, v, causal=True)
            x = x + mm(attn.reshape(bsz, t, -1), lp["wo"])
            layer_cache = {"k": k, "v": v}
        x = x + _ffn(cfg, x, lp, mm)
        for name, c in layer_cache.items():
            entries.setdefault(name, []).append(c)
    cache = {}
    for name, cs in entries.items():
        full = torch.stack(cs)                            # [L, B, T, ...]
        pad = [0, 0] * (full.dim() - 3) + [0, max_len - t]
        cache[name] = torch.nn.functional.pad(full, pad)
    return lm_head(cfg, params, x[:, -1:], mm=mm), cache


# ==========================================================================
# Decode: one token, cache update
# ==========================================================================
def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos,
                mm: L.Matmul = L.matmul) -> tuple[torch.Tensor, Cache]:
    """tokens: [B,1]; pos: the position to write — an int for a
    slot-aligned batch, or a [B] tensor for a ragged batch.  Returns
    (logits [B,1,vocab], the updated cache)."""
    require_served(cfg)
    x = params["embed"][tokens.long()]
    names = ("ckv", "krope") if cfg.use_mla else ("k", "v")
    new: dict[str, list[torch.Tensor]] = {name: [] for name in names}
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        hn = L.norm(cfg, x, lp, "ln1")
        decode = L.mla_decode if cfg.use_mla else L.attention_decode
        attn, c0, c1 = decode(cfg, hn, lp, cache[names[0]][i], cache[names[1]][i], pos, mm=mm)
        x = x + attn
        x = x + _ffn(cfg, x, lp, mm)
        new[names[0]].append(c0)
        new[names[1]].append(c1)
    return lm_head(cfg, params, x, mm=mm), {name: torch.stack(cs) for name, cs in new.items()}
