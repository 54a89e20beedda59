"""Dense decoder: init / prefill / decode in PyTorch.

Counterpart of the dense branches of ``src/repro/models/model.py``.  Layer
parameters are stacked along a leading ``n_layers`` axis (the reference's
layout, so bridged weights and `TieringPlan.partition` line up); where the
reference scans over that axis, the port loops.  `prefill` and
`decode_step` together are the plain per-request reference the serving
engine is checked against.  Every entry point takes ``mm``, the
tier-aware matmul, so the engine can run the same code through the
direct-access kernel.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = dict[str, Any]
Cache = dict[str, torch.Tensor]

_INIT_STD = 0.02


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.use_mla:
        raise NotImplementedError(
            f"the PyTorch port serves dense decoders so far, not {cfg.name} "
            f"({cfg.family})")


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
    query heads.  Drawn in fp32 from `generator` (which must live on
    `device`) and cast leaf by leaf, so the fp32 copy of only one leaf is
    alive at a time."""
    _require_dense(cfg)
    device = torch.device(device)

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=device) * _INIT_STD
        return w.to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    nl, d, hd, hp = cfg.n_layers, cfg.d_model, cfg.resolved_head_dim, cfg.padded_heads
    mult = 2 if cfg.mlp == "swiglu" else 1
    wq, wo = dense(nl, d, hp * hd), dense(nl, hp * hd, d)
    if hp > cfg.n_heads:
        # padded query heads: zero weights beyond n_heads — numerically exact
        wq[..., cfg.n_heads * hd:] = 0
        wo[..., cfg.n_heads * hd:, :] = 0
    layers: Params = {
        "ln1_w": ones(nl, d),
        "wq": wq,
        "wkv": dense(nl, d, 2 * cfg.n_kv_heads * hd),
        "wo": wo,
        "ln2_w": ones(nl, d),
        "wi": dense(nl, d, mult * cfg.d_ff),
        "wdown": dense(nl, cfg.d_ff, d),
    }
    if cfg.norm == "layernorm":
        for key, width in (("ln1_b", d), ("ln2_b", d), ("bi", mult * cfg.d_ff),
                           ("bdown", d)):
            layers[key] = torch.zeros((nl, width), dtype=dtype, device=device)
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((nl, hp * hd), dtype=dtype, device=device)
        layers["bkv"] = torch.zeros((nl, 2 * cfg.n_kv_heads * hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        layers["q_norm_w"] = ones(nl, hd)
        layers["k_norm_w"] = ones(nl, hd)
    p: Params = {"layers": layers, "embed": dense(cfg.vocab, d), "final_w": ones(d)}
    if cfg.norm == "layernorm":
        p["final_b"] = torch.zeros(d, dtype=dtype, device=device)
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
    _require_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ==========================================================================
# Prefill: forward pass that also fills the cache
# ==========================================================================
def prefill(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            max_len: int | None = None,
            mm: L.Matmul = L.matmul) -> tuple[torch.Tensor, Cache]:
    """Whole-prompt forward.  Returns (logits [B,1,vocab] at the last
    position, cache {k, v: [L, B, max_len, Kh, hd]} zero-padded past the
    prompt).  Attention is plain PyTorch, as in the reference."""
    _require_dense(cfg)
    x = embed_inputs(cfg, params, batch)
    bsz, t = x.shape[:2]
    max_len = max_len or t
    positions = torch.arange(t, device=x.device)
    rot = int(cfg.resolved_head_dim * cfg.rope_fraction)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        hn = L.norm(cfg, x, lp, "ln1")
        q, k, v = L.qkv_project(cfg, hn, lp, mm=mm)
        q, k = L._maybe_qk_norm(cfg, q, k, lp)
        if rot:
            cos, sin = L.rope_cos_sin(positions, rot, cfg.rope_theta)
            q = L.apply_rope(q, cos, sin, rot)
            k = L.apply_rope(k, cos, sin, rot)
        attn = L.attend(cfg, q, k, v, causal=True)
        x = x + mm(attn.reshape(bsz, t, -1), lp["wo"])
        x = x + L.mlp_block(cfg, L.norm(cfg, x, lp, "ln2"), lp, mm=mm)
        ks.append(k)
        vs.append(v)
    pad = (0, 0, 0, 0, 0, max_len - t)
    cache = {"k": torch.nn.functional.pad(torch.stack(ks), pad),
             "v": torch.nn.functional.pad(torch.stack(vs), pad)}
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
    _require_dense(cfg)
    x = params["embed"][tokens.long()]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        hn = L.norm(cfg, x, lp, "ln1")
        attn, k_c, v_c = L.attention_decode(cfg, hn, lp, cache["k"][i], cache["v"][i],
                                            pos, mm=mm)
        x = x + attn
        x = x + L.mlp_block(cfg, L.norm(cfg, x, lp, "ln2"), lp, mm=mm)
        ks.append(k_c)
        vs.append(v_c)
    return lm_head(cfg, params, x, mm=mm), {"k": torch.stack(ks), "v": torch.stack(vs)}
