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

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = dict[str, Any]
Cache = dict[str, torch.Tensor]

_INIT_STD = 0.02
_DRAW_CHUNK = 1 << 26       # elements of one fp32 draw (256 MB)


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
def _draws(generator: torch.Generator | None, dtype: torch.dtype, device):
    """The leaf makers of `init_layer` and `init_top`: N(0, 0.02) drawn in
    fp32 from `generator` in chunks of the leading axis of at most
    `_DRAW_CHUNK` elements, each cast into the leaf (so the fp32 draw alive
    at a time is one chunk, not a whole expert stack), ones and zeros."""
    def dense(*shape):
        w = torch.empty(shape, dtype=dtype, device=device)
        rows = max(1, _DRAW_CHUNK // max(1, math.prod(shape[1:])))
        for chunk in w.split(rows):
            chunk.copy_(torch.randn(chunk.shape, generator=generator, device=device)
                        .mul_(_INIT_STD))
        return w

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dense, ones, zeros


def init_layer(cfg: ModelConfig, generator: torch.Generator | None,
               dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """One layer's random weights, unstacked, with the reference's layout
    and std: N(0, 0.02) for matrices, ones for norm weights, zeros beyond
    `n_heads` in the padded query heads and for biases.  The tree is the
    reference's (`_attn_params` or `_mla_params`, then `_mlp_params` or
    `_moe_params`) without the leading layer axis.  On the meta device
    (`generator` None) it gives the leaves' shapes and dtypes only."""
    require_served(cfg)
    device = torch.device(device)
    dense, ones, zeros = _draws(generator, dtype, device)
    d, hd, hp = cfg.d_model, cfg.resolved_head_dim, cfg.padded_heads
    layer: Params = {"ln1_w": ones(d), "ln2_w": ones(d)}
    if cfg.norm == "layernorm":
        layer["ln1_b"], layer["ln2_b"] = zeros(d), zeros(d)
    if cfg.use_mla:
        h, nd, rd, vd = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        layer.update({
            "wkv_a": dense(d, cfg.kv_lora_rank + rd),
            "kv_a_norm_w": ones(cfg.kv_lora_rank),
            "wkv_b": dense(cfg.kv_lora_rank, h * (nd + vd)),
            "wo": dense(h * vd, d),
        })
        if cfg.q_lora_rank:
            layer["wq_a"] = dense(d, cfg.q_lora_rank)
            layer["q_a_norm_w"] = ones(cfg.q_lora_rank)
            layer["wq_b"] = dense(cfg.q_lora_rank, h * (nd + rd))
        else:
            layer["wq_b"] = dense(d, h * (nd + rd))
    else:
        wq, wo = dense(d, hp * hd), dense(hp * hd, d)
        if hp > cfg.n_heads:
            # padded query heads: zero weights beyond n_heads — numerically exact
            wq[..., cfg.n_heads * hd:] = 0
            wo[..., cfg.n_heads * hd:, :] = 0
        layer.update({"wq": wq, "wkv": dense(d, 2 * cfg.n_kv_heads * hd), "wo": wo})
        if cfg.qkv_bias:
            layer["bq"] = zeros(hp * hd)
            layer["bkv"] = zeros(2 * cfg.n_kv_heads * hd)
        if cfg.qk_norm:
            layer["q_norm_w"] = ones(hd)
            layer["k_norm_w"] = ones(hd)
    if cfg.family == "moe":
        e, ff = cfg.n_experts, cfg.moe_d_ff
        layer.update({
            "router": dense(d, e),
            "experts_wi": dense(e, d, 2 * ff),
            "experts_wdown": dense(e, ff, d),
        })
        if cfg.n_shared_experts:
            sf = ff * cfg.n_shared_experts
            layer["shared_wi"] = dense(d, 2 * sf)
            layer["shared_wdown"] = dense(sf, d)
    else:
        mult = 2 if cfg.mlp == "swiglu" else 1
        layer["wi"] = dense(d, mult * cfg.d_ff)
        layer["wdown"] = dense(cfg.d_ff, d)
        if cfg.norm == "layernorm":       # bias-ful families
            layer["bi"], layer["bdown"] = zeros(mult * cfg.d_ff), zeros(d)
    return layer


def init_top(cfg: ModelConfig, generator: torch.Generator | None,
             dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """The leaves outside the layer stack: `embed`, `final_w` (and
    `final_b` for LayerNorm), and `lm_head` unless the embedding is tied."""
    require_served(cfg)
    dense, ones, zeros = _draws(generator, dtype, torch.device(device))
    top: Params = {"embed": dense(cfg.vocab, cfg.d_model), "final_w": ones(cfg.d_model)}
    if cfg.norm == "layernorm":
        top["final_b"] = zeros(cfg.d_model)
    if not cfg.tie_embeddings:
        top["lm_head"] = dense(cfg.d_model, cfg.vocab)
    return top


@dataclasses.dataclass
class LayerSource:
    """A model's weights one layer at a time, so an engine can be built
    without the unsplit model ever being whole on the device.

    ``top`` holds every leaf outside the layer stack, ``shapes`` one layer's
    leaves on the meta device (shapes and dtypes), and ``layer(i)`` returns
    layer i's leaves; it is called for i = 0, 1, ... in that order, once
    each."""

    n_layers: int
    top: Params
    shapes: Params
    layer: Callable[[int], Params]

    @property
    def device(self) -> torch.device:
        return self.top["embed"].device

    @classmethod
    def from_tree(cls, params: Params) -> "LayerSource":
        """The source of a whole stacked tree (`init_params`, or the bridge)."""
        layers = params["layers"]
        return cls(n_layers=next(iter(layers.values())).shape[0],
                   top={k: v for k, v in params.items() if k != "layers"},
                   shapes={k: v[0].to("meta") for k, v in layers.items()},
                   layer=lambda i: layer_slice(layers, i))


def layer_source(cfg: ModelConfig, generator: torch.Generator | None,
                 dtype: torch.dtype = torch.float32, device="cuda") -> LayerSource:
    """`init_params`' weights as a `LayerSource`: the top-level leaves are
    drawn now, each layer when it is asked for, from the same stream in the
    same order, so the layers equal `init_params`' bit for bit."""
    top = init_top(cfg, generator, dtype, device)
    drawn = [0]

    def layer(i: int) -> Params:
        if i != drawn[0]:
            raise ValueError(f"layer {i} asked for, but the stream is at layer {drawn[0]}: "
                             f"a drawn source gives its layers in order, once each")
        drawn[0] += 1
        return init_layer(cfg, generator, dtype, device)

    return LayerSource(n_layers=cfg.n_layers, top=top,
                       shapes=init_layer(cfg, None, dtype, "meta"), layer=layer)


def init_params(cfg: ModelConfig, generator: torch.Generator | None,
                dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """Random weights with the reference's layout: `init_top`'s leaves, then
    the stack of `n_layers` `init_layer` draws from the same `generator`
    (which must live on `device`), written layer by layer into the stacks."""
    src = layer_source(cfg, generator, dtype, device)
    layers = {k: torch.empty((src.n_layers, *v.shape), dtype=v.dtype, device=src.device)
              for k, v in src.shapes.items()}
    for i in range(src.n_layers):
        for k, v in src.layer(i).items():
            layers[k][i] = v
    return {"layers": layers, **src.top}


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
