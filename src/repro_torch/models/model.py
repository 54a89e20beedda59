"""Every model family: init / forward / prefill / decode in PyTorch.

Counterpart of ``src/repro/models/model.py``: dense GQA decoders, MoE with
GQA, DeepSeek-V2's MLA with MoE, Mamba-2 (ssm), Zamba2-style hybrids
(Mamba-2 layers with shared attention + MLP blocks, one every
``hybrid_attn_every`` layers), the encoder (HuBERT: frame embeddings in
through ``in_proj``, non-causal attention, no decode step) and the VLM (a
dense decoder whose prompt may start with patch embeddings, brought in
through ``vision_proj``).  The audio and vision frontends are stubs, as in
the reference: the inputs are precomputed frame and patch embeddings.
Layer parameters are stacked along a leading ``n_layers`` axis, and a
hybrid's shared blocks along a leading block axis under
``params["shared"]`` (the reference's layout, so bridged weights and
`TieringPlan.partition` line up); where the reference scans over those
axes, the port loops.  `prefill` and `decode_step` together are the plain
per-request reference the serving engine is checked against;
`prefill_chunk` continues a cache by a prompt chunk (chunked prefill) and
`forward` is the whole-sequence pass (the encoder's entry point).  Every
entry point takes ``mm``, the tier-aware matmul, so the engine can run the
same code through the direct-access kernel; a hybrid's ``concat_proj``,
``in_proj`` and ``vision_proj`` are not registered and stay plain
products, as in the reference.  Not ported: ``forward``'s remat (training).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

Params = dict[str, Any]
Cache = dict[str, torch.Tensor]

VISION_EMBED_DIM = 1152      # stub anyres patch-embedding width (frontend stub)
AUDIO_FRAME_DIM = 512        # stub audio frame-embedding width

_INIT_STD = 0.02
_DRAW_CHUNK = 1 << 26       # elements of one fp32 draw (256 MB)

# Families with a decode step, all served by `ServingEngine` (MoE with or
# without MLA); the encoder has only `forward`.
SERVED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


def require_served(cfg: ModelConfig) -> None:
    """Refuse what has no decode step (the encoder) at the entry points
    that need one: the cache, prefill, decode and serving."""
    if cfg.family not in SERVED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): encoder-only arch has no decode step; "
            f"run it through models.model.forward (launch.steps.make_prefill_step)")


def layer_slice(layers: Any, i: int) -> Any:
    """Layer `i` of a stacked (possibly tiered) layer tree."""
    return {k: v[i] for k, v in layers.items()}


# ==========================================================================
# Init
# ==========================================================================
def _draws(generator: torch.Generator | None, dtype: torch.dtype, device):
    """The leaf makers of `init_layer` and `init_top`: N(0, std) (0.02 by
    default) drawn in fp32 from `generator` in chunks of the leading axis of
    at most `_DRAW_CHUNK` elements, each cast into the leaf (so the fp32
    draw alive at a time is one chunk, not a whole expert stack), ones and
    zeros."""
    def dense(*shape, std=_INIT_STD):
        w = torch.empty(shape, dtype=dtype, device=device)
        rows = max(1, _DRAW_CHUNK // max(1, math.prod(shape[1:])))
        for chunk in w.split(rows):
            chunk.copy_(torch.randn(chunk.shape, generator=generator, device=device)
                        .mul_(std))
        return w

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dense, ones, zeros


def _norm_leaves(cfg: ModelConfig, prefix: str, lead: tuple, ones, zeros) -> Params:
    p = {f"{prefix}_w": ones(*lead, cfg.d_model)}
    if cfg.norm == "layernorm":
        p[f"{prefix}_b"] = zeros(*lead, cfg.d_model)
    return p


def _attn_leaves(cfg: ModelConfig, lead: tuple, dense, ones, zeros) -> Params:
    """The GQA attention leaves (the reference's `_attn_params`)."""
    d, hd, hp = cfg.d_model, cfg.resolved_head_dim, cfg.padded_heads
    wq, wo = dense(*lead, d, hp * hd), dense(*lead, hp * hd, d)
    if hp > cfg.n_heads:
        # padded query heads: zero weights beyond n_heads — numerically exact
        wq[..., cfg.n_heads * hd:] = 0
        wo[..., cfg.n_heads * hd:, :] = 0
    p: Params = {"wq": wq, "wkv": dense(*lead, d, 2 * cfg.n_kv_heads * hd), "wo": wo}
    if cfg.qkv_bias:
        p["bq"] = zeros(*lead, hp * hd)
        p["bkv"] = zeros(*lead, 2 * cfg.n_kv_heads * hd)
    if cfg.qk_norm:
        p["q_norm_w"] = ones(*lead, hd)
        p["k_norm_w"] = ones(*lead, hd)
    return p


def _mlp_leaves(cfg: ModelConfig, lead: tuple, dense, zeros) -> Params:
    """The dense MLP's leaves (the reference's `_mlp_params`)."""
    mult = 2 if cfg.mlp == "swiglu" else 1
    p: Params = {"wi": dense(*lead, cfg.d_model, mult * cfg.d_ff),
                 "wdown": dense(*lead, cfg.d_ff, cfg.d_model)}
    if cfg.norm == "layernorm":       # bias-ful families
        p["bi"], p["bdown"] = zeros(*lead, mult * cfg.d_ff), zeros(*lead, cfg.d_model)
    return p


def _ssm_leaves(cfg: ModelConfig, dense, ones, zeros) -> Params:
    """One Mamba-2 layer's leaves (the reference's `_ssm_params`): split
    z/x/BC/dt projections, the depthwise conv (std 0.1), dt_bias and A_log
    zeros (A = -1), D and the gated norm's weight ones."""
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    nh = d_inner // cfg.ssm_head_dim
    gs2 = 2 * cfg.ssm_n_groups * cfg.ssm_state
    p: Params = {"z_proj": dense(d, d_inner), "x_proj": dense(d, d_inner),
                 "bc_proj": dense(d, gs2), "dt_proj": dense(d, nh),
                 "conv_w": dense(cfg.ssm_conv_width, d_inner + gs2, std=0.1),
                 "dt_bias": zeros(nh), "A_log": zeros(nh), "D": ones(nh),
                 "ssm_norm_w": ones(d_inner)}
    p["ssm_out"] = dense(d_inner, d)
    return p


def init_layer(cfg: ModelConfig, generator: torch.Generator | None,
               dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """One layer's random weights, unstacked, with the reference's layout
    and std: N(0, 0.02) for matrices, ones for norm weights, zeros beyond
    `n_heads` in the padded query heads and for biases.  The tree is the
    reference's (`_attn_params` or `_mla_params`, then `_mlp_params` or
    `_moe_params`; ln1 and `_ssm_params` for the ssm and hybrid families)
    without the leading layer axis; the encoder and the VLM take the dense
    branch.  On the meta device (`generator` None) it gives the leaves'
    shapes and dtypes only."""
    device = torch.device(device)
    dense, ones, zeros = _draws(generator, dtype, device)
    if cfg.family in ("ssm", "hybrid"):
        return {**_norm_leaves(cfg, "ln1", (), ones, zeros),
                **_ssm_leaves(cfg, dense, ones, zeros)}
    d = cfg.d_model
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
        layer.update(_attn_leaves(cfg, (), dense, ones, zeros))
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
        layer.update(_mlp_leaves(cfg, (), dense, zeros))
    return layer


def init_top(cfg: ModelConfig, generator: torch.Generator | None,
             dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """The leaves outside the layer stack, in the reference's order:
    `embed` (the encoder's `in_proj` [AUDIO_FRAME_DIM, d] instead), a
    VLM's `vision_proj` [VISION_EMBED_DIM, d], a hybrid's `shared` stack of
    `hybrid_shared_blocks` attention + MLP blocks (the reference's
    `_shared_block_params`: `concat_proj` [2d, d], ln1, attention, ln2 and
    the MLP, each leaf stacked on a leading block axis, its fp32 draws
    chunked by whole blocks), `final_w` (and `final_b` for LayerNorm), and
    `lm_head` unless the embedding is tied."""
    dense, ones, zeros = _draws(generator, dtype, torch.device(device))
    top: Params = {}
    if cfg.family == "encoder":
        top["in_proj"] = dense(AUDIO_FRAME_DIM, cfg.d_model)
    else:
        top["embed"] = dense(cfg.vocab, cfg.d_model)
    if cfg.family == "vlm":
        top["vision_proj"] = dense(VISION_EMBED_DIM, cfg.d_model)
    if cfg.family == "hybrid" and cfg.hybrid_shared_blocks:
        lead = (cfg.hybrid_shared_blocks,)
        top["shared"] = {"concat_proj": dense(*lead, 2 * cfg.d_model, cfg.d_model),
                         **_norm_leaves(cfg, "ln1", lead, ones, zeros),
                         **_attn_leaves(cfg, lead, dense, ones, zeros),
                         **_norm_leaves(cfg, "ln2", lead, ones, zeros),
                         **_mlp_leaves(cfg, lead, dense, zeros)}
    top["final_w"] = ones(cfg.d_model)
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
        return self.top["final_w"].device       # every family has it

    @property
    def dtype(self) -> torch.dtype:
        return self.top["final_w"].dtype

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
    return stack_source(layer_source(cfg, generator, dtype, device))


def stack_source(src: LayerSource) -> Params:
    """The whole stacked tree of a `LayerSource` on its device, its layers
    asked for in order and written into the stacks one at a time."""
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
    """The input sequence [B, T, d]: the encoder's `frames` [B, T, 512]
    through ``in_proj``; otherwise the embedded `tokens`, after which a
    VLM batch's `patches` [B, T_img, 1152] through ``vision_proj`` come
    first.  Frames and patches are cast to the weights' dtype."""
    if cfg.family == "encoder":
        w = params["in_proj"]
        return batch["frames"].to(w.dtype) @ w
    tok = params["embed"][batch["tokens"].long()]
    if cfg.family == "vlm" and "patches" in batch:
        w = params["vision_proj"]
        return torch.cat([batch["patches"].to(w.dtype) @ w, tok], dim=1)
    return tok


def lm_head(cfg: ModelConfig, params: Params, x: torch.Tensor,
            mm: L.Matmul = L.matmul) -> torch.Tensor:
    x = (L.layernorm(x, params["final_w"], params["final_b"], cfg.norm_eps)
         if cfg.norm == "layernorm" else L.rmsnorm(x, params["final_w"], cfg.norm_eps))
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mm(x, w)


# ==========================================================================
# Forward: the whole sequence, every family (the encoder's entry point)
# ==========================================================================
def _attn_mlp_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params, positions: torch.Tensor,
                    causal: bool, mm: L.Matmul) -> torch.Tensor:
    """One attention (GQA or MLA) + FFN layer over the whole sequence."""
    hn = L.norm(cfg, x, lp, "ln1")
    attn = (L.mla_attention_block(cfg, hn, lp, positions, causal, mm=mm) if cfg.use_mla
            else L.attention_block(cfg, hn, lp, positions, causal, mm=mm))
    x = x + attn
    return x + _ffn(cfg, x, lp, mm)


def forward(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            mm: L.Matmul = L.matmul) -> torch.Tensor:
    """Logits [B, T, vocab] at every position of `embed_inputs`' sequence
    (causal unless ``cfg.is_causal`` is false, as for the encoder).  A
    hybrid runs its shared block before each group of ``hybrid_attn_every``
    layers, on the embedding ``h0`` too."""
    x = embed_inputs(cfg, params, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    h0 = x
    for i in range(cfg.n_layers):
        sp = shared_block(cfg, params, i)
        if sp is not None:
            z = shared_in(x, h0, sp)
            z = z + L.attention_block(cfg, L.norm(cfg, z, sp, "ln1"), sp, positions,
                                      cfg.is_causal, mm=mm)
            x = shared_out(cfg, x, z, sp, mm)
        lp = layer_slice(params["layers"], i)
        if cfg.family in ("ssm", "hybrid"):
            x = x + S.ssm_block(cfg, L.norm(cfg, x, lp, "ln1"), lp, mm=mm)[0]
        else:
            x = _attn_mlp_layer(cfg, x, lp, positions, cfg.is_causal, mm)
    return lm_head(cfg, params, x, mm=mm)


# ==========================================================================
# KV / state caches
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32, device="cuda") -> Cache:
    """Zeroed cache: dense {k, v: [L, B, S, Kh, hd]}; MLA's latent
    {ckv: [L, B, S, rank], krope: [L, B, S, rd]}; SSM {conv: [L, B, W-1, C],
    state: [L, B, H, P, S]}; a hybrid's SSM cache plus {k, v} over its
    ``n_layers // hybrid_attn_every`` shared-block groups."""
    require_served(cfg)
    nl = cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * cfg.d_model
        conv_dim = d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
        cache = {"conv": zeros(nl, batch, cfg.ssm_conv_width - 1, conv_dim),
                 "state": zeros(nl, batch, d_inner // cfg.ssm_head_dim, cfg.ssm_head_dim,
                                cfg.ssm_state)}
        if cfg.family == "hybrid":
            shape = (nl // cfg.hybrid_attn_every, batch, max_len, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            cache["k"], cache["v"] = zeros(*shape), zeros(*shape)
        return cache
    if cfg.use_mla:
        return {"ckv": zeros(nl, batch, max_len, cfg.kv_lora_rank),
                "krope": zeros(nl, batch, max_len, cfg.rope_head_dim)}
    shape = (nl, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": zeros(*shape), "v": zeros(*shape)}


def _ffn(cfg: ModelConfig, x: torch.Tensor, lp: Params, mm: L.Matmul) -> torch.Tensor:
    """The layer's FFN on its normed input: MoE or the dense MLP."""
    h = L.norm(cfg, x, lp, "ln2")
    return L.moe_block(cfg, h, lp, mm=mm) if cfg.family == "moe" else L.mlp_block(cfg, h, lp, mm=mm)


def shared_block(cfg: ModelConfig, params: Params, i: int) -> Params | None:
    """The shared attention + MLP block a hybrid runs before layer `i`:
    one every ``hybrid_attn_every`` layers, the ``hybrid_shared_blocks``
    blocks in turn (group g takes block g mod blocks); None elsewhere and
    for every other family."""
    if cfg.family != "hybrid" or i % cfg.hybrid_attn_every:
        return None
    group = i // cfg.hybrid_attn_every
    return layer_slice(params["shared"], group % max(1, cfg.hybrid_shared_blocks))


def _gqa_prefill(cfg: ModelConfig, hn: torch.Tensor, p: Params, positions: torch.Tensor,
                 mm: L.Matmul) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal GQA over the prompt: (the output after ``wo``, k, v)."""
    bsz, t = hn.shape[:2]
    q, k, v = L.qkv_project(cfg, hn, p, mm=mm)
    q, k = L._rope_qk(cfg, *L._maybe_qk_norm(cfg, q, k, p), positions)
    attn = L.attend(cfg, q, k, v, causal=True)
    return mm(attn.reshape(bsz, t, -1), p["wo"]), k, v


def shared_in(x: torch.Tensor, h0: torch.Tensor, sp: Params) -> torch.Tensor:
    """A hybrid shared block's input ``concat([x, h0]) @ concat_proj``: a
    plain product, since ``concat_proj`` is not registered."""
    return torch.cat([x, h0], dim=-1) @ sp["concat_proj"]


def shared_out(cfg: ModelConfig, x: torch.Tensor, z: torch.Tensor, sp: Params,
               mm: L.Matmul) -> torch.Tensor:
    """The rest of the shared block once its attention is added to `z`:
    the MLP on the ln2-normed stream, then the block's residual onto x."""
    return x + (z + L.mlp_block(cfg, L.norm(cfg, z, sp, "ln2"), sp, mm=mm))


def _pad_cache(entries: dict[str, list[torch.Tensor]], max_len: int, t: int) -> Cache:
    """Stack each entry's layers; a [L, B, T, ...] KV entry is zero-padded
    to max_len along T, recurrent state is stored as is."""
    cache = {}
    for name, cs in entries.items():
        full = torch.stack(cs)
        if name not in ("conv", "state"):
            full = torch.nn.functional.pad(full, [0, 0] * (full.dim() - 3) + [0, max_len - t])
        cache[name] = full
    return cache


# ==========================================================================
# Prefill: forward pass that also fills the cache
# ==========================================================================
def prefill(cfg: ModelConfig, params: Params, batch: dict[str, torch.Tensor],
            max_len: int | None = None,
            mm: L.Matmul = L.matmul) -> tuple[torch.Tensor, Cache]:
    """Whole-prompt forward.  Returns (logits [B,1,vocab] at the last
    position, the cache of `init_cache`'s layout, KV zero-padded past the
    prompt).  A VLM batch's `patches` come before its tokens and fill the
    cache too.  Attention is plain PyTorch, as in the reference; SSM layers
    run the chunked SSD form (`ssm.ssm_block_prefill`)."""
    require_served(cfg)
    x = embed_inputs(cfg, params, batch)
    t = x.shape[1]
    max_len = max_len or t
    positions = torch.arange(t, device=x.device)
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent_prefill(cfg, params, x, positions, max_len, mm)
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
            attn, k, v = _gqa_prefill(cfg, hn, lp, positions, mm)
            x = x + attn
            layer_cache = {"k": k, "v": v}
        x = x + _ffn(cfg, x, lp, mm)
        for name, c in layer_cache.items():
            entries.setdefault(name, []).append(c)
    return lm_head(cfg, params, x[:, -1:], mm=mm), _pad_cache(entries, max_len, t)


def _recurrent_prefill(cfg: ModelConfig, params: Params, x: torch.Tensor,
                       positions: torch.Tensor, max_len: int,
                       mm: L.Matmul) -> tuple[torch.Tensor, Cache]:
    """SSM and hybrid prefill: every Mamba-2 layer leaves its conv window
    and final SSD state; a hybrid runs its shared block before each group
    of ``hybrid_attn_every`` layers (on the embedding ``h0`` too) and caches
    that block's K/V, one cache layer per group."""
    h0 = x
    t = x.shape[1]
    entries: dict[str, list[torch.Tensor]] = {"conv": [], "state": []}
    for i in range(cfg.n_layers):
        sp = shared_block(cfg, params, i)
        if sp is not None:
            z = shared_in(x, h0, sp)
            attn, k, v = _gqa_prefill(cfg, L.norm(cfg, z, sp, "ln1"), sp, positions, mm)
            x = shared_out(cfg, x, z + attn, sp, mm)
            entries.setdefault("k", []).append(k)
            entries.setdefault("v", []).append(v)
        lp = layer_slice(params["layers"], i)
        y, conv, state = S.ssm_block_prefill(cfg, L.norm(cfg, x, lp, "ln1"), lp, mm=mm)
        x = x + y
        entries["conv"].append(conv)
        entries["state"].append(state)
    return lm_head(cfg, params, x[:, -1:], mm=mm), _pad_cache(entries, max_len, t)


# ==========================================================================
# Chunked prefill: continue a partially filled cache by n tokens
# ==========================================================================
def prefill_chunk(cfg: ModelConfig, params: Params, cache: Cache, tokens: torch.Tensor,
                  start: int, mm: L.Matmul = L.matmul) -> tuple[torch.Tensor, Cache]:
    """Prompt tokens [start, start+n) against a cache filled for [0, start):
    the compute behind the serving frontend's chunked prefill.

    tokens: [B, n]; cache: the full-size cache of `init_cache` (KV or
    latent entries at max_len, conv/state carries, or both), updated in
    place and returned.  ``start == 0`` against a fresh zero cache is a
    whole-prefix pass, so a prompt fed in chunks of any size leaves the
    cache and next-token logits of one `prefill` call.  Returns (logits
    [B,1,vocab] at the chunk's last position, cache)."""
    require_served(cfg)
    x = params["embed"][tokens.long()]
    positions = torch.arange(start, start + x.shape[1], device=x.device)
    h0 = x
    names = ("ckv", "krope") if cfg.use_mla else ("k", "v")
    for i in range(cfg.n_layers):
        sp = shared_block(cfg, params, i)
        if sp is not None:
            g = i // cfg.hybrid_attn_every
            z = shared_in(x, h0, sp)
            attn, _, _ = L.attention_chunk(cfg, L.norm(cfg, z, sp, "ln1"), sp, cache["k"][g],
                                           cache["v"][g], positions, start, mm=mm)
            x = shared_out(cfg, x, z + attn, sp, mm)
        lp = layer_slice(params["layers"], i)
        hn = L.norm(cfg, x, lp, "ln1")
        if cfg.family in ("ssm", "hybrid"):
            y, cache["conv"][i], cache["state"][i] = S.ssm_block_chunk(
                cfg, hn, lp, cache["conv"][i], cache["state"][i], mm=mm)
            x = x + y
            continue
        chunk = L.mla_attention_chunk if cfg.use_mla else L.attention_chunk
        attn, _, _ = chunk(cfg, hn, lp, cache[names[0]][i], cache[names[1]][i], positions,
                           start, mm=mm)
        x = x + attn
        x = x + _ffn(cfg, x, lp, mm)
    return lm_head(cfg, params, x[:, -1:], mm=mm), cache


# ==========================================================================
# Decode: one token, cache update
# ==========================================================================
def decode_step(cfg: ModelConfig, params: Params, cache: Cache,
                tokens: torch.Tensor, pos,
                mm: L.Matmul = L.matmul) -> tuple[torch.Tensor, Cache]:
    """tokens: [B,1]; pos: the position to write — an int for a
    slot-aligned batch, or a [B] tensor for a ragged batch (SSM layers
    ignore it).  Returns (logits [B,1,vocab], the updated cache)."""
    require_served(cfg)
    x = params["embed"][tokens.long()]
    if cfg.family in ("ssm", "hybrid"):
        return _recurrent_decode(cfg, params, cache, x, pos, mm)
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


def _recurrent_decode(cfg: ModelConfig, params: Params, cache: Cache, x: torch.Tensor, pos,
                      mm: L.Matmul) -> tuple[torch.Tensor, Cache]:
    """One SSM or hybrid token: each Mamba-2 layer's recurrent step; a
    hybrid's shared block attends over its group's dense K/V cache."""
    h0 = x
    new: dict[str, list[torch.Tensor]] = {name: [] for name in cache}
    for i in range(cfg.n_layers):
        sp = shared_block(cfg, params, i)
        if sp is not None:
            g = i // cfg.hybrid_attn_every
            z = shared_in(x, h0, sp)
            attn, k_c, v_c = L.attention_decode(cfg, L.norm(cfg, z, sp, "ln1"), sp,
                                                cache["k"][g], cache["v"][g], pos, mm=mm)
            x = shared_out(cfg, x, z + attn, sp, mm)
            new["k"].append(k_c)
            new["v"].append(v_c)
        lp = layer_slice(params["layers"], i)
        y, conv, state = S.ssm_block_decode(cfg, L.norm(cfg, x, lp, "ln1"), lp,
                                            cache["conv"][i], cache["state"][i], mm=mm)
        x = x + y
        new["conv"].append(conv)
        new["state"].append(state)
    return lm_head(cfg, params, x, mm=mm), {name: torch.stack(cs) for name, cs in new.items()}
