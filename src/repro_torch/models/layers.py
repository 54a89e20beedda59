"""Shared layers of the dense decoder, in PyTorch.

Counterpart of the dense subset of ``src/repro/models/layers.py``: norms,
RoPE, GQA projection and attention, the single-token decode attention over
a dense cache, and the MLP.  Every function mirrors the reference's
arithmetic and cast points (the rsqrt cast in `rmsnorm`, interleaved RoPE
pairs, fp32 attention logits) so bf16 runs round where the reference does.
The reference's sharding hints have no counterpart here.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiering import matmul

Params = dict[str, Any]

# Tier-aware matmul (operand-type dispatch): plain weights hit `@`, tiered
# weights compute each tier from its own buffer.  Layer functions take `mm`
# so the serving layer can inject the direct-access kernel
# (`kernels.ops.tiered_matmul`) in place of the plain per-tier product.
Matmul = Any


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return (((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)) * w + b


def norm(cfg: ModelConfig, x: torch.Tensor, p: Params, prefix: str) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p[f"{prefix}_w"], p[f"{prefix}_b"], cfg.norm_eps)
    return rmsnorm(x, p[f"{prefix}_w"], cfg.norm_eps)


# --------------------------------------------------------------------------
# RoPE — rotates interleaved pairs (x[..., ::2], x[..., 1::2]) of the first
# `rot_dim` dims of each head; positions are explicit for decode.
# --------------------------------------------------------------------------
def rope_cos_sin(positions: torch.Tensor, rot_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv                   # [..., rot/2]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot_dim: int) -> torch.Tensor:
    """x: [..., T, H, hd]; cos/sin: [..., T, rot/2] (broadcast over heads).
    Rotation computed in fp32, result cast back to x.dtype."""
    rot, rest = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = rot[..., ::2].float(), rot[..., 1::2].float()
    c, s = cos[..., None, :], sin[..., None, :]                # add head axis
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    rot_out = torch.stack([r1, r2], dim=-1).reshape(rot.shape).to(x.dtype)
    return torch.cat([rot_out, rest], dim=-1) if rest.shape[-1] else rot_out


# --------------------------------------------------------------------------
# Attention (GQA)
# --------------------------------------------------------------------------
def _maybe_qk_norm(cfg: ModelConfig, q, k, p: Params):
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm_w"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm_w"], cfg.norm_eps)
    return q, k


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(logits / cap) * cap if cap > 0 else logits


def qkv_project(cfg: ModelConfig, x: torch.Tensor, p: Params, mm: Matmul = matmul):
    """x: [B,T,d] -> q [B,T,Hp,hd], k,v [B,T,K,hd] (rope applied by caller).
    q uses the padded head count (zero weights beyond n_heads — exact)."""
    hd = cfg.resolved_head_dim
    hp, kv = cfg.padded_heads, cfg.n_kv_heads
    q = mm(x, p["wq"])
    k_v = mm(x, p["wkv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k_v = k_v + p["bkv"]
    k, v = torch.chunk(k_v, 2, dim=-1)
    b, t = x.shape[:2]
    return q.reshape(b, t, hp, hd), k.reshape(b, t, kv, hd), v.reshape(b, t, kv, hd)


# Above this many query positions the full [Tq,Tk] score matrix is never
# materialized: queries are processed in chunks.
ATTN_CHUNK_THRESHOLD = 2048
ATTN_CHUNK_Q = 1024


def _attend_dense(cfg: ModelConfig, q, k, v, causal, q_offset=0,
                  kv_len=None) -> torch.Tensor:
    """Group-MAJOR GQA: q head h belongs to group g = h // K, kv head
    k = h % K."""
    b, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    vd = v.shape[-1]
    qg = q.reshape(b, tq, g, kv, hd)
    logits = torch.einsum("btgkh,bskh->bgkts", qg, k).float()
    logits = _softcap(logits * (hd ** -0.5), cfg.attn_logit_softcap)
    spans = torch.arange(tk, device=q.device)[None, :]
    neg = torch.tensor(-1e30, dtype=logits.dtype, device=q.device)
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + q_offset
        logits = torch.where(spans <= qpos, logits, neg)
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=q.device)
        if kvl.dim() == 1:                       # ragged batch: per-slot length
            kvl = kvl[:, None, None, None, None]
        logits = torch.where(spans <= kvl - 1, logits, neg)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bgkts,bskh->btgkh", probs, v)
    return out.reshape(b, tq, h, vd)


def attend(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """Grouped-query attention.  `kv_len` masks positions >= kv_len;
    `q_offset` is the absolute position of q[0] for causal masking.  Long
    query spans are processed in chunks of ATTN_CHUNK_Q queries."""
    b, tq, h, hd = q.shape
    if tq <= ATTN_CHUNK_THRESHOLD or tq % ATTN_CHUNK_Q:
        return _attend_dense(cfg, q, k, v, causal, q_offset, kv_len)
    return torch.cat([
        _attend_dense(cfg, q[:, s:s + ATTN_CHUNK_Q], k, v, causal, q_offset + s, kv_len)
        for s in range(0, tq, ATTN_CHUNK_Q)], dim=1)


def attention_decode(
    cfg: ModelConfig,
    x: torch.Tensor,               # [B,1,d]
    p: Params,
    k_cache: torch.Tensor,         # [B,S,K,hd]
    v_cache: torch.Tensor,
    pos,                           # int (aligned batch) or [B] tensor (ragged)
    mm: Matmul = matmul,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode token over a dense cache.  Returns (y, k_cache, v_cache);
    the caches are new tensors (the inputs are left untouched)."""
    hd = cfg.resolved_head_dim
    pos = torch.as_tensor(pos, device=x.device)
    ragged = pos.dim() == 1
    q, k, v = qkv_project(cfg, x, p, mm=mm)
    q, k = _maybe_qk_norm(cfg, q, k, p)
    rot = int(hd * cfg.rope_fraction)
    if rot:
        cos, sin = rope_cos_sin(pos[:, None] if ragged else pos[None], rot, cfg.rope_theta)
        q = apply_rope(q, cos, sin, rot)
        k = apply_rope(k, cos, sin, rot)
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    if ragged:
        rows = torch.arange(x.shape[0], device=x.device)
        k_cache[rows, pos.long()] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, pos.long()] = v[:, 0].to(v_cache.dtype)
    else:
        k_cache[:, int(pos)] = k[:, 0].to(k_cache.dtype)
        v_cache[:, int(pos)] = v[:, 0].to(v_cache.dtype)
    out = attend(cfg, q, k_cache, v_cache, causal=False, kv_len=pos + 1)
    y = mm(out.reshape(*x.shape[:2], cfg.padded_heads * hd), p["wo"])
    return y, k_cache, v_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def mlp_block(cfg: ModelConfig, x: torch.Tensor, p: Params, mm: Matmul = matmul) -> torch.Tensor:
    if cfg.mlp == "swiglu":
        gate, up = torch.chunk(mm(x, p["wi"]), 2, dim=-1)
        h = F.silu(gate) * up
    else:
        h = mm(x, p["wi"])
        if "bi" in p:
            h = h + p["bi"]
        h = F.gelu(h, approximate="tanh")
    out = mm(h, p["wdown"])
    if "bdown" in p:
        out = out + p["bdown"]
    return out
