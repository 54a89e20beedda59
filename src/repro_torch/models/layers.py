"""Shared layers of every model family, in PyTorch.

Counterpart of ``src/repro/models/layers.py``: norms, RoPE, GQA projection
and attention (a whole sequence, causal or not; a single decode token over
a dense cache; a prefill chunk continuing a cache), the MLP, the
sort-and-gather MoE block and DeepSeek-V2's MLA.  Every function mirrors
the reference's arithmetic and cast points (the rsqrt cast in `rmsnorm`,
interleaved RoPE pairs, fp32 attention logits, fp32 router probabilities)
so bf16 runs round where the reference does.  The reference's sharding
hints are `hint`, at the same places: on a DTensor (the dry run's trace)
it redistributes to the conventional layout, on a plain tensor it returns
its argument, so every other path runs as before.

Every function that consumes a tierable weight takes ``mm``: the plain
per-tier product by default, the direct-access kernel when the serving
layer passes it.  Unlike the reference, the whole-sequence and chunk
attention blocks and the MLA prefill thread ``mm`` through their
projections and ``wo`` too: on the card a plain product cannot read a
pinned remote tier.  Attention itself is plain PyTorch (`attend`), as the
reference attends through XLA outside any Pallas kernel.  An ``mm`` may
carry ``grouped``, the grouped product of a tiered expert stack's remote
block (`tiered_expert_ffn`); without it the plain version runs.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tiering import TieredTensor, matmul
from repro_torch.kernels.device_count import DeviceCount
from repro_torch.kernels.ref import splitk_gemm_grouped_ref

Params = dict[str, Any]

# Tier-aware matmul (operand-type dispatch): plain weights hit `@`, tiered
# weights compute each tier from its own buffer.  Layer functions take `mm`
# so the serving layer can inject the direct-access kernel
# (`kernels.ops.tiered_matmul`) in place of the plain per-tier product.
Matmul = Any


# --------------------------------------------------------------------------
# Sharding hints.  Left to itself a partitioner invents pathological
# layouts for attention intermediates (sharding the head_dim contraction);
# these pin the conventional layout: batch over (pod, data), heads / d_ff /
# vocab over model.  A plain tensor (every path but the dry run's) and a
# dim that does not divide pass through.
# --------------------------------------------------------------------------
def hint(x: torch.Tensor, *spec: str | None) -> torch.Tensor:
    """spec entries: 'batch' | 'model' | None per dimension; on a DTensor
    the named dims shard over the mesh and every other dim replicates (the
    reference's ``with_sharding_constraint``)."""
    if type(x) is torch.Tensor:
        return x
    mesh = getattr(x, "device_mesh", None)
    if mesh is None:
        return x
    from torch.distributed.tensor import Replicate, Shard

    # a DeviceMesh dim may carry several axes, its name joined with "."
    names = [set(n.split(".")) for n in mesh.mesh_dim_names]
    batch_dims = [i for i, n in enumerate(names) if n & {"pod", "data"}]
    placements: list = [Replicate()] * len(names)
    any_axis = False
    for dim, (size, s) in enumerate(zip(x.shape, spec, strict=True)):
        mdims = batch_dims if s == "batch" else [i for i, n in enumerate(names)
                                                 if s == "model" and "model" in n]
        n = 1
        for i in mdims:
            n *= mesh.size(i)
        if not mdims or n == 1 or size % n:
            continue
        any_axis = True
        for i in mdims:
            placements[i] = Shard(dim)
    if not any_axis:
        return x
    return x.redistribute(mesh, placements)


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
    # a fill, not a host-to-device copy, so a captured decode step can hold it
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
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
    return (hint(q.reshape(b, t, hp, hd), "batch", None, "model", None),
            hint(k.reshape(b, t, kv, hd), "batch", None, None, None),
            hint(v.reshape(b, t, kv, hd), "batch", None, None, None))


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
    query spans are processed in chunks of ATTN_CHUNK_Q queries; while
    autograd records, each chunk runs under a checkpoint, so backward
    keeps O(Tq_chunk * Tk) logits instead of O(Tq * Tk)."""
    b, tq, h, hd = q.shape
    if tq <= ATTN_CHUNK_THRESHOLD or tq % ATTN_CHUNK_Q:
        return _attend_dense(cfg, q, k, v, causal, q_offset, kv_len)
    chunk = _attend_dense
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        from torch.utils.checkpoint import checkpoint

        def chunk(*args):
            return checkpoint(_attend_dense, *args, use_reentrant=False)
    return torch.cat([
        chunk(cfg, q[:, s:s + ATTN_CHUNK_Q], k, v, causal, q_offset + s, kv_len)
        for s in range(0, tq, ATTN_CHUNK_Q)], dim=1)


def _rope_qk(cfg: ModelConfig, q, k, positions: torch.Tensor):
    """RoPE on q and k at `positions` ([T]), over the rotated fraction."""
    rot = int(cfg.resolved_head_dim * cfg.rope_fraction)
    if not rot:
        return q, k
    cos, sin = rope_cos_sin(positions, rot, cfg.rope_theta)
    return apply_rope(q, cos, sin, rot), apply_rope(k, cos, sin, rot)


def attention_block(
    cfg: ModelConfig,
    x: torch.Tensor,               # [B,T,d]
    p: Params,
    positions: torch.Tensor,       # [T] absolute positions
    causal: bool,
    mm: Matmul = matmul,
) -> torch.Tensor:
    """Whole-sequence GQA (the encoder's, non-causal, and the forward
    pass's): projections, RoPE, `attend`, then ``wo``."""
    q, k, v = qkv_project(cfg, x, p, mm=mm)
    q, k = _rope_qk(cfg, *_maybe_qk_norm(cfg, q, k, p), positions)
    out = attend(cfg, q, k, v, causal=causal)
    return mm(out.reshape(*x.shape[:2], cfg.padded_heads * cfg.resolved_head_dim), p["wo"])


def attention_chunk(
    cfg: ModelConfig,
    x: torch.Tensor,               # [B,n,d]: prompt chunk [start, start+n)
    p: Params,
    k_cache: torch.Tensor,         # [B,S,K,hd], filled for [0, start)
    v_cache: torch.Tensor,
    positions: torch.Tensor,       # [n] absolute positions start..start+n-1
    start: int,
    mm: Matmul = matmul,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-token prefill continuation: project the chunk's Q/K/V, write
    K/V into the caches at ``start`` (in place), and attend the chunk's
    queries over the prefix, cached keys plus this chunk, causal within
    the chunk.  Returns (y, k_cache, v_cache).  The reference attends over
    the whole cache with a ``start + n`` length mask; the port slices the
    caches to ``start + n`` first, which drops only masked positions."""
    n = x.shape[1]
    q, k, v = qkv_project(cfg, x, p, mm=mm)
    q, k = _rope_qk(cfg, *_maybe_qk_norm(cfg, q, k, p), positions)
    k_cache[:, start:start + n] = k.to(k_cache.dtype)
    v_cache[:, start:start + n] = v.to(v_cache.dtype)
    out = attend(cfg, q, k_cache[:, :start + n], v_cache[:, :start + n], causal=True,
                 q_offset=start)
    y = mm(out.reshape(*x.shape[:2], cfg.padded_heads * cfg.resolved_head_dim), p["wo"])
    return y, k_cache, v_cache


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
        gate, up = torch.chunk(hint(mm(x, p["wi"]), "batch", None, "model"), 2, dim=-1)
        h = F.silu(gate) * up
    else:
        h = hint(mm(x, p["wi"]), "batch", None, "model")
        if "bi" in p:
            h = h + p["bi"]
        h = F.gelu(h, approximate="tanh")
    out = mm(h, p["wdown"])
    if "bdown" in p:
        out = out + p["bdown"]
    return out


# --------------------------------------------------------------------------
# MoE — sort+gather capacity dispatch (no [N,E,C] one-hot masks; the largest
# intermediate is the [G, E, C, d] expert buffer).
# --------------------------------------------------------------------------
def _top_k(v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties broken
    toward the lower index.  `torch.topk` breaks ties otherwise, and router
    probabilities do tie (bf16 logits), so this takes a stable descending
    sort."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_ffn(buf: torch.Tensor, wi: torch.Tensor, wdown: torch.Tensor) -> torch.Tensor:
    """Per-expert SwiGLU FFN over a dispatch buffer [G,E,C,d] -> [G,E,C,d],
    one batched product per matrix over the experts."""
    gu = hint(torch.einsum("gecd,edf->gecf", buf, wi), None, "batch", None, "model")
    gate_h, up_h = torch.chunk(gu, 2, dim=-1)
    return hint(torch.einsum("gecf,efd->gecd", F.silu(gate_h) * up_h, wdown),
                None, "batch", None, None)


def tiered_expert_ffn(buf: torch.Tensor, valid: torch.Tensor, wi: TieredTensor,
                      wdown: TieredTensor, mm: Matmul = matmul) -> torch.Tensor:
    """`_expert_ffn` over expert stacks split across tiers along the expert
    axis (whole experts per tier, the registry's axis -3); ``valid`` [G,E,C]
    marks the dispatch slots that hold a token.

    The local block is one batched product per matrix from HBM, as in the
    reference.  The remote block is one grouped product per matrix
    (``mm.grouped``, else the plain `kernels.ref.splitk_gemm_grouped_ref`)
    over all remote experts, given each expert's count of valid slots on
    the device: on the card the grouped direct-access GEMM reads the
    experts in place from pinned host memory and skips those with a count
    of 0, and no expert is copied into HBM.  The skip is exact: a skipped
    expert's buffer rows are zero, so its FFN output is zero, which is what
    the skip leaves; and the combine never reads them (a dropped pair
    points at its own expert's last slot with weight 0).  Nothing here
    reads back to the host; ``remote_experts`` counts the experts run on
    the device."""
    if not isinstance(wdown, TieredTensor) or wi.axis != -3 or wdown.axis != -3:
        raise ValueError("experts_wi and experts_wdown must both be split on the expert axis")
    e_loc = wi.local.shape[-3]
    if wdown.local.shape[-3] != e_loc:
        raise ValueError("experts_wi/wdown tier mismatch")
    g, _, c, d = buf.shape
    e_rem = wi.remote.shape[-3]
    blocks = []
    if e_loc:
        blocks.append(_expert_ffn(buf[:, :e_loc], wi.local, wdown.local))
    if e_rem:
        gmm = getattr(mm, "grouped", splitk_gemm_grouped_ref)
        counts = valid[:, e_loc:].sum(dim=(0, 2), dtype=torch.int32)     # [E_rem]
        x = buf[:, e_loc:].transpose(0, 1).reshape(e_rem, g * c, d).contiguous()
        gate_h, up_h = torch.chunk(gmm(x, wi.remote, counts), 2, dim=-1)
        y = gmm(F.silu(gate_h) * up_h, wdown.remote, counts)
        blocks.append(y.reshape(e_rem, g, c, d).transpose(0, 1))
        tiered_expert_ffn.remote_experts.add((counts > 0).sum())
    return torch.cat(blocks, dim=1)


# remote experts run (not skipped) since the last reset, on the device
tiered_expert_ffn.remote_experts = DeviceCount()


def expert_capacity(cfg: ModelConfig, n: int, capacity_factor: float | None = None) -> int:
    """Dispatch slots per expert for a group of `n` tokens in `moe_block`:
    the rows each expert's FFN (and the grouped remote-expert GEMM) takes,
    ``n * top_k * cf / n_experts`` rounded, at least 1 and at most every
    pair of the group.  A prefill of T tokens is one group of T; a decode
    step one group of the batch."""
    cf = cfg.moe_capacity_factor if capacity_factor is None else capacity_factor
    pairs = n * cfg.top_k
    return min(pairs, max(1, int(round(pairs * cf / cfg.n_experts))))


def moe_block(
    cfg: ModelConfig,
    x: torch.Tensor,
    p: Params,
    capacity_factor: float | None = None,
    mm: Matmul = matmul,
) -> torch.Tensor:
    """x: [B,T,d].  Grouped sort+gather MoE dispatch.

    Tokens are grouped per sequence (prefill) and in one global group at
    decode (T == 1).  Within a group each (token, choice) pair is stably
    sorted by expert id and gathered into per-expert slots of size
    ``capacity``; pairs past an expert's capacity are dropped.  A
    capacity_factor covering n·k slots makes the layer exactly dropless
    (used by parity tests).  A tiered expert stack runs
    `tiered_expert_ffn`; the shared experts go through ``mm``."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = b if t > 1 else 1                                         # groups
    n = (b * t) // g                                              # tokens/group
    capacity = expert_capacity(cfg, n, capacity_factor)
    dev = x.device

    xg = x.reshape(g, n, d)
    logits = (xg @ p["router"]).float()                           # [G,N,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                        # [G,N,k]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    flat_e = gate_idx.reshape(g, n * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)            # per group
    inv_order = torch.argsort(order, dim=-1)                      # unsort map
    e_sorted = torch.gather(flat_e, 1, order)                     # [G,N*k]
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    slot = torch.arange(n * k, device=dev)[None, :] - first
    keep = slot < capacity

    # Gather-only dispatch: buf[g,e,c] = token at sorted position
    # first_of(e) + c.
    experts = torch.arange(e, device=dev)
    starts = torch.searchsorted(e_sorted, experts.expand(g, e).contiguous(), side="left")
    src = starts[:, :, None] + torch.arange(capacity, device=dev)[None, None, :]  # [G,E,C]
    src_c = torch.clamp(src, max=n * k - 1)
    src_e = torch.gather(e_sorted, 1, src_c.reshape(g, -1)).reshape(g, e, capacity)
    valid = (src < n * k) & (src_e == experts[None, :, None])

    def rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))

    xf_sorted = rows(xg, tok_sorted)
    buf = rows(xf_sorted, src_c.reshape(g, -1)).reshape(g, e, capacity, d)
    buf = hint(buf.masked_fill(~valid[..., None], 0), None, "batch", None, None)

    wi, wdown = p["experts_wi"], p["experts_wdown"]
    if isinstance(wi, TieredTensor):
        ye = tiered_expert_ffn(buf, valid, wi, wdown, mm)
    else:
        ye = _expert_ffn(buf, wi, wdown)
    ye = hint(ye, "batch", None, None, None)        # back to group-sharded for the combine

    # combine: gather sorted-slot outputs linearly, unsort, sum over k
    lin_idx = e_sorted * capacity + torch.clamp(slot, max=capacity - 1)   # [G,N*k]
    y_lin = ye.reshape(g, e * capacity, d)
    w_sorted = (torch.gather(gate_vals.reshape(g, n * k), 1, order) * keep).to(x.dtype)
    y_sorted = rows(y_lin, lin_idx) * w_sorted[..., None]
    y_tok = rows(y_sorted, inv_order)
    y = y_tok.reshape(g, n, k, d).sum(dim=2)

    if cfg.n_shared_experts:
        xf = x.reshape(g, n, d)
        g_s, u_s = torch.chunk(mm(xf, p["shared_wi"]), 2, dim=-1)
        y = y + mm(F.silu(g_s) * u_s, p["shared_wdown"])
    return y.reshape(b, t, d)


# --------------------------------------------------------------------------
# DeepSeek-V2 MLA — latent-compressed KV; absorbed matmuls at decode
# --------------------------------------------------------------------------
def mla_project_q(cfg: ModelConfig, x: torch.Tensor, p: Params, mm: Matmul = matmul):
    """-> q_nope [B,T,H,nd], q_rope [B,T,H,rd]."""
    b, t, _ = x.shape
    h, nd, rd = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q_lat = rmsnorm(mm(x, p["wq_a"]), p["q_a_norm_w"], cfg.norm_eps)
        q = mm(q_lat, p["wq_b"])
    else:
        q = mm(x, p["wq_b"])
    q = hint(q.reshape(b, t, h, nd + rd), "batch", None, "model", None)
    return q[..., :nd], q[..., nd:]


def mla_project_kv_latent(cfg: ModelConfig, x: torch.Tensor, p: Params,
                          mm: Matmul = matmul):
    """-> c_kv [B,T,rank] (normed latent), k_rope [B,T,rd] (shared per head)."""
    lat = mm(x, p["wkv_a"])
    c_kv, k_rope = lat[..., :cfg.kv_lora_rank], lat[..., cfg.kv_lora_rank:]
    return rmsnorm(c_kv, p["kv_a_norm_w"], cfg.norm_eps), k_rope


def mla_attention_block(cfg: ModelConfig, x: torch.Tensor, p: Params,
                        positions: torch.Tensor, causal: bool = True,
                        mm: Matmul = matmul) -> torch.Tensor:
    """Full-sequence MLA (prefill): expand K,V from the latent (``wkv_b``
    stays resident), then run the shared `attend` with q/k = [nope | rope]."""
    b, t, _ = x.shape
    h, nd, rd, vd = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = mla_project_q(cfg, x, p, mm=mm)
    c_kv, k_rope = mla_project_kv_latent(cfg, x, p, mm=mm)
    kv = (c_kv @ p["wkv_b"]).reshape(b, t, h, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin, rd)
    k_rope = apply_rope(k_rope[..., None, :], cos, sin, rd)       # [B,T,1,rd]
    q_full = torch.cat([q_nope, q_rope], dim=-1)                  # [B,T,H,nd+rd]
    k_full = torch.cat([k_nope, k_rope.expand(b, t, h, rd)], dim=-1)
    out = attend(cfg, q_full, k_full, v, causal=causal)           # scale=(nd+rd)^-.5
    return mm(out.reshape(b, t, h * vd), p["wo"])


def mla_absorbed_weights(cfg: ModelConfig, p: Params) -> tuple[torch.Tensor, torch.Tensor]:
    """(W_uk [rank,H,nd], W_uv [rank,H,vd]): ``wkv_b``'s columns are laid
    out per head as [nd | vd] (the reshape in `mla_attention_block`)."""
    w_full = p["wkv_b"].reshape(cfg.kv_lora_rank, cfg.n_heads,
                                cfg.nope_head_dim + cfg.v_head_dim)
    return w_full[..., :cfg.nope_head_dim], w_full[..., cfg.nope_head_dim:]


def mla_decode(
    cfg: ModelConfig,
    x: torch.Tensor,               # [B,1,d]
    p: Params,
    ckv_cache: torch.Tensor,       # [B,S,rank]
    krope_cache: torch.Tensor,     # [B,S,rd]
    pos,                           # int (aligned batch) or [B] tensor (ragged)
    mm: Matmul = matmul,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed-form MLA decode over a dense cache: scores and outputs are
    computed in latent space.  Returns (y, ckv_cache, krope_cache); the
    caches are new tensors (the inputs are left untouched)."""
    b = x.shape[0]
    h, nd, rd, vd = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    pos = torch.as_tensor(pos, device=x.device)
    ragged = pos.dim() == 1                                       # [B] per-slot
    q_nope, q_rope = mla_project_q(cfg, x, p, mm=mm)              # [B,1,H,*]
    c_kv, k_rope = mla_project_kv_latent(cfg, x, p, mm=mm)        # [B,1,*]
    cos, sin = rope_cos_sin(pos[:, None] if ragged else pos[None], rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin, rd)
    k_rope = apply_rope(k_rope[..., None, :], cos, sin, rd)[..., 0, :]
    ckv_cache, krope_cache = ckv_cache.clone(), krope_cache.clone()
    if ragged:
        rows = torch.arange(b, device=x.device)
        ckv_cache[rows, pos.long()] = c_kv[:, 0].to(ckv_cache.dtype)
        krope_cache[rows, pos.long()] = k_rope[:, 0].to(krope_cache.dtype)
    else:
        ckv_cache[:, int(pos)] = c_kv[:, 0].to(ckv_cache.dtype)
        krope_cache[:, int(pos)] = k_rope[:, 0].to(krope_cache.dtype)
    w_uk, w_uv = mla_absorbed_weights(cfg, p)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    scale = (nd + rd) ** -0.5
    logits = (torch.einsum("bhr,bsr->bhs", q_lat, ckv_cache)
              + torch.einsum("bhr,bsr->bhs", q_rope[:, 0], krope_cache)).float() * scale
    span = torch.arange(ckv_cache.shape[1], device=x.device)[None, None, :]
    last = pos[:, None, None] if ragged else pos
    logits = torch.where(span <= last, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhs,bsr->bhr", probs, ckv_cache)        # [B,H,rank]
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv).reshape(b, 1, h * vd)
    return mm(out, p["wo"]), ckv_cache, krope_cache


def mla_attention_chunk(
    cfg: ModelConfig,
    x: torch.Tensor,               # [B,n,d]
    p: Params,
    ckv_cache: torch.Tensor,       # [B,S,rank], filled for [0, start)
    krope_cache: torch.Tensor,     # [B,S,rd]
    positions: torch.Tensor,       # [n]
    start: int,
    mm: Matmul = matmul,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLA prefill continuation: write the chunk's latents into the caches
    (in place), then attend in the expanded form, K/V re-expanded from the
    cached latents through ``wkv_b`` (prefill numerics, as
    `mla_attention_block`).  As `attention_chunk`, the caches are sliced to
    ``start + n`` where the reference masks the rest."""
    b, n, _ = x.shape
    h, nd, rd, vd = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = mla_project_q(cfg, x, p, mm=mm)
    c_kv, k_rope = mla_project_kv_latent(cfg, x, p, mm=mm)
    cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin, rd)
    k_rope = apply_rope(k_rope[..., None, :], cos, sin, rd)[..., 0, :]
    ckv_cache[:, start:start + n] = c_kv.to(ckv_cache.dtype)
    krope_cache[:, start:start + n] = k_rope.to(krope_cache.dtype)
    s = start + n
    kv = (ckv_cache[:, :s] @ p["wkv_b"]).reshape(b, s, h, nd + vd)
    k_nope, v = kv[..., :nd], kv[..., nd:]
    k_full = torch.cat([k_nope, krope_cache[:, :s, None, :].expand(b, s, h, rd)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = attend(cfg, q_full, k_full, v, causal=True, q_offset=start)
    return mm(out.reshape(b, n, h * vd), p["wo"]), ckv_cache, krope_cache
