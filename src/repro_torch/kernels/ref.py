"""Plain PyTorch versions of the direct-access kernels (the oracles).

Counterpart of ``src/repro/kernels/ref.py``.  The CPU path of every kernel
wrapper runs these, the CPU tests hold them against the JAX package, and
the chip smoke test holds each CUDA kernel against them on the card (with
all operands on the device, since ``torch`` ops cannot read a pinned host
tier from a CUDA computation)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def splitk_gemm_ref(x: torch.Tensor, w_local: torch.Tensor,
                    w_remote: torch.Tensor) -> torch.Tensor:
    """y = x @ concat(w_local, w_remote, axis=1) with fp32 accumulation,
    computed per tier and concatenated on the output."""
    xf = x.float()
    y_local = xf @ w_local.float()
    y_remote = xf @ w_remote.float()
    return torch.cat([y_local, y_remote], dim=1).to(x.dtype)


def splitk_gemm_grouped_ref(x: torch.Tensor, w_remote: torch.Tensor,
                            counts: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ w_remote[e] with fp32 accumulation for every expert e
    whose ``counts[e]`` is > 0, and zeros for the others (x [E, M, K],
    w_remote [E, K, N], counts [E])."""
    y = torch.einsum("emk,ekn->emn", x.float(), w_remote.float())
    return torch.where((counts > 0)[:, None, None], y, 0.0).to(x.dtype)


def paged_flashattn_ref(
    q: torch.Tensor,               # [B, H, hd]
    k_pages_local: torch.Tensor,   # [P_loc(+sink), page, Kh, hd]
    v_pages_local: torch.Tensor,
    k_pages_remote: torch.Tensor,  # [P_rem(+sink), page, Kh, hd]
    v_pages_remote: torch.Tensor,
    table: torch.Tensor,           # [B, MP] int32 — index into the page's tier pool
    tier: torch.Tensor,            # [B, MP] int32 — 0 local, 1 remote
    lens: torch.Tensor,            # [B] int32 — valid tokens per slot
    scale: float | None = None,
) -> torch.Tensor:
    """Paged tiered decode attention: gather each slot's pages from its
    tier pools into a dense [B, MP*page, Kh, hd] view, then per-slot masked
    softmax attention (group-major GQA: q head h reads kv head h % Kh).
    Slots with lens == 0 return zeros; ``scale`` overrides ``hd**-0.5``."""
    ps = k_pages_local.shape[1]
    table = table.long()
    idx_l = table.clamp(0, k_pages_local.shape[0] - 1)
    idx_r = table.clamp(0, k_pages_remote.shape[0] - 1)
    sel = (tier > 0)[..., None, None, None]
    k = torch.where(sel, k_pages_remote[idx_r], k_pages_local[idx_l])
    v = torch.where(sel, v_pages_remote[idx_r], v_pages_local[idx_l])
    b, mp = table.shape
    kh, hd = k.shape[-2], k.shape[-1]
    k = k.reshape(b, mp * ps, kh, hd).float()
    v = v.reshape(b, mp * ps, kh, hd).float()
    h = q.shape[1]
    g = h // kh
    sc = (hd ** -0.5) if scale is None else scale
    qg = q.reshape(b, g, kh, hd).float() * sc
    logits = torch.einsum("bgkh,bskh->bgks", qg, k)
    pos = torch.arange(mp * ps, device=q.device)
    mask = pos[None, None, None, :] < lens[:, None, None, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(lens[:, None, None, None] > 0, probs, torch.zeros_like(probs))
    out = torch.einsum("bgks,bskh->bgkh", probs, v)
    return out.reshape(b, h, hd).to(q.dtype)


def splitk_flashattn_ref(
    q: torch.Tensor,         # [B, H, hd], B = B_loc + B_rem
    k_local: torch.Tensor,   # [B_loc, S, Kh, hd]
    v_local: torch.Tensor,
    k_remote: torch.Tensor,  # [B_rem, S, Kh, hd]
    v_remote: torch.Tensor,
    kv_len: int,
) -> torch.Tensor:
    """Batch-split tiered decode attention: softmax attention over positions
    [0, kv_len), batch rows [0, B_loc) from the local cache and [B_loc, B)
    from the remote cache, each tier attended on its own and the outputs
    concatenated (group-major GQA).  The reference masks positions past
    ``kv_len``; slicing them off gives the same result and never reads them."""

    def _attend(qt: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, h, hd = qt.shape
        kh = k.shape[2]
        qg = qt.reshape(b, h // kh, kh, hd).float() * (hd ** -0.5)
        logits = torch.einsum("bgkh,bskh->bgks", qg, k[:, :kv_len].float())
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgks,bskh->bgkh", probs, v[:, :kv_len].float())
        return out.reshape(b, h, hd)

    b_loc = k_local.shape[0]
    out_local = _attend(q[:b_loc], k_local, v_local)
    out_remote = _attend(q[b_loc:], k_remote, v_remote)
    return torch.cat([out_local, out_remote], dim=0).to(q.dtype)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Causal (or full) attention in the kernel's layout: q [B, H, Tq, hd],
    k/v [B, Kh, Tk, hd] -> [B, H, Tq, hd] in q's dtype.  The math of the
    reference's ``layers._attend_dense`` (group-major GQA: q head h reads kv
    head h % Kh; key positions above the query's masked), kept in fp32
    throughout as the kernel keeps it."""
    b, h, tq, hd = q.shape
    kh, tk = k.shape[1], k.shape[2]
    qg = q.reshape(b, h // kh, kh, tq, hd).float() * (hd ** -0.5)
    logits = torch.einsum("bgktd,bksd->bgkts", qg, k.float())
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None]
        kpos = torch.arange(tk, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgkts,bksd->bgktd", probs, v.float())
    return out.reshape(b, h, tq, hd).to(q.dtype)
