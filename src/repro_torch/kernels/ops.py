"""The compute ops the serving engine calls around the direct-access kernels.

`tiered_matmul` and `paged_decode_attention` are the port's counterparts of
``src/repro/kernels/ops.py``: they normalise the window (an int >= 1; it
paces the kernel's copies and never changes results) and reshape around
the kernel wrappers.  Unlike the reference they neither pad to block
multiples nor fall back to the oracle for an empty tier: the CUDA kernels
mask ragged edges themselves and take an empty tier, so every tiered
operand on the card goes through a kernel.  On a CPU tensor the wrappers
compute the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.tiering import TieredTensor
from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn
from repro_torch.kernels.splitk_gemm import splitk_gemm


def tiered_matmul(
    x: torch.Tensor,                                   # [..., K]
    w: TieredTensor,                                   # column-split [K, N]
    *,
    window: int = 2,
) -> torch.Tensor:
    """y = x @ W with W column-partitioned across (HBM, host) tiers."""
    window = max(1, int(window))
    lead = x.shape[:-1]
    k = x.shape[-1]
    y = splitk_gemm(x.reshape(-1, k).contiguous(), w.local, w.remote, window=window)
    return y.reshape(*lead, y.shape[-1])


def paged_decode_attention(
    q: torch.Tensor,                     # [B, H, hd]
    pools: dict[str, torch.Tensor],      # k_local/v_local [P_loc+1,page,Kh,hd], k_remote/v_remote
    table: torch.Tensor,                 # [B, MP] int32 — page index in its tier pool
    tier: torch.Tensor,                  # [B, MP] int32 — 0 local / 1 remote
    lens: torch.Tensor,                  # [B] int32 — valid tokens per slot (ragged)
    *,
    window: int = 2,
    scale: float | None = None,
) -> torch.Tensor:
    """Ragged paged tiered decode attention (per-slot kv lengths; each page
    read from the tier its page-table entry names).  ``scale`` overrides
    the ``hd**-0.5`` softmax scale."""
    window = max(1, int(window))
    return paged_splitk_flashattn(
        q.contiguous(), pools["k_local"], pools["v_local"], pools["k_remote"],
        pools["v_remote"], table, tier, lens, window=window, scale=scale)
