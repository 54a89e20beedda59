"""The compute ops the serving engine calls around the direct-access kernels.

`tiered_matmul`, `tiered_decode_attention` and `paged_decode_attention` are
the port's counterparts of ``src/repro/kernels/ops.py``: they normalise the
window (an int >= 1; it paces the kernel's copies and never changes
results) and reshape around the kernel wrappers.  Unlike the reference they
neither pad to block multiples nor fall back to the oracle for an empty
tier or a cache length that is not a multiple of a block: the CUDA
kernels mask ragged edges themselves and take an empty tier, so every
tiered operand on the card goes through a kernel.  On a CPU tensor the wrappers
compute the plain version.

Each op takes an optional ``tuner`` (`kernels.autotune.Autotuner`) and asks
it for this shape's winner, as the reference's ops do, on the card and on
the CPU alike (where the plain versions ignore the knobs, so the keys a
CPU run collects are the card's): a tuned GEMM runs its ``k_split`` and
``window``; a tuned attention's ``slots`` cap the step's window.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.tiering import TieredTensor
from repro_torch.kernels.autotune import dtype_name
from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn, splitk_flashattn
from repro_torch.kernels.splitk_gemm import splitk_gemm


def tiered_matmul(
    x: torch.Tensor,                                   # [..., K]
    w: TieredTensor,                                   # column-split [K, N]
    *,
    window: int = 2,
    tuner=None,
) -> torch.Tensor:
    """y = x @ W with W column-partitioned across (HBM, host) tiers.  With a
    ``tuner`` holding (or sweeping) a winner for this shape, the winner's
    design (``k_split``) and ring depth replace the wrapper's choice and
    the step's window."""
    window = max(1, int(window))
    lead = x.shape[:-1]
    k = x.shape[-1]
    n_loc, n_rem = w.local.shape[1], w.remote.shape[1]
    k_split = None
    if tuner is not None and n_loc and n_rem:
        tuned = tuner.best_gemm(math.prod(lead), k, n_loc, n_rem, dtype_name(x.dtype))
        if tuned is not None:
            k_split, window = tuned["k_split"], tuned["window"]
    y = splitk_gemm(x.reshape(-1, k).contiguous(), w.local, w.remote, window=window,
                    k_split=k_split)
    return y.reshape(*lead, y.shape[-1])


def tiered_decode_attention(
    q: torch.Tensor,                     # [B, H, hd]
    kv: dict[str, torch.Tensor],         # k_local/v_local [B_loc,S,Kh,hd], k_remote/v_remote
    *,
    kv_len: int,
    window: int = 2,
    tuner=None,
) -> torch.Tensor:
    """Batch-split tiered decode attention over positions [0, kv_len):
    requests [0, B_loc) read the local cache, [B_loc, B) the remote one.
    A ``tuner`` caps the window at its tuned slots for the cache's shape."""
    window = max(1, int(window))
    kl, kr = kv["k_local"], kv["k_remote"]
    s = kl.shape[1]
    if tuner is not None and s:
        b_total = kl.shape[0] + kr.shape[0]
        rem_frac = kr.shape[0] / b_total if b_total else 0.0
        tuned = tuner.best_attn(q.shape[1], kl.shape[2], kl.shape[3], s, rem_frac,
                                dtype_name(q.dtype))
        if tuned is not None:
            window = max(1, min(window, tuned["slots"]))
    return splitk_flashattn(
        q.contiguous(), kv["k_local"], kv["v_local"], kv["k_remote"], kv["v_remote"],
        kv_len=int(kv_len), window=window)


def paged_decode_attention(
    q: torch.Tensor,                     # [B, H, hd]
    pools: dict[str, torch.Tensor],      # k_local/v_local [P_loc+1,page,Kh,hd], k_remote/v_remote
    table: torch.Tensor,                 # [B, MP] int32 — page index in its tier pool
    tier: torch.Tensor,                  # [B, MP] int32 — 0 local / 1 remote
    lens: torch.Tensor,                  # [B] int32 — valid tokens per slot (ragged)
    *,
    window: int = 2,
    scale: float | None = None,
    tuner=None,
) -> torch.Tensor:
    """Ragged paged tiered decode attention (per-slot kv lengths; each page
    read from the tier its page-table entry names).  ``scale`` overrides
    the ``hd**-0.5`` softmax scale.  A ``tuner`` caps the window at its
    tuned slots for the pools' shape (the page size fixes the chunk; only
    the ring depth is tunable, and it never changes results)."""
    window = max(1, int(window))
    kl, kr = pools["k_local"], pools["k_remote"]
    if tuner is not None:
        n_pages = kl.shape[0] + kr.shape[0]
        rem_frac = kr.shape[0] / n_pages if n_pages else 0.0
        tuned = tuner.best_paged(q.shape[1], kl.shape[2], kl.shape[3], kl.shape[1],
                                 table.shape[1], rem_frac, dtype_name(q.dtype))
        if tuned is not None:
            window = max(1, min(window, tuned["slots"]))
    return paged_splitk_flashattn(
        q.contiguous(), pools["k_local"], pools["v_local"], pools["k_remote"],
        pools["v_remote"], table, tier, lens, window=window, scale=scale)
