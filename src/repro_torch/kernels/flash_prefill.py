"""Causal flash attention for prefill on Hopper.

Tiled online-softmax attention with group-major GQA (q head h reads kv head
h % Kh) and key tiles above the causal diagonal skipped.  The CUDA kernel
is ``csrc/flash_prefill.cu``; its head note says what bounds it (the
tensor cores' operations, at any real prompt length) and what the design
does about that.  Two paths, by dtype: bfloat16 runs on the tensor cores
(mma.sync, bf16 tiles fed by cp.async, softmax in registers); float32 runs
by plain FMA, since TF32 would miss the reference's fp32 bound of 2e-4.

Counterpart of ``src/repro/kernels/flash_prefill.py``.  As in the
reference it is off the serving path: prefill attends through
``models.layers.attend``.  A CPU tensor takes the plain version,
:func:`~repro_torch.kernels.ref.flash_prefill_ref`; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_prefill_ref
from repro_torch.kernels.sink import direct_access
from repro_torch.kernels.splitk_gemm import elem_bytes

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_BLOCK_Q, TC_BLOCK_K = 128, 64     # the bf16 tensor-core path's q and k tiles
FMA_TILE = 64                        # the fp32 FMA path's q and k tile


def _is_fp32(dtype) -> bool:
    return elem_bytes(dtype) == 4


def tiles(dtype) -> tuple[int, int]:
    """The (q, k) tile the kernel is compiled with for ``dtype``."""
    return (FMA_TILE, FMA_TILE) if _is_fp32(dtype) else (TC_BLOCK_Q, TC_BLOCK_K)


def smem_footprint_bytes(hd: int, *, dtype) -> int:
    """Dynamic shared memory of one `flash_prefill` launch, by the kernel's
    arithmetic (``csrc/flash_prefill.cu`` `fma_smem`, `tc_smem`): in fp32
    the q, k and v tiles of rows padded by one float, the 64 x 65 score
    tile and three row vectors; in bf16 the Q tile and two K/V stages, hd
    padded to 32, 64, 128 or 256 and rows by 8 elements.  Counterpart of
    the reference's ``vmem_footprint_bytes``."""
    if _is_fp32(dtype):
        return (3 * FMA_TILE * (hd + 1) + FMA_TILE * (FMA_TILE + 1) + 3 * FMA_TILE) * 4
    padded = next(p for p in (32, 64, 128, 256) if hd <= p or p == 256)
    return (TC_BLOCK_Q + 4 * TC_BLOCK_K) * (padded + 8) * 2


def smem_query(hd: int, *, dtype) -> int:
    """The kernel's own count of its dynamic shared memory
    (``dak_flash_prefill_smem``).  Needs the card."""
    return _build.smem_query("flash_prefill", "dak_flash_prefill_smem", hd,
                             0 if _is_fp32(dtype) else 1, stages=False)[0]


@direct_access(lambda q, k, v, *, causal=True: flash_prefill_ref(q, k, v, causal))
def flash_prefill(
    q: torch.Tensor,          # [B, H, Tq, hd]
    k: torch.Tensor,          # [B, Kh, Tk, hd]
    v: torch.Tensor,          # [B, Kh, Tk, hd]
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Causal (or full) attention -> [B, H, Tq, hd] in q's dtype.

    Unlike the reference, any Tq and Tk are taken: the kernel masks the
    ragged edge.  The reference's ``block_q``/``block_k`` are not taken:
    the kernel's tiles are fixed, 128 query rows by 64 keys in bf16 and
    64 by 64 in fp32."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"q must be [B, H, Tq, hd] and k, v [B, Kh, Tk, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, hd = q.shape
    kh = k.shape[1]
    if k.shape[0] != b or k.shape[3] != hd or kh == 0 or h % kh or k.shape[2] == 0:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v {tuple(k.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cpu or cuda tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_prefill takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on {q.device}")
    if hd > 256:
        raise ValueError(f"flash_prefill takes head dims up to 256, got {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _build.load().libs["flash_prefill"].dak_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kh, tq, k.shape[2],
        hd, int(bool(causal)), _DTYPES[q.dtype], _build.stream_handle(q.device))
    _build.check(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0   # kernel launches since the count was last reset
