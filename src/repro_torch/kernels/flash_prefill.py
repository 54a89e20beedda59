"""Causal flash attention for prefill on Hopper.

Tiled online-softmax attention with group-major GQA (q head h reads kv head
h % Kh) and key tiles above the causal diagonal skipped.  The CUDA kernel
is ``csrc/flash_prefill.cu``; its head note says what bounds it (the
tensor cores' operations, at any real prompt length) and what each design
does about that.  Three designs, picked by :func:`design`: bfloat16 at hd
64 and 128 with 16-byte-aligned operands runs "wgmma" (Hopper's warpgroup
products on TMA-fed tiles, a producer warpgroup and two consumer
warpgroups); other bfloat16 launches run "mma" (mma.sync, bf16 tiles fed
by cp.async, softmax in registers); float32 runs "fma", plain FMA, since
TF32 would miss the reference's fp32 bound of 2e-4.

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
_DESIGNS = {"fma": 0, "mma": 1, "wgmma": 2}       # csrc/flash_prefill.cu DESIGN_*
BF16_DESIGNS = ("wgmma", "mma")                    # the bf16 designs, newest first
WGMMA_HEAD_DIMS = (64, 128)                        # the head dims the wgmma design takes
# (q, k) tile of each design: WG_BQ x WG_BK, TC_BQ x TC_BK, TILE x TILE
TILES = {"wgmma": (128, 128), "mma": (128, 64), "fma": (64, 64)}
WGMMA_STAGES = 2                                   # K/V stages of the wgmma ring
_ALIGN = 1024                                      # the wgmma design's alignment slack


def _is_fp32(dtype) -> bool:
    return elem_bytes(dtype) == 4


def design(hd: int, dtype, aligned: bool = True) -> str:
    """The design a launch takes, as the wrapper picks it: "fma" in
    float32; in bfloat16 "wgmma" at hd 64 or 128 when q, k, v and the
    output are 16-byte aligned (what a tensor map takes), else "mma"."""
    if _is_fp32(dtype):
        return "fma"
    return "wgmma" if hd in WGMMA_HEAD_DIMS and aligned else "mma"


def tiles(hd: int, *, dtype) -> tuple[int, int]:
    """The (q, k) tile of the design a launch at ``hd`` in ``dtype`` takes;
    each design's is fixed at compile time."""
    return TILES[design(hd, dtype)]


def smem_footprint_bytes(hd: int, *, dtype, which: str | None = None) -> int:
    """Dynamic shared memory of one `flash_prefill` launch, by the kernel's
    arithmetic (``csrc/flash_prefill.cu`` `fma_smem`, `tc_smem`, `wg_smem`)
    for the design a launch at ``hd`` takes (or ``which``): "fma" holds the
    fp32 q, k and v tiles of rows padded by one float, the 64 x 65 score
    tile and three row vectors; "mma" the Q tile and two K/V stages, hd
    padded to 32, 64, 128 or 256 and rows by 8 elements; "wgmma" 1024 bytes
    of alignment slack, the Q tile and two stages of K and V tiles of
    unpadded 128-byte-swizzled rows, and nine mbarriers (Q's, a full and an
    empty one for each K and V slot).  Counterpart of the reference's
    ``vmem_footprint_bytes``."""
    which = which or design(hd, dtype)
    bq, bk = TILES[which]
    if which == "fma":
        return (3 * bk * (hd + 1) + bq * (bk + 1) + 3 * bq) * 4
    if which == "mma":
        padded = next(p for p in (32, 64, 128, 256) if hd <= p or p == 256)
        return (bq + 4 * bk) * (padded + 8) * 2
    return _ALIGN + (bq + 2 * WGMMA_STAGES * bk) * hd * 2 + (1 + 4 * WGMMA_STAGES) * 8


def smem_query(hd: int, *, dtype, which: str | None = None) -> int:
    """The kernel's own count of its dynamic shared memory
    (``dak_flash_prefill_smem``).  Needs the card."""
    return _build.smem_query("flash_prefill", "dak_flash_prefill_smem", hd,
                             _DTYPES[dtype], _DESIGNS[which or design(hd, dtype)],
                             stages=False)[0]


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _launch(q, k, v, causal: bool, which: str) -> torch.Tensor:
    """One launch of the kernel's design ``which`` on checked CUDA operands,
    uncounted.  The wrapper passes :func:`design`'s pick; "mma" at hd 64 or
    128 is the design "wgmma" replaced there, kept reachable here only to
    measure it beside the new one."""
    out = torch.empty_like(q)
    b, h, tq, hd = q.shape
    rc = _build.load().libs["flash_prefill"].dak_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, k.shape[1], tq,
        k.shape[2], hd, int(bool(causal)), _DTYPES[q.dtype], _DESIGNS[which],
        _build.stream_handle(q.device))
    _build.check(rc, f"flash_prefill ({which} design)")
    return out


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
    the kernel's tiles are fixed per design (:data:`TILES`)."""
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
    if q.numel() == 0:
        return torch.empty_like(q)
    which = design(hd, q.dtype, _aligned(q, k, v))   # the output is a fresh, aligned tensor
    out = _launch(q, k, v, causal, which)
    flash_prefill.launches += 1
    flash_prefill.launches_by_design[which] += 1
    return out


flash_prefill.launches = 0   # kernel launches since the count was last reset
flash_prefill.launches_by_design = dict.fromkeys(_DESIGNS, 0)   # the same, by design
