"""SplitK_FlashAttn — direct-access tiered decode attention (paper §5) on
Hopper, in both of the reference's layouts.

* :func:`paged_splitk_flashattn` — ragged, paged decode attention: each
  slot's KV pages are read from the pool its page table names (local pages
  from HBM, remote pages straight from pinned, device-mapped host memory),
  slots holding remote pages first.  CUDA kernel ``csrc/paged_flashattn.cu``;
  counterpart of the reference's ``_paged_kernel``.  The serving engine's
  decode step runs it.
* :func:`splitk_flashattn` — the paper's batch-split layout: requests
  ``[0, B_loc)`` attend a local cache in HBM and ``[B_loc, B)`` a remote
  cache in pinned host memory, every request over the same ``kv_len``
  positions, remote requests first (the reference's host-first batch
  order, which the kernel takes from its block index).  CUDA kernel
  ``csrc/splitk_flashattn.cu``; counterpart of the reference's ``_kernel``.
  The batch-split ``serving.tiered_decode.tiered_decode_step`` runs it.

In both kernels one CTA per (sequence, query-head group, kv head) reads its
pages or chunks by TMA through a ``window + 1``-stage shared-memory ring and
keeps a warp-level fp32 online softmax over group-major GQA heads.  Each
kernel's head note says what bounds it and what the design does about that.
Also here: :func:`scatter_rows`, the decode steps' K/V row writer, whose
CUDA side writes remote rows through the mapped pointer.  A CPU tensor takes
each function's plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_flashattn_ref, splitk_flashattn_ref
from repro_torch.kernels.splitk_gemm import MAX_WINDOW, elem_bytes

DEFAULT_WINDOW = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 1024         # the widest hd the kernels take (its q and acc live in registers)
RING_MAX = 96 * 1024        # the K/V ring's cap in shared memory (decode_attn.cuh RING_MAX)
CHUNK = 32                  # rows of one batch-split load (splitk_flashattn.cu CHUNK)
_WARPS = 4                  # warps of a CTA (decode_attn.cuh THREADS / 32)


def _dims_per_lane(hd: int) -> int:
    return next(d for d, top in ((1, 32), (2, 64), (4, 128), (8, 256), (16, 512), (32, None))
                if top is None or hd <= top)


def _heads_per_cta(dpl: int, h: int, kh: int) -> int:
    """Query heads a CTA takes (decode_attn.cuh `heads_per_cta`): one when
    G = 1 or hd > 256, else as many as keep q and acc within 64 registers."""
    if dpl > 8 or h == kh:
        return 1
    return 4 if dpl == 8 else 8


def _box_bytes(rows: int, hd: int, elem: int) -> int:
    return -(-rows * hd * elem // 128) * 128


def ring_stages(window: int, stage_bytes: int, chunks: int) -> tuple[int, str | None]:
    """The K/V ring's stages as the kernels compute them (decode_attn.cuh
    `ring_stages`): ``min(window, MAX_WINDOW) + 1``, cut to what fits in
    RING_MAX and to the sequence's chunks.  Also returns what cut the
    requested ring (``window + 1`` stages), None if nothing: "MAX_WINDOW",
    "RING_MAX" or "chunks"."""
    window = max(1, int(window))
    stages, cut = min(window, MAX_WINDOW) + 1, ("MAX_WINDOW" if window > MAX_WINDOW else None)
    fit = RING_MAX // stage_bytes
    if stages > fit:
        stages, cut = fit, "RING_MAX"
    if stages > chunks:
        stages, cut = chunks, cut or "chunks"
    return max(1, stages), cut


def _launch_smem(stages: int, box: int, dpl: int, hpw: int, extra: int) -> int:
    merge = _WARPS * hpw * (32 * dpl + 2) * 4
    return max(stages * 2 * box, merge) + stages * 8 + extra


def paged_smem_footprint_bytes(b: int, h: int, kh: int, hd: int, page_size: int,
                               max_pages: int, *, window: int, dtype) -> int:
    """Dynamic shared memory of one `paged_splitk_flashattn` launch, by the
    kernel's arithmetic (``csrc/paged_flashattn.cu`` `paged_smem`): a ring
    of K and V page boxes (`ring_stages` over ``max_pages``), or the warps'
    merge scratch that reuses it if larger, one mbarrier a stage, and the
    slot's page list and the remote flags, ``(max_pages + b)`` ints.
    Counterpart of the reference's ``paged_vmem_footprint_bytes``."""
    dpl = _dims_per_lane(hd)
    box = _box_bytes(page_size, hd, elem_bytes(dtype))
    stages, _ = ring_stages(window, 2 * box, max_pages)
    return _launch_smem(stages, box, dpl, _heads_per_cta(dpl, h, kh), (max_pages + b) * 4)


def smem_footprint_bytes(h: int, kh: int, hd: int, kv_len: int, *, window: int,
                         dtype) -> int:
    """Dynamic shared memory of one `splitk_flashattn` (batch-split)
    launch, by the kernel's arithmetic (``csrc/splitk_flashattn.cu``
    `split_smem`): a ring of CHUNK-row K and V boxes over ``kv_len``
    positions, or the merge scratch if larger, and one mbarrier a stage.
    Counterpart of the reference's ``vmem_footprint_bytes``."""
    dpl = _dims_per_lane(hd)
    box = _box_bytes(CHUNK, hd, elem_bytes(dtype))
    stages, _ = ring_stages(window, 2 * box, -(-kv_len // CHUNK))
    return _launch_smem(stages, box, dpl, _heads_per_cta(dpl, h, kh), 0)


def paged_smem_query(b: int, h: int, kh: int, hd: int, page_size: int, max_pages: int, *,
                     window: int, dtype) -> tuple[int, int]:
    """The paged kernel's own count: ``(dynamic shared memory bytes, ring
    stages)`` from ``dak_paged_attention_smem``.  Needs the card."""
    return _build.smem_query("paged_flashattn", "dak_paged_attention_smem", b, h, kh, hd,
                             page_size, max_pages, max(1, int(window)),
                             0 if elem_bytes(dtype) == 4 else 1)


def smem_query(h: int, kh: int, hd: int, kv_len: int, *, window: int,
               dtype) -> tuple[int, int]:
    """The batch-split kernel's own count: ``(dynamic shared memory bytes,
    ring stages)`` from ``dak_splitk_attention_smem``.  Needs the card."""
    return _build.smem_query("splitk_flashattn", "dak_splitk_attention_smem", h, kh, hd, kv_len,
                             max(1, int(window)), 0 if elem_bytes(dtype) == 4 else 1)


def host_first_slot_order(tier: np.ndarray, lens: np.ndarray, page_size: int) -> np.ndarray:
    """The slot each rank of CTAs attends, as the paged kernel derives it:
    slots holding any in-use remote page first, stable within each class
    (the reference's ``host_first_slot_order``)."""
    tier, lens = np.asarray(tier), np.asarray(lens)
    in_use = np.arange(tier.shape[1])[None, :] < -(-lens[:, None] // page_size)
    has_remote = np.any((tier > 0) & in_use, axis=1)
    return np.argsort(~has_remote, kind="stable").astype(np.int32)


class Launch(NamedTuple):
    """One kernel launch prepared by a wrapper: the output it writes and the
    C entry point's arguments."""

    out: torch.Tensor
    args: tuple


def _paged_launch(q, k_loc, v_loc, k_rem, v_rem, table, tier, lens, window: int,
                  scale: float | None) -> Launch:
    """The paged kernel's arguments for checked CUDA operands (B >= 1), with
    the output allocated."""
    b, h, hd = q.shape
    _, ps, kh, _ = k_loc.shape
    out = torch.empty_like(q)
    sc = (hd ** -0.5) if scale is None else float(scale)
    return Launch(out, (
        q.data_ptr(), k_loc.data_ptr(), v_loc.data_ptr(), k_rem.data_ptr(), v_rem.data_ptr(),
        table.data_ptr(), tier.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, h, kh, hd, ps, table.shape[1], k_loc.shape[0], k_rem.shape[0], sc,
        max(1, int(window)), _DTYPES[q.dtype], _build.stream_handle(q.device)))


def _launch_paged(launch: Launch) -> torch.Tensor:
    """The paged kernel's launch alone: one call of its C entry point on
    prepared arguments (uncounted; the wrapper counts)."""
    _build.check(_build.load().libs["paged_flashattn"].dak_paged_attention(*launch.args),
                 "paged_splitk_flashattn")
    return launch.out


def _batch_split_launch(q, k_loc, v_loc, k_rem, v_rem, kv_len: int, window: int) -> Launch:
    """The batch-split kernel's arguments for checked CUDA operands (B >= 1),
    with the output allocated."""
    b, h, hd = q.shape
    b_loc, s, kh, _ = k_loc.shape
    out = torch.empty_like(q)
    return Launch(out, (
        q.data_ptr(), k_loc.data_ptr(), v_loc.data_ptr(), k_rem.data_ptr(), v_rem.data_ptr(),
        out.data_ptr(), b_loc, k_rem.shape[0], s, h, kh, hd, int(kv_len), max(1, int(window)),
        _DTYPES[q.dtype], _build.stream_handle(q.device)))


def _launch_batch_split(launch: Launch) -> torch.Tensor:
    """The batch-split kernel's launch alone: one call of its C entry point
    on prepared arguments (uncounted; the wrapper counts)."""
    _build.check(_build.load().libs["splitk_flashattn"].dak_splitk_attention(*launch.args),
                 "splitk_flashattn")
    return launch.out


def _check_pool(name: str, pool: torch.Tensor, like: torch.Tensor, remote: bool) -> None:
    if pool.dtype != like.dtype:
        raise TypeError(f"{name} is {pool.dtype}, q is {like.dtype}")
    if pool.dim() != 4 or not pool.is_contiguous() or pool.shape[0] == 0:
        raise ValueError(f"{name} must be a contiguous non-empty "
                         f"[P, page, Kh, hd] pool, got {tuple(pool.shape)}")
    if remote and (pool.device.type != "cpu" or not pool.is_pinned()):
        raise ValueError(f"{name} must be pinned host memory (the remote tier)")
    if not remote and pool.device != like.device:
        raise ValueError(f"{name} must live on {like.device} (the local tier)")


def _check_index(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be a contiguous int32 {shape} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def paged_splitk_flashattn(
    q: torch.Tensor,               # [B, H, hd]
    k_pages_local: torch.Tensor,   # [P_loc(+sink), page, Kh, hd]
    v_pages_local: torch.Tensor,
    k_pages_remote: torch.Tensor,
    v_pages_remote: torch.Tensor,
    table: torch.Tensor,           # [B, MP] int32
    tier: torch.Tensor,            # [B, MP] int32 (0 local / 1 remote)
    lens: torch.Tensor,            # [B] int32
    *,
    window: int = DEFAULT_WINDOW,
    scale: float | None = None,
) -> torch.Tensor:
    """Paged tiered flash-decode -> [B, H, hd] in q's dtype.  lens == 0
    slots give zeros; ``scale`` overrides ``hd**-0.5``; passing the K pools
    as the V pools reads V from them.  ``window`` (>= 1) is the number of
    page loads each CTA keeps in flight and never changes the result.  On
    the card hd <= 1024."""
    if q.device.type == "cpu":
        return paged_flashattn_ref(q, k_pages_local, v_pages_local, k_pages_remote,
                                   v_pages_remote, table, tier, lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_splitk_flashattn runs on cpu or cuda tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_splitk_flashattn takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [B, H, hd] tensor, got {tuple(q.shape)}")
    b, h, hd = q.shape
    _check_pool("k_pages_local", k_pages_local, q, remote=False)
    _check_pool("v_pages_local", v_pages_local, q, remote=False)
    _check_pool("k_pages_remote", k_pages_remote, q, remote=True)
    _check_pool("v_pages_remote", v_pages_remote, q, remote=True)
    _, ps, kh, hd_pool = k_pages_local.shape
    for name, pool in (("v_pages_local", v_pages_local), ("k_pages_remote", k_pages_remote),
                       ("v_pages_remote", v_pages_remote)):
        if tuple(pool.shape[1:]) != (ps, kh, hd_pool):
            raise ValueError(f"{name} pages are {tuple(pool.shape[1:])}, "
                             f"k_pages_local's are {(ps, kh, hd_pool)}")
    if hd_pool != hd or h % kh:
        raise ValueError(f"q [B, H={h}, hd={hd}] does not fit pools with Kh={kh}, hd={hd_pool}")
    if k_pages_remote.shape[0] != v_pages_remote.shape[0] or \
            k_pages_local.shape[0] != v_pages_local.shape[0]:
        raise ValueError("K and V pools of a tier must hold the same number of pages")
    mp = table.shape[1] if table.dim() == 2 else -1
    _check_index("table", table, (b, mp), q.device)
    _check_index("tier", tier, (b, mp), q.device)
    _check_index("lens", lens, (b,), q.device)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"paged_splitk_flashattn takes hd <= {MAX_HEAD_DIM} on the card, "
                         f"got {hd}")
    if b == 0:
        return torch.empty_like(q)
    out = _launch_paged(_paged_launch(q, k_pages_local, v_pages_local, k_pages_remote,
                                      v_pages_remote, table, tier, lens, window, scale))
    paged_splitk_flashattn.launches += 1
    return out


paged_splitk_flashattn.launches = 0   # kernel launches since the count was last reset


def _check_cache(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != like.dtype:
        raise TypeError(f"{name} is {t.dtype}, q is {like.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [B_tier, S, Kh, hd] cache, "
                         f"got {tuple(t.shape)}")


def splitk_flashattn(
    q: torch.Tensor,          # [B, H, hd], B = B_loc + B_rem, local requests first
    k_local: torch.Tensor,    # [B_loc, S, Kh, hd]
    v_local: torch.Tensor,
    k_remote: torch.Tensor,   # [B_rem, S, Kh, hd]
    v_remote: torch.Tensor,
    *,
    kv_len: int,
    window: int = DEFAULT_WINDOW,
) -> torch.Tensor:
    """Batch-split tiered flash-decode over positions ``[0, kv_len)`` ->
    [B, H, hd] in q's dtype.

    Either tier may be empty (offload 0 or 1).  On the card ``q`` and the
    local cache are device tensors and a non-empty remote cache is pinned
    host memory that the kernel reads in place.  ``window`` (>= 1) is the
    number of chunk loads each CTA keeps in flight and never changes the
    result; the kernel masks the ragged last chunk, so any ``S`` is taken.
    On the card hd <= 1024."""
    if q.dim() != 3:
        raise ValueError(f"q must be a [B, H, hd] tensor, got {tuple(q.shape)}")
    for name, t in (("k_local", k_local), ("v_local", v_local),
                    ("k_remote", k_remote), ("v_remote", v_remote)):
        _check_cache(name, t, q)
    b, h, hd = q.shape
    b_loc, s, kh, hd_c = k_local.shape
    b_rem = k_remote.shape[0]
    if tuple(v_local.shape) != tuple(k_local.shape) or \
            tuple(v_remote.shape) != tuple(k_remote.shape) or \
            tuple(k_remote.shape[1:]) != (s, kh, hd_c):
        raise ValueError(f"caches do not match: K/V local {tuple(k_local.shape)}/"
                         f"{tuple(v_local.shape)}, remote {tuple(k_remote.shape)}/"
                         f"{tuple(v_remote.shape)}")
    if b != b_loc + b_rem:
        raise ValueError(f"batch mismatch: q has {b} requests, the tiers {b_loc}+{b_rem}")
    if hd_c != hd or kh == 0 or h % kh:
        raise ValueError(f"q [B, H={h}, hd={hd}] does not fit caches with Kh={kh}, hd={hd_c}")
    if not 1 <= kv_len <= s:
        raise ValueError(f"kv_len={kv_len} must lie in [1, S={s}]")
    if q.device.type == "cpu":
        return splitk_flashattn_ref(q, k_local, v_local, k_remote, v_remote, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"splitk_flashattn runs on cpu or cuda tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"splitk_flashattn takes float32 or bfloat16, got {q.dtype}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k_local", k_local), ("v_local", v_local)):
        if t.numel() and t.device != q.device:
            raise ValueError(f"{name} must live on {q.device} (the local tier)")
    for name, t in (("k_remote", k_remote), ("v_remote", v_remote)):
        if t.numel() and (t.device.type != "cpu" or not t.is_pinned()):
            raise ValueError(f"{name} must be pinned host memory (the remote tier)")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"splitk_flashattn takes hd <= {MAX_HEAD_DIM} on the card, got {hd}")
    if b == 0:
        return torch.empty_like(q)
    out = _launch_batch_split(_batch_split_launch(q, k_local, v_local, k_remote, v_remote,
                                                  kv_len, window))
    splitk_flashattn.launches += 1
    return out


splitk_flashattn.launches = 0   # kernel launches since the count was last reset


def scatter_rows_ref(pool: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
                     off: torch.Tensor) -> None:
    """Plain version: ``pool[idx[b], off[b]] = rows[b]`` for every slot b,
    in place (pool [P, page, Kh, hd], rows [B, Kh, hd])."""
    pool[idx.long(), off.long()] = rows.to(pool.dtype)


def scatter_rows(pool: torch.Tensor, rows: torch.Tensor, wr_tier: torch.Tensor,
                 wr_idx: torch.Tensor, wr_off: torch.Tensor, tier_sel: int,
                 sink: int, *, remote: bool) -> None:
    """Write each slot's new K/V row into one tier's pool, in place.

    Slot b's row goes to page ``wr_idx[b]`` at offset ``wr_off[b]`` when
    ``wr_tier[b] == tier_sel``.  The plain version, like the reference's
    ``_paged_writer``, sends every other slot's row to the tier's ``sink``
    page (never read); the CUDA helper skips those writes instead, so a
    remote pool is written only where a row belongs.  ``remote`` says the
    pool is the pinned host tier, which the CUDA side writes through its
    mapped pointer."""
    if pool.device.type == "cpu" and rows.device.type == "cpu":
        idx = torch.where(wr_tier == tier_sel, wr_idx, torch.full_like(wr_idx, sink))
        scatter_rows_ref(pool, rows, idx, wr_off)
        return
    if rows.device.type != "cuda":
        raise ValueError(f"scatter_rows runs on cpu or cuda rows, got {rows.device}")
    b = rows.shape[0]
    if pool.dim() != 4 or tuple(pool.shape[2:]) != tuple(rows.shape[1:]) \
            or pool.dtype != rows.dtype or not pool.is_contiguous() \
            or not rows.is_contiguous():
        raise ValueError(f"rows {rows.dtype} {tuple(rows.shape)} do not fit pool "
                         f"{pool.dtype} {tuple(pool.shape)}")
    if remote and (pool.device.type != "cpu" or not pool.is_pinned()):
        raise ValueError("a remote pool must be pinned host memory")
    if not remote and pool.device != rows.device:
        raise ValueError(f"a local pool must live on {rows.device}")
    for name, t in (("wr_tier", wr_tier), ("wr_idx", wr_idx), ("wr_off", wr_off)):
        _check_index(name, t, (b,), rows.device)
    if b == 0:
        return
    row_bytes = rows[0].numel() * rows.element_size()
    rc = _build.load().libs["paged_flashattn"].dak_scatter_rows(
        pool.data_ptr(), rows.data_ptr(), wr_tier.data_ptr(), wr_idx.data_ptr(),
        wr_off.data_ptr(), int(tier_sel), b, pool.shape[0], pool.shape[1], row_bytes,
        int(remote), _build.stream_handle(rows.device))
    _build.check(rc, "scatter_rows")
    scatter_rows.launches += 1


scatter_rows.launches = 0   # helper launches since the count was last reset
