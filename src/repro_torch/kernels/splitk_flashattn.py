"""SplitK_FlashAttn, paged variant — direct-access tiered decode attention
(paper §5) on Hopper.

Ragged, paged decode attention: each slot's KV pages are read from the
pool its page table names — local pages from HBM, remote pages straight
from pinned, device-mapped host memory — through a ``window``-deep
shared-memory ring, slots holding remote pages first, with an fp32 online
softmax over group-major GQA heads.  The CUDA kernel is
``csrc/paged_flashattn.cu``; its head note says what bounds it and what
the design does about that.

Counterpart of ``src/repro/kernels/splitk_flashattn.py`` (``_paged_kernel``;
the batch-split ``_kernel`` is not ported yet).  Also here:
:func:`scatter_rows`, the decode step's K/V row writer, whose CUDA side
writes remote rows through the mapped pointer.  A CPU tensor takes each
function's plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_flashattn_ref

DEFAULT_WINDOW = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    as the V pools reads V from them.  ``window`` (>= 1) is the page ring
    depth and never changes the result."""
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
    out = torch.empty_like(q)
    if b == 0:
        return out
    sc = (hd ** -0.5) if scale is None else float(scale)
    rc = _build.load().libs["paged_flashattn"].dak_paged_attention(
        q.data_ptr(), k_pages_local.data_ptr(), v_pages_local.data_ptr(),
        k_pages_remote.data_ptr(), v_pages_remote.data_ptr(),
        table.data_ptr(), tier.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, h, kh, hd, ps, mp, k_pages_local.shape[0], k_pages_remote.shape[0],
        sc, max(1, int(window)), _DTYPES[q.dtype], _build.stream_handle(q.device))
    _build.check(rc, "paged_splitk_flashattn")
    paged_splitk_flashattn.launches += 1
    return out


paged_splitk_flashattn.launches = 0   # kernel launches since the count was last reset


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
