"""SplitK_GEMM — direct-access tiered GEMM (paper §4.1, Fig. 5) on Hopper.

Computes ``y = x @ concat(w_local, w_remote, axis=1)`` where the weight is
column-partitioned between the local tier (HBM) and the remote tier
(pinned, device-mapped host memory).  The CUDA kernel
(``csrc/splitk_gemm.cu``) reads every output tile's weight straight from
the tile's home tier into a ``window``-deep shared-memory ring, remote
tiles first, and accumulates in fp32; its head note says what bounds it
and what the design does about that.  Two designs, one launch each:

* split-K decode (M <= 16, operands a tensor map can describe): both
  tiers split along K into :func:`decode_k_split` rows per CTA, each load
  one TMA box of 32 rows of a 64-column tile; partial sums go to a
  workspace this wrapper allocates and are added in split order by the
  last CTA of each tile (the ticket counters are kept per device and
  stream, zero between launches).  A remote tier of 132 tiles or more
  takes one split, which needs neither;
* whole K (prefill, and decode operands whose rows are not 16-byte
  multiples or aligned): one CTA per 64 columns walks all of K.

A third entry, :func:`splitk_gemm_grouped`, runs a remote MoE expert
stack ``[E, K, N]``: one launch of the split-K decode design over every
expert, each CTA reading the routed-slot count of its expert on the device
and returning before any load when it is 0.

All designs stop at the rate at which kernels can read pinned host memory
over PCIe: 30-33 GB/s at most on some H100 machines measured, 0.58-0.70x
the copy engine's 45-54 GB/s, and ~50 GB/s, 0.95x the copy engine, on
others (``chip_smoke.py --phases 1,9``).

Under a serving mesh the remote operand is instead the remote tier gathered
into a fixed buffer on the card (`kernels.ops.mesh_fetch_params`): the
kernels take either address, and the wrapper refuses any other placement.

Counterpart of ``src/repro/kernels/splitk_gemm.py`` (``_kernel``).  A CPU
tensor takes the plain version, :func:`splitk_gemm_ref`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import splitk_gemm_grouped_ref, splitk_gemm_ref
from repro_torch.kernels.sink import direct_access

DEFAULT_WINDOW = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_M = 16           # rows the decode design takes in one tile
DECODE_BN = 64              # its tile columns (csrc/splitk_gemm.cu DBN)
DECODE_BK = 32              # rows of one of its loads (DBK)
REMOTE_CTAS_PER_SM = 1      # remote CTAs a split aims for, per SM
GROUPED_MAX_M = 64          # rows of an M tile of the grouped entry (GROUPED_MAX_MB)
DSMEM_MAX = 200 * 1024      # the split-K ring's cap in shared memory (DSMEM_MAX)
WHOLE_K_BN, WHOLE_K_BK = 64, 32      # the whole-K design's tile columns and chunk rows (BN, BK)
MAX_WINDOW = 8              # DAK_MAX_WINDOW (dak_common.cuh): the whole-K ring's stages,
                            # the attention rings' loads in flight, at most
TMA_BOX_MAX = 256           # elements a tensor-map box may span in each dimension

# SMs of the GPU profiles: the copied hardware table has no such field.  A
# profile without one (the TPU's, kept for comparing keys with the
# reference) gets the H100's count, since the designs are its kernels'.
_PROFILE_SM_COUNT = {"h100_sxm": 132, "gh200": 132, "rtx6000_blackwell": 188}


def sm_count(hw) -> int:
    """SMs of a hardware profile (`core.hardware.HardwareSpec`), behind the
    modeled default split; a launch reads its card's own (`_sm_count`)."""
    return _PROFILE_SM_COUNT.get(hw.name, _PROFILE_SM_COUNT["h100_sxm"])


def decode_k_split(n_loc: int, n_rem: int, k: int, sm_count: int) -> int:
    """Rows of K each CTA of the split-K decode design reads, in both tiers.

    The largest multiple of DECODE_BK that still gives at least
    ``REMOTE_CTAS_PER_SM * sm_count`` remote CTAs (tiles of DECODE_BN
    columns times splits), or one load per CTA where K is too short for
    that; a remote tier that already has that many tiles gets one split
    covering K.  The local tier's tiles decide when the remote tier is
    empty.  Splits start at multiples of DECODE_BK and the last one ends
    at K."""
    tiles = max(1, -(-(n_rem or n_loc) // DECODE_BN))
    loads = -(-k // DECODE_BK)
    want = -(-REMOTE_CTAS_PER_SM * sm_count // tiles)
    return max(1, loads // want) * DECODE_BK


def elem_bytes(dtype) -> int:
    """Bytes of one element of a torch dtype, a dtype name ("bfloat16") or
    an element size given as an int."""
    if isinstance(dtype, int):
        return dtype
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return {"float32": 4, "bfloat16": 2, "float16": 2}[str(dtype)]


def _decode_mb(m: int) -> int:
    """Rows of x a split-K load carries: the power of two >= M, up to 16."""
    return next(mb for mb in (1, 2, 4, 8, DECODE_MAX_M) if m <= mb or mb == DECODE_MAX_M)


def _whole_k_bm(m: int) -> int:
    """Rows of a whole-K M tile: 16, 64 or 128 (the dispatch on M)."""
    return 16 if m <= 16 else 64 if m <= 64 else 128


def decode_shapes_ok(m: int, k: int, n_loc: int, n_rem: int, elem: int) -> bool:
    """Whether the split-K decode design takes these extents: M <= 16 and
    rows of 16-byte multiples (bases must also be 16-byte aligned, which
    only tensors can tell: `_decode_operands_ok`)."""
    return (m <= DECODE_MAX_M and k * elem % 16 == 0 and n_loc * elem % 16 == 0
            and n_rem * elem % 16 == 0)


def ring_stages(m: int, k: int, *, window: int, k_split: int, dtype) -> tuple[int, str | None]:
    """The ring stages a launch runs with, as the kernel computes them, and
    what cut the requested ``window`` (None if nothing did): "loads" (a
    CTA has fewer loads than the window), "DSMEM_MAX" (the split-K ring's
    shared-memory cap) or "MAX_WINDOW" (the whole-K cap of 8).
    ``k_split`` > 0 is the split-K design, 0 whole K."""
    window = max(1, int(window))
    if k_split > 0:
        stage = _stage_bytes(_decode_mb(m), elem_bytes(dtype))
        max_ld = -(-min(k_split, k) // DECODE_BK)
        stages = max(1, min(window, max_ld))
        if stages * stage > DSMEM_MAX:
            return DSMEM_MAX // stage, "DSMEM_MAX"
    else:
        stages = min(window, -(-k // WHOLE_K_BK))
        if stages > MAX_WINDOW:
            return MAX_WINDOW, "MAX_WINDOW"
    return stages, (None if stages == window else "loads")


def _stage_bytes(mb: int, elem: int) -> int:
    """One split-K ring stage: a DBK x DBN weight box and MB x DBK of x,
    rounded up to the 128 bytes a TMA destination is aligned to."""
    return -(-(DECODE_BK * DECODE_BN + mb * DECODE_BK) * elem // 128) * 128


def smem_footprint_bytes(m: int, k: int, n_loc: int, n_rem: int, *, window: int,
                         k_split: int, dtype) -> int:
    """Dynamic shared memory of one `splitk_gemm` launch, by the kernel's
    own arithmetic, clamps included (``csrc/splitk_gemm.cu``
    `decode_smem`, `whole_k_smem`): ``stages * (STAGE + 8)`` for the
    split-K design (``k_split`` > 0; a ring stage and its mbarrier), and
    ``stages * (BM*BK + BK*BN) * elem`` for whole K (``k_split`` 0).  The
    tiers' widths change the grid, not a CTA's footprint.  Counterpart of
    the reference's ``vmem_footprint_bytes``; the kernel lint DAK101 holds
    it against the per-CTA shared-memory limit."""
    del n_loc, n_rem
    stages, _ = ring_stages(m, k, window=window, k_split=k_split, dtype=dtype)
    elem = elem_bytes(dtype)
    if k_split > 0:
        return stages * (_stage_bytes(_decode_mb(m), elem) + 8)
    return stages * (_whole_k_bm(m) * WHOLE_K_BK + WHOLE_K_BK * WHOLE_K_BN) * elem


def smem_query(m: int, k: int, *, window: int, k_split: int, dtype) -> tuple[int, int]:
    """The kernel's own count for a launch: ``(dynamic shared memory
    bytes, ring stages)`` from ``dak_splitk_gemm_smem``.  Needs the card."""
    return _build.smem_query("splitk_gemm", "dak_splitk_gemm_smem", m, k, max(1, int(window)),
                             k_split, 0 if elem_bytes(dtype) == 4 else 1)


def host_first_order(n_loc_tiles: int, n_rem_tiles: int, splits: int = 1) -> np.ndarray:
    """The output tile and split each CTA of a launch computes, in block
    order, as ``tile * splits + split`` with tiles numbered in output
    column order (local tiles, then remote): the kernel's remote CTAs come
    first, and within a tier the tiles of one split are neighbours.  With
    one split this is the reference's ``host_first_order``."""
    out = []
    for tiles, first in ((n_rem_tiles, n_loc_tiles), (n_loc_tiles, 0)):
        for idx in range(tiles * splits):
            out.append((first + idx % tiles) * splits + idx // tiles)
    return np.asarray(out, dtype=np.int64)


def default_k_split(m: int, k: int, n_loc: int, n_rem: int, elem: int, sm_count: int) -> int:
    """The wrapper's own design choice for operands that a tensor map can
    describe: the split-K design at `decode_k_split` for M <= 16 and rows
    of 16-byte multiples, else whole K (0)."""
    if decode_shapes_ok(m, k, n_loc, n_rem, elem):
        return decode_k_split(n_loc, n_rem, k, sm_count)
    return 0


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_RETIRED_TICKETS: list[torch.Tensor] = []


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed int32 ticket counters for `n` tiles on (device, stream); the
    kernel sets each back to 0 after use, so they are reused.

    A captured CUDA graph keeps the address it was captured with, so
    counters outgrown by a larger launch stay allocated, and none is
    allocated during a capture (it would come from the graph's pool): the
    eager warm-up before a capture allocates them."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("splitk_gemm: ticket counters must be allocated before a CUDA "
                               "graph capture; warm the step up on the capturing stream first")
        if t is not None:
            _RETIRED_TICKETS.append(t)
        t = _TICKETS[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


def _decode_operands_ok(x: torch.Tensor, w_local: torch.Tensor, w_remote: torch.Tensor) -> bool:
    """Whether the split-K decode design takes the operands: M <= 16 and a
    tensor map can describe every operand (16-byte aligned bases and rows a
    multiple of 16 bytes)."""
    return (decode_shapes_ok(x.shape[0], x.shape[1], w_local.shape[1], w_remote.shape[1],
                             x.element_size())
            and all(t.data_ptr() % 16 == 0 for t in (x, w_local, w_remote) if t.numel()))


def _launch(x: torch.Tensor, w_local: torch.Tensor, w_remote: torch.Tensor, window: int,
            k_split: int) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands (M >= 1) with the
    design given: ``k_split`` 0 is the whole-K design, > 0 the split-K
    decode design with that many rows of K per CTA.  Allocates the output
    and, for more than one split, the workspace and tickets."""
    m, k = x.shape
    n_loc, n_rem = w_local.shape[1], w_remote.shape[1]
    y = torch.empty((m, n_loc + n_rem), dtype=x.dtype, device=x.device)
    stream = _build.stream_handle(x.device)
    ws, tickets = None, None
    if 0 < k_split < k:
        ws = torch.empty(-(-k // k_split) * m * (n_loc + n_rem), dtype=torch.float32,
                         device=x.device)
        tickets = _tickets(x.device, stream,
                           -(-n_loc // DECODE_BN) + -(-n_rem // DECODE_BN))
    rc = _build.load().libs["splitk_gemm"].dak_splitk_gemm(
        x.data_ptr(), w_local.data_ptr(), w_remote.data_ptr(), y.data_ptr(),
        m, k, n_loc, n_rem, max(1, int(window)), k_split,
        0 if ws is None else ws.data_ptr(), 0 if tickets is None else tickets.data_ptr(),
        _DTYPES[x.dtype], stream)
    _build.check(rc, "splitk_gemm")
    return y


def _check_cuda_operands(x: torch.Tensor, w_local: torch.Tensor,
                         w_remote: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"splitk_gemm takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [M, K] matrix, got {tuple(x.shape)}")
    k = x.shape[1]
    if k == 0:
        raise ValueError("splitk_gemm needs K >= 1")
    for name, w in (("w_local", w_local), ("w_remote", w_remote)):
        if w.dtype != x.dtype:
            raise TypeError(f"{name} is {w.dtype}, x is {x.dtype}")
        if w.dim() != 2 or w.shape[0] != k or not w.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [K={k}, N] matrix, "
                             f"got {tuple(w.shape)}")
    if w_local.numel() and w_local.device != x.device:
        raise ValueError(f"w_local must live on {x.device} (the local tier), "
                         f"got {w_local.device}")
    if w_remote.numel() and not _build.remote_placement_ok(w_remote, x.device):
        raise ValueError(f"w_remote must be pinned host memory or live on {x.device} "
                         f"(the remote tier), got a tensor on {w_remote.device}")
    if w_local.shape[1] + w_remote.shape[1] == 0:
        raise ValueError("splitk_gemm needs N_loc + N_rem >= 1")


@direct_access(lambda x, w_local, w_remote, **_: splitk_gemm_ref(x, w_local, w_remote))
def splitk_gemm(x: torch.Tensor, w_local: torch.Tensor, w_remote: torch.Tensor,
                *, window: int = DEFAULT_WINDOW, k_split: int | None = None) -> torch.Tensor:
    """Tiered GEMM: ``x [M, K] @ [w_local [K, N_loc] | w_remote [K, N_rem]]``
    -> ``[M, N_loc + N_rem]`` in x's dtype.  Either tier may be empty.

    On the card, ``x`` and ``w_local`` are device tensors and ``w_remote``
    is pinned host memory that the kernel reads in place.  ``window`` (>= 1)
    is the number of loads each CTA keeps in flight (the depth of its
    shared-memory ring, capped by shared memory); it never changes the
    result.  ``k_split`` picks the design: None the wrapper's own choice
    (split-K at `decode_k_split` where the decode design takes the
    operands, else whole K), 0 whole K, and a positive multiple of
    DECODE_BK the split-K design with that many rows of K per CTA, refused
    where that design cannot take the operands.  The plain CPU version
    ignores both knobs."""
    if k_split is not None and (k_split < 0 or k_split % DECODE_BK):
        raise ValueError(f"k_split must be 0 (whole K) or a positive multiple of {DECODE_BK}, "
                         f"got {k_split}")
    if x.device.type == "cpu":
        return splitk_gemm_ref(x, w_local, w_remote)
    if x.device.type != "cuda":
        raise ValueError(f"splitk_gemm runs on cpu or cuda tensors, got {x.device}")
    _check_cuda_operands(x, w_local, w_remote)
    m, k = x.shape
    n_loc, n_rem = w_local.shape[1], w_remote.shape[1]
    if m == 0:
        return torch.empty((0, n_loc + n_rem), dtype=x.dtype, device=x.device)
    decode_ok = _decode_operands_ok(x, w_local, w_remote)
    if k_split is None:
        k_split = decode_k_split(n_loc, n_rem, k, _sm_count(x.device.index)) if decode_ok else 0
    elif k_split > 0 and not decode_ok:
        raise ValueError(f"k_split={k_split} asks for the split-K decode design, which takes "
                         f"M <= {DECODE_MAX_M} and 16-byte rows and bases only; got M={m}, "
                         f"K={k}, N_loc={n_loc}, N_rem={n_rem} of {x.dtype}")
    y = _launch(x, w_local, w_remote, window, k_split)
    splitk_gemm.launches += 1
    return y


splitk_gemm.launches = 0   # kernel launches since the count was last reset


def _check_grouped_operands(x: torch.Tensor, w_remote: torch.Tensor,
                            counts: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"splitk_gemm_grouped takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [E, M, K] stack, got {tuple(x.shape)}")
    e, _, k = x.shape
    if w_remote.dtype != x.dtype:
        raise TypeError(f"w_remote is {w_remote.dtype}, x is {x.dtype}")
    if (w_remote.dim() != 3 or w_remote.shape[:2] != (e, k)
            or not w_remote.is_contiguous()):
        raise ValueError(f"w_remote must be a contiguous [E={e}, K={k}, N] stack, "
                         f"got {tuple(w_remote.shape)}")
    if not _build.remote_placement_ok(w_remote, x.device):
        raise ValueError(f"w_remote must be pinned host memory or live on {x.device} "
                         f"(the remote tier), got a tensor on {w_remote.device}")
    if (counts.shape != (e,) or counts.dtype != torch.int32 or counts.device != x.device
            or not counts.is_contiguous()):
        raise ValueError(f"counts must be a contiguous [E={e}] int32 tensor on {x.device}, "
                         f"got {tuple(counts.shape)} {counts.dtype} on {counts.device}")
    es = x.element_size()
    if (k * es % 16 or w_remote.shape[2] * es % 16
            or x.data_ptr() % 16 or w_remote.data_ptr() % 16):
        raise ValueError("splitk_gemm_grouped reads through tensor maps: K and N must be "
                         "multiples of 16 bytes and both stacks 16-byte aligned, got "
                         f"K={k}, N={w_remote.shape[2]} of {x.dtype}")


@direct_access(lambda x, w_remote, counts, **_: splitk_gemm_grouped_ref(x, w_remote, counts))
def splitk_gemm_grouped(x: torch.Tensor, w_remote: torch.Tensor, counts: torch.Tensor,
                        *, window: int = DEFAULT_WINDOW) -> torch.Tensor:
    """Grouped remote-expert GEMM: ``y[e] = x[e] @ w_remote[e]`` for every
    expert ``e`` whose ``counts[e]`` is > 0 and zeros for the others; x
    ``[E, M, K]``, w_remote ``[E, K, N]``, counts ``[E]`` -> ``[E, M, N]``
    in x's dtype.

    On the card ``x`` and ``counts`` (int32) are device tensors and
    ``w_remote`` is the pinned remote expert stack, read in place: one
    launch for all experts, an expert whose count is 0 reading none of its
    weights, and the counts never coming back to the host, so a CUDA graph
    can hold the call.  Any M; rows are cut into tiles of up to 64."""
    if x.device.type == "cpu":
        return splitk_gemm_grouped_ref(x, w_remote, counts)
    if x.device.type != "cuda":
        raise ValueError(f"splitk_gemm_grouped runs on cpu or cuda tensors, got {x.device}")
    _check_grouped_operands(x, w_remote, counts)
    e, m, k = x.shape
    n = w_remote.shape[2]
    y = torch.zeros((e, m, n), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    n_tiles = -(-n // DECODE_BN)
    # splits as for one operand as wide as every expert's tiles together
    k_split = decode_k_split(0, e * n_tiles * DECODE_BN, k, _sm_count(x.device.index))
    stream = _build.stream_handle(x.device)
    ws, tickets = None, None
    if k_split < k:
        ws = torch.empty(-(-k // k_split) * e * m * n, dtype=torch.float32, device=x.device)
        tickets = _tickets(x.device, stream, e * -(-m // GROUPED_MAX_M) * n_tiles)
    rc = _build.load().libs["splitk_gemm"].dak_splitk_gemm_grouped(
        x.data_ptr(), w_remote.data_ptr(), counts.data_ptr(), y.data_ptr(), e, m, k, n,
        max(1, int(window)), k_split, 0 if ws is None else ws.data_ptr(),
        0 if tickets is None else tickets.data_ptr(), _DTYPES[x.dtype], stream)
    _build.check(rc, "splitk_gemm_grouped")
    splitk_gemm_grouped.launches += 1
    return y


splitk_gemm_grouped.launches = 0   # kernel launches since the count was last reset
