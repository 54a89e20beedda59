"""SplitK_GEMM — direct-access tiered GEMM (paper §4.1, Fig. 5) on Hopper.

Computes ``y = x @ concat(w_local, w_remote, axis=1)`` where the weight is
column-partitioned between the local tier (HBM) and the remote tier
(pinned, device-mapped host memory).  The CUDA kernel
(``csrc/splitk_gemm.cu``) reads every output tile's weight straight from
the tile's home tier into a ``window``-deep shared-memory ring, remote
tiles first, and accumulates in fp32; its head note says what bounds it
and what the design does about that.  Three designs, split by M and dtype,
one launch each (:func:`gemm_tiling` says which takes a launch):

* split-K decode (M <= 16, operands a tensor map can describe; every
  decode step): both tiers split along K into :func:`decode_k_split` rows
  per CTA, each load one TMA box of 32 rows of a 64-column tile; partial
  sums go to a workspace this wrapper allocates and are added in split
  order by the last CTA of each tile (the ticket counters are kept per
  device and stream, zero between launches).  A remote tier of 132 tiles
  or more takes one split, which needs neither;
* cluster (bf16 at M > 16, operands a tensor map can describe; every
  prefill, chunk and encoder forward of the served dtype): clusters of up
  to 8 CTAs along M share each 64 x 64 weight box by TMA multicast, so
  the remote tier crosses the host link once per cluster of M tiles
  (once up to 512 rows, twice at 2048) instead of once per 128 rows, and
  the products run on tensor cores; K splits as the decode design aims
  them, at most :data:`CLUSTER_MAX_SPLITS`;
* whole K (fp32 at M > 16, and operands whose rows are not 16-byte
  multiples or aligned): one CTA per (M tile of up to 128 rows, 64
  columns) walks all of K, re-reading the weight once per M tile.

Every design adds the remote bytes it reads to :attr:`splitk_gemm.host_bytes`,
a count kept on the device.

A third entry, :func:`splitk_gemm_grouped`, runs a remote MoE expert
stack ``[E, K, N]`` in one launch over every expert, each CTA reading the
routed-slot count of its expert on the device and returning before any
load when it is 0; :func:`grouped_tiling` says which of its two designs
takes M rows (split-K at M <= 16 in bf16 and at every M in fp32, the
cluster design with TMA multicast and tensor cores at M > 16 in bf16) and
how often each active expert's weights cross the host link.

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

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.device_count import DeviceCount
from repro_torch.kernels.ref import splitk_gemm_grouped_ref, splitk_gemm_ref
from repro_torch.kernels.sink import direct_access

DEFAULT_WINDOW = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_M = 16           # rows the decode design takes in one tile
DECODE_BN = 64              # its tile columns (csrc/splitk_gemm.cu DBN)
DECODE_BK = 32              # rows of one of its loads (DBK)
REMOTE_CTAS_PER_SM = 1      # remote CTAs a split aims for, per SM
GROUPED_MAX_M = 64          # rows of an M tile of the grouped split-K design (GROUPED_MAX_MB)
CLUSTER_BN = CLUSTER_BK = 64    # the cluster designs' weight box (CBN x CBK, 8 KB)
CLUSTER_MAX = 8             # CTAs of a cluster at most (the portable cluster size)
CLUSTER_MAX_SPLITS = 4      # K splits of the dense cluster design at most: its fp32
                            # workspace within 4 x the output's elements (8 x its bf16 bytes)
CLUSTER_SMEM_MAX = 232448   # its ring's cap: the dynamic shared memory a CTA may opt into
CLUSTER_ALIGN = 1024        # its swizzled boxes' alignment (C_ALIGN): slack in shared memory
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


def decode_k_split(n_loc: int, n_rem: int, k: int, sm_count: int, bk: int = DECODE_BK) -> int:
    """Rows of K each CTA of the split-K decode design reads, in both tiers.

    The largest multiple of ``bk`` (a load's rows, DECODE_BK) that still
    gives at least ``REMOTE_CTAS_PER_SM * sm_count`` remote CTAs (tiles of
    DECODE_BN columns times splits), or one load per CTA where K is too
    short for that; a remote tier that already has that many tiles gets one
    split covering K.  The local tier's tiles decide when the remote tier
    is empty.  Splits start at multiples of ``bk`` and the last one ends at
    K."""
    tiles = max(1, -(-(n_rem or n_loc) // DECODE_BN))
    loads = -(-k // bk)
    want = -(-REMOTE_CTAS_PER_SM * sm_count // tiles)
    return max(1, loads // want) * bk


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
    """Rows of a whole-K M tile: 16, 64 or 128 (the dispatch on M).  Whole
    K takes fp32 at every M > 16 and operands no tensor map can describe;
    bf16 past 16 rows runs the cluster design (`_cluster_mb`)."""
    return 16 if m <= 16 else 64 if m <= 64 else 128


def _cluster_mb(m: int) -> int:
    """Rows of a cluster-design M tile: 64 while 8 tiles of 64 cover M, else
    128 (``cluster_mb`` in the kernel, the dense and grouped entries alike)."""
    return 64 if -(-m // 64) <= CLUSTER_MAX else 128


def _cluster_size(m_tiles: int) -> int:
    """CTAs of a cluster: the M tiles spread evenly over the fewest clusters
    of at most CLUSTER_MAX (``cluster_size``)."""
    clusters = -(-m_tiles // CLUSTER_MAX)
    return -(-m_tiles // clusters)


def _cluster_ring(mb: int, c: int, k: int, window: int,
                  k_split: int) -> tuple[int, int, str | None]:
    """``(wanted, stages, cut)`` of a cluster-design ring (``cluster_stages``):
    the split-K design's ``window`` 4 KB boxes in flight per CTA, C times
    over, in 8 KB weight boxes, two stages at least; cut to the loads a
    CTA's split has ("loads") and to the shared memory a CTA may opt into
    ("CLUSTER_SMEM_MAX")."""
    stage = _cluster_stage_bytes(mb)
    loads = -(-min(k_split, k) // CLUSTER_BK)
    wanted = max(2, -(-c * window * DECODE_BK * DECODE_BN // (CLUSTER_BK * CLUSTER_BN)))
    stages, cut = wanted, None
    if stages > loads:
        stages, cut = loads, "loads"
    cap = (CLUSTER_SMEM_MAX - CLUSTER_ALIGN) // (stage + 16)
    if stages > cap:
        stages, cut = cap, "CLUSTER_SMEM_MAX"
    return wanted, stages, cut


def _cluster_stage_bytes(mb: int) -> int:
    """One cluster-design ring stage in bf16: a CBK x CBN weight box and MB
    rows of CBK columns of x."""
    return (CLUSTER_BK * CLUSTER_BN + mb * CLUSTER_BK) * 2


def _cluster_smem(mb: int, stages: int) -> int:
    """Dynamic shared memory of a cluster-design launch: the 1024-byte
    alignment slack, the ring, and a full and an empty mbarrier a stage."""
    return CLUSTER_ALIGN + stages * (_cluster_stage_bytes(mb) + 16)


def decode_shapes_ok(m: int, k: int, n_loc: int, n_rem: int, elem: int) -> bool:
    """Whether the split-K decode design takes these extents: M <= 16 and
    rows of 16-byte multiples (bases must also be 16-byte aligned, which
    only tensors can tell: `_operands_aligned`)."""
    return m <= DECODE_MAX_M and _rows_ok(k, n_loc, n_rem, elem)


def cluster_shapes_ok(m: int, k: int, n_loc: int, n_rem: int, elem: int) -> bool:
    """Whether the cluster design takes these extents: bf16, M > 16 and
    rows of 16-byte multiples (and 16-byte aligned bases)."""
    return elem == 2 and m > DECODE_MAX_M and _rows_ok(k, n_loc, n_rem, elem)


def _rows_ok(k: int, n_loc: int, n_rem: int, elem: int) -> bool:
    return k * elem % 16 == 0 and n_loc * elem % 16 == 0 and n_rem * elem % 16 == 0


def ring_stages(m: int, k: int, *, window: int, k_split: int, dtype) -> tuple[int, str | None]:
    """The ring stages a launch runs with, as the kernel computes them, and
    what cut the ring it asks for (None if nothing did): "loads" (a CTA
    has fewer loads than that), "DSMEM_MAX" (the split-K ring's
    shared-memory cap), "CLUSTER_SMEM_MAX" (the cluster ring's) or
    "MAX_WINDOW" (the whole-K cap of 8).  ``k_split`` > 0 is the split-K
    design at M <= 16 and the cluster design past that (whose ring asks
    for C x ``window`` 4 KB boxes, `_cluster_ring`), 0 whole K."""
    window = max(1, int(window))
    if k_split > 0 and m > DECODE_MAX_M:
        mb = _cluster_mb(m)
        _, stages, cut = _cluster_ring(mb, _cluster_size(-(-m // mb)), k, window, k_split)
        return stages, cut
    if k_split > 0:
        return _split_k_ring(_decode_mb(m), k, window, k_split, elem_bytes(dtype))
    stages = min(window, -(-k // WHOLE_K_BK))
    if stages > MAX_WINDOW:
        return MAX_WINDOW, "MAX_WINDOW"
    return stages, (None if stages == window else "loads")


def _split_k_ring(mb: int, k: int, window: int, k_split: int, elem: int) -> tuple[int, str | None]:
    """Ring stages of a split-K launch (plain or grouped) of M tiles of `mb`
    rows, and what cut `window` (`decode_stages` in the kernel)."""
    stage = _stage_bytes(mb, elem)
    stages = max(1, min(window, -(-min(k_split, k) // DECODE_BK)))
    if stages * stage > DSMEM_MAX:
        return DSMEM_MAX // stage, "DSMEM_MAX"
    return stages, (None if stages == window else "loads")


def _stage_bytes(mb: int, elem: int) -> int:
    """One split-K ring stage: a DBK x DBN weight box and MB x DBK of x,
    rounded up to the 128 bytes a TMA destination is aligned to."""
    return -(-(DECODE_BK * DECODE_BN + mb * DECODE_BK) * elem // 128) * 128


def smem_footprint_bytes(m: int, k: int, n_loc: int, n_rem: int, *, window: int,
                         k_split: int, dtype) -> int:
    """Dynamic shared memory of one `splitk_gemm` launch, by the kernel's
    own arithmetic, clamps included (``csrc/splitk_gemm.cu``
    `decode_smem`, `cluster_smem`, `whole_k_smem`): ``stages * (STAGE +
    8)`` for the split-K design (``k_split`` > 0 at M <= 16; a ring stage
    and its mbarrier), ``1024 + stages * (STAGE + 16)`` for the cluster
    design (``k_split`` > 0 past 16 rows; alignment slack, a stage and its
    full and empty mbarriers) and ``stages * (BM*BK + BK*BN) * elem`` for
    whole K (``k_split`` 0).  The tiers' widths change the grid, not a
    CTA's footprint.  Counterpart of the reference's
    ``vmem_footprint_bytes``; the kernel lint DAK101 holds it against the
    per-CTA shared-memory limit."""
    del n_loc, n_rem
    stages, _ = ring_stages(m, k, window=window, k_split=k_split, dtype=dtype)
    elem = elem_bytes(dtype)
    if k_split > 0 and m > DECODE_MAX_M:
        return _cluster_smem(_cluster_mb(m), stages)
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
    """The wrapper's own design choice for operands on 16-byte aligned
    bases: the split-K design at `decode_k_split` for M <= 16, the cluster
    design at `cluster_k_split` for bf16 past that (rows of 16-byte
    multiples both), else whole K (0)."""
    if decode_shapes_ok(m, k, n_loc, n_rem, elem):
        return decode_k_split(n_loc, n_rem, k, sm_count)
    if cluster_shapes_ok(m, k, n_loc, n_rem, elem):
        return cluster_k_split(m, k, n_loc, n_rem, sm_count)
    return 0


def cluster_k_split(m: int, k: int, n_loc: int, n_rem: int, sm_count: int) -> int:
    """Rows of K each CTA of the cluster design reads, in both tiers: K
    split evenly, in multiples of CLUSTER_BK, into the fewest splits that
    give ``REMOTE_CTAS_PER_SM * sm_count`` remote CTAs (tiles of
    CLUSTER_BN columns x M tiles padded to whole clusters x splits), at
    most CLUSTER_MAX_SPLITS and no more than K has loads.  The local tier's
    tiles decide when the remote tier is empty."""
    mb = _cluster_mb(m)
    m_tiles = -(-m // mb)
    c = _cluster_size(m_tiles)
    ctas = max(1, -(-(n_rem or n_loc) // CLUSTER_BN)) * -(-m_tiles // c) * c
    loads = -(-k // CLUSTER_BK)
    splits = min(CLUSTER_MAX_SPLITS, loads, -(-REMOTE_CTAS_PER_SM * sm_count // ctas))
    return -(-loads // splits) * CLUSTER_BK


@dataclasses.dataclass(frozen=True)
class GemmTiling:
    """How one `splitk_gemm` launch cuts its work (``csrc/splitk_gemm.cu``
    `dak_splitk_gemm`).  ``design`` is "split-K" (M <= 16; one M tile of
    ``mb`` rows up to 16), "cluster" (bf16 past 16 rows; clusters of
    ``cluster`` CTAs along M, one tile of ``mb`` = 64 or 128 rows each,
    sharing every weight box by TMA multicast) or "whole-K" (M tiles of
    ``mb`` = 16, 64 or 128 rows, each reading its weights).  ``grid_z`` is
    the M tiles padded to whole clusters; ``k_split`` the rows of K a CTA
    reads (0: whole K) in ``splits`` splits; ``grid`` the launch's CTAs
    (x, y, z): (tiles x splits, 1, 1) for split-K, (tiles, M tiles, 1) for
    whole K and (tiles x splits x cluster rows, 1, C) for the cluster
    design, whose clusters lie along z.  ``workspace`` and ``tickets`` are
    the fp32 partial sums and ticket counters the wrapper allocates (0
    with one split)."""
    design: str
    mb: int
    cluster: int
    m_tiles: int
    grid_z: int
    k_split: int
    splits: int
    grid: tuple[int, int, int]
    workspace: int
    tickets: int

    @property
    def reads(self) -> int:
        """Times the remote tier crosses the host link: once per cluster of
        M tiles (once per M tile for whole K, once for split-K)."""
        return self.grid_z // self.cluster


def gemm_tiling(m: int, k: int, n_loc: int, n_rem: int, dtype, *, sm_count: int = 132,
                aligned: bool = True, k_split: int | None = None) -> GemmTiling:
    """The tiling of a `splitk_gemm` launch of x [M, K] against tiers of
    ``n_loc`` and ``n_rem`` columns in `dtype` on a card of `sm_count` SMs,
    as the wrapper picks it (``aligned``: the operands' bases are 16-byte
    aligned) or, given ``k_split``, as that knob picks it: 0 whole K, > 0
    split-K at M <= 16 and the cluster design past that.  The counterpart
    of `grouped_tiling`; `reads` is what ``splitk_gemm.host_bytes`` counts
    a launch, in units of the remote tier."""
    elem = elem_bytes(dtype)
    if k_split is None:
        k_split = default_k_split(m, k, n_loc, n_rem, elem, sm_count) if aligned else 0
    bn = DECODE_BN
    tiles = -(-n_loc // bn) + -(-n_rem // bn)
    if k_split == 0:
        mb = _whole_k_bm(m)
        m_tiles = -(-m // mb)
        return GemmTiling("whole-K", mb, 1, m_tiles, m_tiles, 0, 1, (tiles, m_tiles, 1), 0, 0)
    splits = -(-k // k_split)
    workspace = splits * m * (n_loc + n_rem) if splits > 1 else 0
    if m <= DECODE_MAX_M:
        return GemmTiling("split-K", _decode_mb(m), 1, 1, 1, k_split, splits,
                          (tiles * splits, 1, 1), workspace, tiles if workspace else 0)
    mb = _cluster_mb(m)
    m_tiles = -(-m // mb)
    c = _cluster_size(m_tiles)
    grid_z = -(-m_tiles // c) * c
    return GemmTiling("cluster", mb, c, m_tiles, grid_z, k_split, splits,
                      (tiles * splits * (grid_z // c), 1, c), workspace,
                      tiles * grid_z if workspace else 0)


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


def _operands_aligned(x: torch.Tensor, w_local: torch.Tensor, w_remote: torch.Tensor) -> bool:
    """Whether every non-empty operand's base is 16-byte aligned, as a
    tensor map needs (the rows' widths are `gemm_tiling`'s to check)."""
    return all(t.data_ptr() % 16 == 0 for t in (x, w_local, w_remote) if t.numel())


def _launch(x: torch.Tensor, w_local: torch.Tensor, w_remote: torch.Tensor, window: int,
            k_split: int) -> torch.Tensor:
    """One launch of the kernel on checked CUDA operands (M >= 1) with the
    design given: ``k_split`` 0 is the whole-K design, > 0 the split-K
    decode design (M <= 16) or the cluster design (past 16 rows, bf16) with
    that many rows of K per CTA.  Allocates the output and, for more than
    one split, the workspace and tickets; adds the remote bytes read to
    ``splitk_gemm.host_bytes``.  ``k_split`` 0 at bf16 past 16 rows is the
    whole-K design that the cluster design replaced, kept reachable here to
    measure the two against each other; the wrapper's own choice never
    takes it where the cluster design takes the operands."""
    m, k = x.shape
    n_loc, n_rem = w_local.shape[1], w_remote.shape[1]
    t = gemm_tiling(m, k, n_loc, n_rem, x.dtype, k_split=k_split)
    y = torch.empty((m, n_loc + n_rem), dtype=x.dtype, device=x.device)
    stream = _build.stream_handle(x.device)
    ws, tickets = None, None
    if t.workspace:
        ws = torch.empty(t.workspace, dtype=torch.float32, device=x.device)
        tickets = _tickets(x.device, stream, t.tickets)
    host_bytes = splitk_gemm.host_bytes.total(x.device)
    rc = _build.load().libs["splitk_gemm"].dak_splitk_gemm(
        x.data_ptr(), w_local.data_ptr(), w_remote.data_ptr(), y.data_ptr(),
        m, k, n_loc, n_rem, max(1, int(window)), k_split,
        0 if ws is None else ws.data_ptr(), 0 if tickets is None else tickets.data_ptr(),
        host_bytes.data_ptr(), _DTYPES[x.dtype], stream)
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
    (`gemm_tiling`: split-K at `decode_k_split` for M <= 16, the cluster
    design at `cluster_k_split` for bf16 past that, where a tensor map
    takes the operands, else whole K), 0 whole K, and a positive multiple
    of DECODE_BK the split-K design (M <= 16) or, a multiple of
    CLUSTER_BK, the cluster design (bf16 past 16 rows) with that many rows
    of K per CTA, refused where that design cannot take the operands.  The
    engine and the autotuner never pass 0 where the cluster design takes
    the operands.  ``host_bytes`` (a `DeviceCount`) counts the remote
    bytes the launches read over the host link, on the device.  The plain
    CPU version ignores both knobs."""
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
    aligned = _operands_aligned(x, w_local, w_remote)
    if k_split is None:
        k_split = gemm_tiling(m, k, n_loc, n_rem, x.dtype, sm_count=_sm_count(x.device.index),
                              aligned=aligned).k_split
    elif k_split > 0:
        elem = x.element_size()
        takes = decode_shapes_ok if m <= DECODE_MAX_M else cluster_shapes_ok
        if not (aligned and takes(m, k, n_loc, n_rem, elem)) or (
                m > DECODE_MAX_M and k_split % CLUSTER_BK):
            raise ValueError(
                f"k_split={k_split} asks for the split-K decode design (M <= {DECODE_MAX_M}) or "
                f"the cluster design (bfloat16 past {DECODE_MAX_M} rows, k_split a multiple of "
                f"{CLUSTER_BK}), which take 16-byte rows and bases only; got M={m}, K={k}, "
                f"N_loc={n_loc}, N_rem={n_rem} of {x.dtype}")
    y = _launch(x, w_local, w_remote, window, k_split)
    splitk_gemm.launches += 1
    return y


splitk_gemm.launches = 0   # kernel launches since the count was last reset
# remote bytes the launches read over the host link, counted on the device
splitk_gemm.host_bytes = DeviceCount()


@dataclasses.dataclass(frozen=True)
class GroupedTiling:
    """How a `splitk_gemm_grouped` launch cuts M rows (``csrc/splitk_gemm.cu``
    `grouped_mb`, `cluster_mb`, `cluster_size`).  ``design`` is "split-K"
    (FMA, M tiles of ``mb`` rows up to 64, each reading its expert's
    weights) or "cluster" (tensor cores; clusters of ``cluster`` CTAs
    along M, one tile of ``mb`` rows each, sharing every weight box by TMA
    multicast).  ``grid_z`` is the grid's M axis: the tiles padded to whole
    clusters."""
    design: str
    mb: int
    cluster: int
    m_tiles: int
    grid_z: int

    @property
    def reads(self) -> int:
        """Times each active expert's weights cross the host link: once per
        cluster of M tiles."""
        return self.grid_z // self.cluster


def grouped_tiling(m: int, dtype, *, design: str | None = None) -> GroupedTiling:
    """The M tiling of a grouped launch of M rows in `dtype`: the wrapper's
    design (split-K where M <= 16 or the dtype is fp32, else the cluster
    design) unless ``design`` names one.  Split-K takes M tiles of the
    power of two >= M up to 64 rows; the cluster design tiles of 64 rows
    while 8 of them cover M, else 128, spread evenly over the fewest
    clusters of at most 8, so bf16 at M <= 8 x MB (512 rows, 1024 past
    that) reads each expert once."""
    if design is None:
        design = "cluster" if elem_bytes(dtype) == 2 and m > DECODE_MAX_M else "split-K"
    if design == "split-K":
        mb = next(b for b in (1, 2, 4, 8, 16, 32, GROUPED_MAX_M) if m <= b or b == GROUPED_MAX_M)
        tiles = -(-m // mb)
        return GroupedTiling(design, mb, 1, tiles, tiles)
    if design != "cluster" or elem_bytes(dtype) != 2:
        raise ValueError(f"grouped designs are 'split-K' and 'cluster' (bfloat16 only), got "
                         f"{design!r} for {dtype}")
    mb = _cluster_mb(m)
    tiles = -(-m // mb)
    c = _cluster_size(tiles)
    return GroupedTiling(design, mb, c, tiles, -(-tiles // c) * c)


@dataclasses.dataclass(frozen=True)
class GroupedLaunch:
    """The whole geometry of one `splitk_gemm_grouped` launch, by the
    kernel's arithmetic: its M tiling, K split, grid (N tiles x splits,
    experts, M tiles), threads a CTA, weight box (columns x K rows), the
    ring stages ``window`` asks for, those it runs and what cut them (as
    `ring_stages` says), dynamic shared memory, and the tickets and
    workspace floats the wrapper allocates."""
    tiling: GroupedTiling
    k_split: int
    splits: int
    n_tiles: int
    grid: tuple[int, int, int]
    threads: int
    box: tuple[int, int]
    wanted: int
    stages: int
    cut: str | None
    smem_bytes: int
    tickets: int
    workspace: int


def grouped_launch(e: int, m: int, k: int, n: int, dtype, *, window: int, sm_count: int,
                   design: str | None = None) -> GroupedLaunch:
    """What `splitk_gemm_grouped` launches for x [E, M, K] and w [E, K, N]
    of `dtype` at `window` on a card of `sm_count` SMs (``design`` as in
    `grouped_tiling`)."""
    window = max(1, int(window))
    t = grouped_tiling(m, dtype, design=design)
    elem = elem_bytes(dtype)
    # K splits as for one operand as wide as every expert's tiles together
    k_split = decode_k_split(0, e * -(-n // DECODE_BN) * DECODE_BN, k, sm_count,
                             DECODE_BK if t.design == "split-K" else CLUSTER_BK)
    if t.design == "split-K":
        bn, bk, threads = DECODE_BN, DECODE_BK, DECODE_BN
        wanted = window
        stages, cut = _split_k_ring(t.mb, k, window, k_split, elem)
        smem = stages * (_stage_bytes(t.mb, elem) + 8)
    else:
        bn, bk, threads = CLUSTER_BN, CLUSTER_BK, 32 * (t.mb // 16 + 1)
        wanted, stages, cut = _cluster_ring(t.mb, t.cluster, k, window, k_split)
        smem = _cluster_smem(t.mb, stages)
    splits = -(-k // k_split)
    n_tiles = -(-n // bn)
    return GroupedLaunch(
        tiling=t, k_split=k_split, splits=splits, n_tiles=n_tiles,
        grid=(n_tiles * splits, e, t.grid_z), threads=threads, box=(bn, bk), wanted=wanted,
        stages=stages, cut=cut, smem_bytes=smem,
        tickets=e * t.grid_z * n_tiles if k_split < k else 0,
        workspace=splits * e * m * n if k_split < k else 0)


def grouped_smem_query(m: int, k: int, *, window: int, k_split: int, design: str,
                       dtype) -> tuple[int, int]:
    """The kernel's own count for a grouped launch: ``(dynamic shared
    memory bytes, ring stages)`` from ``dak_splitk_gemm_grouped_smem``.
    Needs the card."""
    return _build.smem_query("splitk_gemm", "dak_splitk_gemm_grouped_smem", m, k,
                             max(1, int(window)), k_split, _GROUPED_DESIGNS[design],
                             0 if elem_bytes(dtype) == 4 else 1)


_GROUPED_DESIGNS = {"split-K": 0, "cluster": 1}


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


def _launch_grouped(x: torch.Tensor, w_remote: torch.Tensor, counts: torch.Tensor,
                    window: int, design: str | None = None) -> torch.Tensor:
    """One grouped launch on checked CUDA operands (a non-empty output) in
    the design `grouped_tiling` picks, or in ``design`` where given: the
    wrapper passes None; "split-K" at M > 16 is the design the cluster
    design replaced, kept reachable here to measure the two against each
    other.  Allocates the output and, for more than one split, the
    workspace and tickets; adds the weight bytes read to
    ``splitk_gemm_grouped.host_bytes``."""
    e, m, k = x.shape
    n = w_remote.shape[2]
    launch = grouped_launch(e, m, k, n, x.dtype, window=window,
                            sm_count=_sm_count(x.device.index), design=design)
    y = torch.zeros((e, m, n), dtype=x.dtype, device=x.device)
    stream = _build.stream_handle(x.device)
    ws, tickets = None, None
    if launch.workspace:
        ws = torch.empty(launch.workspace, dtype=torch.float32, device=x.device)
        tickets = _tickets(x.device, stream, launch.tickets)
    host_bytes = splitk_gemm_grouped.host_bytes.total(x.device)
    rc = _build.load().libs["splitk_gemm"].dak_splitk_gemm_grouped(
        x.data_ptr(), w_remote.data_ptr(), counts.data_ptr(), y.data_ptr(), e, m, k, n,
        max(1, int(window)), launch.k_split, 0 if ws is None else ws.data_ptr(),
        0 if tickets is None else tickets.data_ptr(), host_bytes.data_ptr(),
        _GROUPED_DESIGNS[launch.tiling.design], _DTYPES[x.dtype], stream)
    _build.check(rc, "splitk_gemm_grouped")
    return y


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
    can hold the call.  Any M: up to 16 rows (decode) and in fp32 the
    split-K design cuts M into tiles of up to 64 rows, each reading its
    expert's weights; past 16 rows in bf16 (prefill) the cluster design
    reads each weight box once per cluster of up to 8 M tiles of 64 or 128
    rows (`grouped_tiling`).  ``host_bytes`` (a `DeviceCount`) counts the
    weight bytes the launches read over the host link, on the device."""
    if x.device.type == "cpu":
        return splitk_gemm_grouped_ref(x, w_remote, counts)
    if x.device.type != "cuda":
        raise ValueError(f"splitk_gemm_grouped runs on cpu or cuda tensors, got {x.device}")
    _check_grouped_operands(x, w_remote, counts)
    if x.shape[0] * x.shape[1] * w_remote.shape[2] == 0:
        return torch.zeros((*x.shape[:2], w_remote.shape[2]), dtype=x.dtype, device=x.device)
    y = _launch_grouped(x, w_remote, counts, window)
    splitk_gemm_grouped.launches += 1
    return y


splitk_gemm_grouped.launches = 0   # kernel launches since the count was last reset
# weight bytes the grouped launches read over the host link, counted on the device
splitk_gemm_grouped.host_bytes = DeviceCount()
