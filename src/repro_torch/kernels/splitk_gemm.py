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

Both designs stop at the rate at which kernels can read pinned host memory
over PCIe: 30-33 GB/s at most on some H100 machines measured, 0.58-0.70x
the copy engine's 45-54 GB/s, and ~50 GB/s, 0.95x the copy engine, on
others (``chip_smoke.py --phases 1,9``).

Counterpart of ``src/repro/kernels/splitk_gemm.py`` (``_kernel``).  A CPU
tensor takes the plain version, :func:`splitk_gemm_ref`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import splitk_gemm_ref

DEFAULT_WINDOW = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_M = 16           # rows the decode design takes in one tile
DECODE_BN = 64              # its tile columns (csrc/splitk_gemm.cu DBN)
DECODE_BK = 32              # rows of one of its loads (DBK)
REMOTE_CTAS_PER_SM = 1      # remote CTAs a split aims for, per SM


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
    """Whether a tensor map can describe every operand: 16-byte aligned
    bases and rows a multiple of 16 bytes."""
    es = x.element_size()
    return (x.shape[1] * es % 16 == 0 and w_local.shape[1] * es % 16 == 0
            and w_remote.shape[1] * es % 16 == 0
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
    if w_remote.numel() and (w_remote.device.type != "cpu" or not w_remote.is_pinned()):
        raise ValueError("w_remote must be pinned host memory (the remote tier), "
                         f"got a tensor on {w_remote.device}")
    if w_local.shape[1] + w_remote.shape[1] == 0:
        raise ValueError("splitk_gemm needs N_loc + N_rem >= 1")


def splitk_gemm(x: torch.Tensor, w_local: torch.Tensor, w_remote: torch.Tensor,
                *, window: int = DEFAULT_WINDOW) -> torch.Tensor:
    """Tiered GEMM: ``x [M, K] @ [w_local [K, N_loc] | w_remote [K, N_rem]]``
    -> ``[M, N_loc + N_rem]`` in x's dtype.  Either tier may be empty.

    On the card, ``x`` and ``w_local`` are device tensors and ``w_remote``
    is pinned host memory that the kernel reads in place.  ``window`` (>= 1)
    is the number of loads each CTA keeps in flight (the depth of its
    shared-memory ring, capped by shared memory); it never changes the
    result."""
    if x.device.type == "cpu":
        return splitk_gemm_ref(x, w_local, w_remote)
    if x.device.type != "cuda":
        raise ValueError(f"splitk_gemm runs on cpu or cuda tensors, got {x.device}")
    _check_cuda_operands(x, w_local, w_remote)
    m, k = x.shape
    n_loc, n_rem = w_local.shape[1], w_remote.shape[1]
    if m == 0:
        return torch.empty((0, n_loc + n_rem), dtype=x.dtype, device=x.device)
    k_split = 0
    if m <= DECODE_MAX_M and _decode_operands_ok(x, w_local, w_remote):
        k_split = decode_k_split(n_loc, n_rem, k, _sm_count(x.device.index))
    y = _launch(x, w_local, w_remote, window, k_split)
    splitk_gemm.launches += 1
    return y


splitk_gemm.launches = 0   # kernel launches since the count was last reset
