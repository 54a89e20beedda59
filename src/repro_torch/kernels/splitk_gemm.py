"""SplitK_GEMM — direct-access tiered GEMM (paper §4.1, Fig. 5) on Hopper.

Computes ``y = x @ concat(w_local, w_remote, axis=1)`` where the weight is
column-partitioned between the local tier (HBM) and the remote tier
(pinned, device-mapped host memory).  The CUDA kernel
(``csrc/splitk_gemm.cu``) reads every output tile's weight K-chunks
straight from the tile's home tier into a ``window``-deep shared-memory
ring, remote tiles first, and accumulates in fp32; its head note says what
bounds it and what the design does about that.

Counterpart of ``src/repro/kernels/splitk_gemm.py`` (``_kernel``).  A CPU
tensor takes the plain version, :func:`splitk_gemm_ref`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import splitk_gemm_ref

DEFAULT_WINDOW = 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    is the depth of the kernel's shared-memory ring; it never changes the
    result."""
    if x.device.type == "cpu":
        return splitk_gemm_ref(x, w_local, w_remote)
    if x.device.type != "cuda":
        raise ValueError(f"splitk_gemm runs on cpu or cuda tensors, got {x.device}")
    _check_cuda_operands(x, w_local, w_remote)
    m, k = x.shape
    n_loc, n_rem = w_local.shape[1], w_remote.shape[1]
    y = torch.empty((m, n_loc + n_rem), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    rc = _build.load().libs["splitk_gemm"].dak_splitk_gemm(
        x.data_ptr(), w_local.data_ptr(), w_remote.data_ptr(), y.data_ptr(),
        m, k, n_loc, n_rem, max(1, int(window)), _DTYPES[x.dtype],
        _build.stream_handle(x.device))
    _build.check(rc, "splitk_gemm")
    splitk_gemm.launches += 1
    return y


splitk_gemm.launches = 0   # kernel launches since the count was last reset
