"""Tiered tensors — paper §4.1 data partition (Fig. 5a), in PyTorch.

A matrix operand is split along one axis into a *local* (HBM) part and a
*remote* (host) part.  Weights split along the output-column (N) dimension.

On a CUDA device the remote part lives in pinned, device-mapped host memory
(:func:`place`): the direct-access kernels (`kernels.splitk_gemm`) read it
over the host link through its mapped pointer and never stage it into HBM.
On the CPU both tiers are ordinary tensors and the placement is carried as
metadata, exactly as the reference does on backends without host memory
kinds.

Counterpart of ``src/repro/core/tiering.py``; `TieredTensor` plays the role
of ``TieredArray``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


def split_sizes(dim: int, ratio: float, align: int = 1) -> tuple[int, int]:
    """(local_rows, remote_rows): remote ≈ ratio·dim rounded to `align`.

    Paper §4.1 "execution wave alignment": tile rows are sized so each
    partition is a whole number of kernel tiles.
    """
    if not 0.0 <= ratio <= 1.0:
        raise ValueError(f"ratio must be in [0,1], got {ratio}")
    remote = int(round(dim * ratio / align)) * align
    remote = min(remote, (dim // align) * align if align > 1 else dim)
    return dim - remote, remote


@dataclasses.dataclass
class TieredTensor:
    """An operand partitioned across (local HBM, remote host) tiers.

    ``axis`` is the split axis; negative axes stay valid when a leading
    layer axis is sliced off (`serving.tiered_decode.layer_slice`)."""

    local: torch.Tensor            # rows [0, split) along `axis`
    remote: torch.Tensor           # rows [split, dim) along `axis`
    axis: int = 0

    @property
    def shape(self) -> tuple[int, ...]:
        s = list(self.local.shape)
        s[self.axis] += self.remote.shape[self.axis]
        return tuple(s)

    def __getitem__(self, i) -> "TieredTensor":
        """Index the leading (layer) axis of both tiers; the split axis must
        be negative so it keeps pointing at the same dimension."""
        if self.axis >= 0:
            raise ValueError("only operands split on a negative axis can be "
                             "indexed on their leading axis")
        return TieredTensor(self.local[i], self.remote[i], axis=self.axis)


def partition(x: torch.Tensor, ratio: float, axis: int = 0,
              align: int = 1) -> TieredTensor:
    """Split `x` along `axis`: the trailing `ratio` fraction goes to the
    host tier.  Both tiers are fresh contiguous copies, so the unsplit
    tensor can be freed once the caller drops it."""
    dim = x.shape[axis]
    n_local, n_remote = split_sizes(dim, ratio, align)
    local = x.narrow(axis, 0, n_local).contiguous()
    remote = x.narrow(axis, n_local, n_remote).contiguous()
    return TieredTensor(local=local, remote=remote, axis=axis)


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` with operand-type dispatch on tiered weights (the plain
    per-tier product).  A column-split `TieredTensor` computes each tier
    from its own buffer and concatenates the outputs.  Both tiers must be
    readable by ``torch.matmul`` on x's device, which holds on the CPU; on
    the card the remote tier is pinned host memory and the tiered product
    goes through the kernel instead (`kernels.ops.tiered_matmul`)."""
    if isinstance(w, TieredTensor):
        if w.axis not in (-1, w.local.ndim - 1):
            raise ValueError(
                f"tier-aware matmul supports column-split operands only "
                f"(axis=-1), got axis={w.axis} for shape {w.shape}")
        return torch.cat([x @ w.local, x @ w.remote], dim=-1)
    return x @ w


def place(t: TieredTensor) -> TieredTensor:
    """Put the remote tier in pinned, device-mapped host memory when the
    local tier lives on a CUDA device (one exact-size pinned allocation per
    tier, not the caching host allocator's power-of-two blocks).  A tier
    pair on the CPU is returned unchanged: the placement is logical there."""
    if t.local.device.type != "cuda":
        return t
    from repro_torch.kernels import _build

    remote = _build.pinned_empty(t.remote.shape, t.remote.dtype)
    remote.copy_(t.remote)
    return TieredTensor(local=t.local, remote=remote, axis=t.axis)


def traffic_bytes(t: TieredTensor) -> tuple[int, int]:
    """(local_bytes, remote_bytes) fetched by one full read of the operand."""
    return int(t.local.nbytes), int(t.remote.nbytes)


def validate(t: TieredTensor) -> None:
    """Invariants checked by property tests."""
    if t.local.dtype != t.remote.dtype:
        raise ValueError("tier dtype mismatch")
    ls, rs = list(t.local.shape), list(t.remote.shape)
    ls.pop(t.axis), rs.pop(t.axis)
    if ls != rs:
        raise ValueError(
            f"non-split dims must match: {tuple(t.local.shape)} vs "
            f"{tuple(t.remote.shape)}")
