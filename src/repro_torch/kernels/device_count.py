"""Counts kept on the device, which a captured CUDA graph can add to."""
from __future__ import annotations

import torch


class DeviceCount:
    """A count kept on the devices it is added from, one int64 each: a
    captured decode step adds to it on every replay, and nothing inside a
    step reads it back.  ``int()`` reads it (a sync) and `reset` zeroes it
    in place, so a captured add keeps its target."""

    def __init__(self) -> None:
        self._totals: dict[torch.device, torch.Tensor] = {}

    def total(self, device: torch.device) -> torch.Tensor:
        """The int64 this count keeps on `device` (a kernel may add to it in
        place), allocated at first use, which must come before any CUDA
        graph capture: a captured add keeps the address it was captured
        with."""
        total = self._totals.get(device)
        if total is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a DeviceCount must be allocated before a CUDA graph "
                                   "capture; warm the step up on the capturing stream first")
            total = self._totals[device] = torch.zeros((), dtype=torch.int64, device=device)
        return total

    def add(self, n: torch.Tensor) -> None:
        if n.device.type == "meta":       # an abstract trace (the lint) counts nothing
            return
        self.total(n.device).add_(n)

    def reset(self) -> None:
        for total in self._totals.values():
            total.zero_()

    def __int__(self) -> int:
        return sum(int(total) for total in self._totals.values())
