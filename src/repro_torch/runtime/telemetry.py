"""Page temperature and weight-traffic accounting for the serving engine.

The port's subset of ``src/repro/runtime/telemetry.py``:

* :class:`PageTouchHistogram` — decayed touch counts per (tier, pool page)
  of the paged KV cache, the single source of truth for page temperature
  (`serving.paged_cache.PagedTieredCache` records a touch on every page it
  writes or attends and asks the histogram for its spill victim).  Copied
  from the reference.
* :func:`weight_tier_bytes` — the bytes one full read of a params tree
  takes from each tier, walking torch trees.

Below the serving layer; no device work.
"""
from __future__ import annotations

from typing import Iterable

from repro_torch.core.tiering import TieredTensor, traffic_bytes

class PageTouchHistogram:
    """Decayed touch counts per (tier, pool index) KV page.

    ``touch`` adds ``weight`` heat to a page and stamps it with a global
    monotone counter; ``advance`` (once per engine step) decays every
    page's heat by ``decay``.  Temperature ordering is ``(heat, stamp)``:
    colder = less accumulated recent heat, ties broken by least-recent
    touch — which reproduces the old allocation-stamp behaviour (oldest
    page spills first) when all pages are touched equally.
    """

    def __init__(self, decay: float = 0.85):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = decay
        self._heat: dict[tuple[int, int], float] = {}
        self._stamp: dict[tuple[int, int], int] = {}
        self._clock = 0

    def touch(self, tier: int, index: int, weight: float = 1.0) -> None:
        key = (tier, int(index))
        self._clock += 1
        self._heat[key] = self._heat.get(key, 0.0) + weight
        self._stamp[key] = self._clock

    def advance(self) -> None:
        """One step of exponential decay (call once per engine step)."""
        if self.decay >= 1.0:
            return
        for key in self._heat:
            self._heat[key] *= self.decay

    def heat(self, tier: int, index: int) -> float:
        return self._heat.get((tier, int(index)), 0.0)

    def forget(self, tier: int, index: int) -> None:
        """Drop a page's history (freed back to the pool)."""
        key = (tier, int(index))
        self._heat.pop(key, None)
        self._stamp.pop(key, None)

    def retag(self, tier_from: int, index_from: int,
              tier_to: int, index_to: int) -> None:
        """Move a page's heat with it across a tier migration."""
        src = (tier_from, int(index_from))
        dst = (tier_to, int(index_to))
        self._heat[dst] = self._heat.pop(src, 0.0)
        self._stamp[dst] = self._stamp.pop(src, self._clock)

    # -- temperature ordering ---------------------------------------------
    def temperature(self, tier: int, index: int) -> tuple[float, int]:
        """Sort key: (decayed heat, last-touch stamp) — colder sorts first."""
        k = (tier, int(index))
        return (self._heat.get(k, 0.0), self._stamp.get(k, 0))

    def coldest(self, tier: int, candidates: Iterable[int]) -> int:
        cands = list(candidates)
        if not cands:
            raise ValueError("no candidate pages")
        return min(cands, key=lambda i: (*self.temperature(tier, i), i))

    def hottest(self, tier: int, candidates: Iterable[int]) -> int:
        cands = list(candidates)
        if not cands:
            raise ValueError("no candidate pages")
        return max(cands, key=lambda i: (*self.temperature(tier, i), -i))

    def ranked(self, tier: int, candidates: Iterable[int],
               hottest_first: bool = True) -> list[int]:
        return sorted(candidates,
                      key=lambda i: (*self.temperature(tier, i), i),
                      reverse=hottest_first)



def weight_tier_bytes(params) -> tuple[float, float]:
    """(local_bytes, remote_bytes) for one full read of a params tree.

    `TieredTensor` leaves contribute to both tiers; plain tensor leaves are
    HBM-resident.  Used by the engine to account per-step weight traffic
    (decode reads every weight once per step).
    """
    local = remote = 0.0

    def visit(node) -> None:
        nonlocal local, remote
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, TieredTensor):
            loc, rem = traffic_bytes(node)
            local += loc
            remote += rem
        elif hasattr(node, "nbytes"):
            local += node.nbytes

    visit(params)
    return local, remote
