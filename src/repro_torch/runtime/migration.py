"""Bounded-budget live page migration for the paged tiered KV cache.

The allocation-time policy in `serving.paged_cache` only ever moves pages
under *pressure* (local pool full → coldest page spills).  Harvest-style
opportunistic re-placement (arXiv 2602.00328) does better: between engine
steps, promote the hottest remote pages into HBM and demote the coldest
local pages to the host, so residency tracks the live access pattern
rather than the admission order.

Temperature comes from the shared :class:`~repro.runtime.telemetry.\
PageTouchHistogram` (the cache's single source of truth for page heat —
written by the cache's own write/attend bookkeeping).  Movement is bounded
by ``pages_per_step``: each page copy costs pool bandwidth, so the budget
caps the per-step migration traffic; a zero budget makes the migrator a
strict no-op (the parity tests pin this).  Data moves through
`PagedTieredCache.move_pages`, which retags the shared page table in
place — no slot ever observes a stale mapping.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.paged_cache import LOCAL, REMOTE, PagedTieredCache


@dataclasses.dataclass
class MigrationReport:
    promoted: int = 0               # pages moved host → HBM
    demoted: int = 0                # pages moved HBM → host

    @property
    def moved(self) -> int:
        return self.promoted + self.demoted

    def as_args(self) -> dict:
        """Trace-event args for one migration pass (observability layer)."""
        return {"promoted": self.promoted, "demoted": self.demoted}


class Migrator:
    """Promote hot remote pages / demote cold local pages, within budget."""

    def __init__(self, pages_per_step: int = 1, headroom: int = 1):
        if pages_per_step < 0:
            raise ValueError("migration budget must be >= 0")
        self.pages_per_step = pages_per_step
        # Local free pages kept available for tail allocation: promotion
        # never consumes them (or the very next tail alloc would hit the
        # synchronous spill path — promote-then-spill ping-pong), and the
        # demote branch restores them when the free list runs dry.
        self.headroom = headroom
        self.total = MigrationReport()

    def step(self, cache: PagedTieredCache,
             budget_used: int = 0) -> MigrationReport:
        """One bounded migration pass.  ``budget_used`` is page movement
        the engine already spent this step outside the migrator — the
        scheduler's tier-demotion preemptions — which draws down the same
        per-step budget (both cost the same pool-copy bandwidth), so a
        preemption-heavy step migrates less instead of moving more total
        bytes than the budget promises."""
        rep = MigrationReport()
        budget = max(0, self.pages_per_step - max(0, budget_used))
        heat = cache.heat
        # Effective availability: `local_free` is the free list clipped by
        # the cache's elastic local limit, so under a shrunken budget the
        # migrator neither promotes into seized pages nor reads a deep
        # free list as headroom it does not actually have.  At the default
        # (full) limit this is exactly `len(cache.free[LOCAL])`.
        while budget > 0:
            remote_owned = cache.owned_pages(REMOTE)
            local_owned = cache.owned_pages(LOCAL)
            # Demote-for-headroom: keep the local free list deep enough
            # that tail allocation never hits the synchronous spill path.
            if (self.headroom > 0 and local_owned
                    and cache.local_free < self.headroom
                    and cache.free[REMOTE]):
                cold = heat.coldest(LOCAL, local_owned)
                cache.move_pages(LOCAL, REMOTE, [cold])
                rep.demoted += 1
                budget -= 1
                continue
            if not remote_owned:
                break
            hot = heat.hottest(REMOTE, remote_owned)
            if cache.local_free > self.headroom:
                # Promote into free local pages beyond the allocation
                # headroom (never into the last `headroom` free pages).
                cache.move_pages(REMOTE, LOCAL, [hot])
                rep.promoted += 1
                budget -= 1
                continue
            # Local pool full: swap only if the remote page is strictly
            # hotter than the coldest local page (and the swap fits the
            # remaining budget — a swap moves two pages).
            if budget < 2 or not local_owned or not cache.free[REMOTE]:
                break
            cold = heat.coldest(LOCAL, local_owned)
            if heat.temperature(REMOTE, hot) <= heat.temperature(LOCAL, cold):
                break
            cache.move_pages(LOCAL, REMOTE, [cold])
            cache.move_pages(REMOTE, LOCAL, [hot])
            rep.demoted += 1
            rep.promoted += 1
            budget -= 2
        self.total.promoted += rep.promoted
        self.total.demoted += rep.demoted
        return rep
