"""Page-table invariant checker for :class:`PagedTieredCache` (DAK301-305).

The paged cache is the one mutable data structure the whole serving path
trusts: the decode kernels index pools *through* ``table``/``tier`` with no
bounds or ownership checks, and the elastic ladder moves pages
between tiers mid-flight.  A single stale tier tag silently reads the wrong
pool — token parity tests only catch that if the corrupted page happens to
be attended.  These checks prove the bookkeeping wholesale:

- DAK301 — the free lists and the owner map partition each pool exactly.
- DAK302 — every in-use page-table entry agrees with the owner map
  (tier tag ⇔ pool residency).
- DAK303 — no page is owned by two slot positions; no stale owners.
- DAK304 — the elastic ``local_limit``/``local_deficit`` accounting stays
  inside the physical pool.
- DAK305 — the heat histogram tracks exactly the owned pages (spill/migrate
  victim selection reads it; a missing entry makes a page unevictable).

All checks are read-only over host-side numpy/dict state — no tensor ops, no
RNG, no clock — so the live :class:`ServingEngine` hook
(``check_invariants=True``) is bitwise-neutral by construction.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np

from repro_torch.analysis.findings import Finding

LOCAL, REMOTE = 0, 1
_TIER_NAME = {LOCAL: "local", REMOTE: "remote"}


class InvariantViolation(AssertionError):
    """Raised by the live engine hook when any page-table check fails."""

    def __init__(self, findings: list[Finding]):
        self.findings = findings
        super().__init__("; ".join(str(f) for f in findings))


def _pool_size(cache: Any, tier: int) -> int:
    return int(cache.n_local if tier == LOCAL else cache.n_remote)


def _in_use(cache: Any, slot: int) -> list[tuple[int, int, int]]:
    """(p, tier, idx) triples for slot's in-use page-table rows."""
    n = int(cache.n_pages[slot])
    return [(p, int(cache.tier[slot, p]), int(cache.table[slot, p]))
            for p in range(n)]


def check_free_lists(cache: Any, *, where: str = "cache") -> list[Finding]:
    """DAK301: per tier, the free list and the owner map are disjoint and
    together cover the pool exactly (no leaked, duplicated, or phantom
    pages).  The sink page belongs to neither."""
    out: list[Finding] = []
    for tier in (LOCAL, REMOTE):
        name = _TIER_NAME[tier]
        size = _pool_size(cache, tier)
        free = [int(i) for i in cache.free[tier]]
        if len(set(free)) != len(free):
            dups = sorted({i for i in free if free.count(i) > 1})
            out.append(Finding("DAK301", f"{where}.free[{name}]",
                               f"duplicate free indices {dups}"))
        bad = sorted(i for i in free if not 0 <= i < size)
        if bad:
            out.append(Finding("DAK301", f"{where}.free[{name}]",
                               f"free indices {bad} outside pool [0, {size})"))
        owned = {idx for (t, idx) in cache._owner if t == tier}
        overlap = sorted(set(free) & owned)
        if overlap:
            out.append(Finding("DAK301", f"{where}.free[{name}]",
                               f"indices {overlap} both free and owned"))
        covered = set(free) | owned
        missing = sorted(set(range(size)) - covered)
        if missing:
            out.append(Finding("DAK301", f"{where}.free[{name}]",
                               f"pool indices {missing} neither free nor owned (leaked)"))
    return out


def check_tier_tags(cache: Any, *, where: str = "cache") -> list[Finding]:
    """DAK302: every in-use (slot, p) row carries a valid tier tag and a
    pool index that the owner map confirms resides in that tier.  The tag is
    what the decode kernel dereferences — it must match actual residency."""
    out: list[Finding] = []
    for slot in range(int(cache.max_slots)):
        for p, tier, idx in _in_use(cache, slot):
            site = f"{where}.table[{slot},{p}]"
            if tier not in (LOCAL, REMOTE):
                out.append(Finding("DAK302", site, f"invalid tier tag {tier}"))
                continue
            size = _pool_size(cache, tier)
            if not 0 <= idx < size:
                out.append(Finding(
                    "DAK302", site,
                    f"pool index {idx} outside {_TIER_NAME[tier]} pool [0, {size}) "
                    "(sink pages are never table-referenced)"))
                continue
            owner = cache._owner.get((tier, idx))
            if owner != (slot, p):
                out.append(Finding(
                    "DAK302", site,
                    f"tier tag says {_TIER_NAME[tier]}[{idx}] but owner map has "
                    f"{owner} — tag disagrees with residency"))
    return out


def check_ownership(cache: Any, *, where: str = "cache") -> list[Finding]:
    """DAK303: the forward page table and the reverse owner map are a
    bijection over in-use pages — no page aliased by two slot positions, no
    stale owner entries, and per-slot page counts inside bounds."""
    out: list[Finding] = []
    seen: dict[tuple[int, int], tuple[int, int]] = {}
    referenced: set[tuple[int, int]] = set()
    for slot in range(int(cache.max_slots)):
        n = int(cache.n_pages[slot])
        if not 0 <= n <= int(cache.max_pages):
            out.append(Finding("DAK303", f"{where}.n_pages[{slot}]",
                               f"page count {n} outside [0, {int(cache.max_pages)}]"))
            continue
        for p, tier, idx in _in_use(cache, slot):
            key = (tier, idx)
            referenced.add(key)
            if key in seen:
                out.append(Finding(
                    "DAK303", f"{where}.table[{slot},{p}]",
                    f"{_TIER_NAME.get(tier, tier)}[{idx}] aliased: also owned by "
                    f"slot {seen[key][0]} page {seen[key][1]}"))
            else:
                seen[key] = (slot, p)
    stale = sorted(set(cache._owner) - referenced)
    if stale:
        out.append(Finding("DAK303", f"{where}._owner",
                           f"owner entries {stale} not referenced by any in-use "
                           "page-table row (stale)"))
    return out


def check_elastic_accounting(cache: Any, *, where: str = "cache") -> list[Finding]:
    """DAK304: the elastic HBM budget stays inside the physical pool and the
    derived deficit/free counters are self-consistent.  ``set_local_limit``
    clamps, so an out-of-range limit means someone bypassed the API."""
    out: list[Finding] = []
    limit = int(cache.local_limit)
    n_local = int(cache.n_local)
    if not 0 <= limit <= n_local:
        out.append(Finding("DAK304", f"{where}.local_limit",
                           f"elastic limit {limit} outside physical pool [0, {n_local}]"))
    in_use = int(cache.local_in_use)
    if not 0 <= in_use <= n_local:
        out.append(Finding("DAK304", f"{where}.local_in_use",
                           f"local pages in use {in_use} outside [0, {n_local}]"))
    deficit = int(cache.local_deficit)
    if deficit != max(0, in_use - limit):
        out.append(Finding("DAK304", f"{where}.local_deficit",
                           f"deficit {deficit} != max(0, {in_use} - {limit})"))
    free = int(cache.local_free)
    if free < 0 or free > max(0, limit - in_use):
        out.append(Finding("DAK304", f"{where}.local_free",
                           f"allocatable count {free} exceeds budget headroom "
                           f"max(0, {limit} - {in_use})"))
    return out


def check_heat_consistency(cache: Any, *, where: str = "cache") -> list[Finding]:
    """DAK305: the touch histogram's key set equals the owned-page set
    (alloc birth-touches, free forgets, migration retags), and every score
    is finite and positive.  Spill/demotion victim selection ranks these
    entries — a page missing here can never be chosen, one left behind
    points at a page some other slot now owns."""
    out: list[Finding] = []
    owned = set(cache._owner)
    heat_keys = set(cache.heat._heat)
    orphaned = sorted(heat_keys - owned)
    if orphaned:
        out.append(Finding("DAK305", f"{where}.heat",
                           f"heat entries {orphaned} for pages no slot owns"))
    untracked = sorted(owned - heat_keys)
    if untracked:
        out.append(Finding("DAK305", f"{where}.heat",
                           f"owned pages {untracked} missing from the heat "
                           "histogram (unevictable)"))
    bad = sorted(k for k, v in cache.heat._heat.items()
                 if not (math.isfinite(float(v)) and float(v) > 0.0))
    if bad:
        out.append(Finding("DAK305", f"{where}.heat",
                           f"non-finite or non-positive heat scores at {bad}"))
    return out


def check_page_table(cache: Any, *, where: str = "cache") -> list[Finding]:
    """Run all DAK30x invariants over one cache; read-only."""
    return (check_free_lists(cache, where=where)
            + check_tier_tags(cache, where=where)
            + check_ownership(cache, where=where)
            + check_elastic_accounting(cache, where=where)
            + check_heat_consistency(cache, where=where))


def run_scenario(*, page_size: int = 4, local_pages: int = 6, remote_pages: int = 10,
                 max_slots: int = 4, max_pages_per_slot: int = 8) -> list[Finding]:
    """Standalone pass: drive a small cache through the allocation, spill,
    elastic-shrink, migration, growth, and free paths, checking every
    invariant after each mutation.  Pure host-side work on tiny pools."""
    import torch

    from repro_torch.serving.paged_cache import PagedTieredCache

    cache = PagedTieredCache(
        n_layers=1, kv_heads=1, head_dim=4, page_size=page_size,
        local_pages=local_pages, remote_pages=remote_pages,
        max_slots=max_slots, max_pages_per_slot=max_pages_per_slot,
        dtype=torch.float32, device="cpu")
    findings: list[Finding] = []

    def probe(stage: str) -> None:
        findings.extend(check_page_table(cache, where=f"scenario:{stage}"))

    probe("init")
    lens = np.zeros(max_slots, np.int64)
    for slot in range(max_slots):
        lens[slot] = page_size * (slot + 1)
        cache.ensure_capacity(slot, int(lens[slot]))
    probe("fill")
    cache.touch_step(lens, np.ones(max_slots, bool))
    probe("touch")
    # Force the spill path: every local page is in use by now, so one more
    # allocation must evict the coldest local page to remote.
    cache.ensure_capacity(0, int(lens[0]) + page_size)
    probe("spill")
    # Elastic shrink to half the pool, then drain the deficit by demotion.
    deficit = cache.set_local_limit(local_pages // 2)
    cache.demote_coldest(deficit)
    probe("shrink+demote")
    cache.grow_remote(3)
    probe("grow_remote")
    # Promotion path: move one remote page back under the restored limit.
    cache.set_local_limit(local_pages)
    remote_owned = cache.owned_pages(REMOTE)
    if remote_owned and cache.free[LOCAL]:
        cache.move_pages(REMOTE, LOCAL, [remote_owned[0]])
    probe("promote")
    cache.free_slot(1)
    probe("free_slot")
    return findings
