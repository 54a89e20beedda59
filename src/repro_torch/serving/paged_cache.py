"""Paged, tier-aware KV cache (serving-side DAK, paper §5), single chip.

Counterpart of ``src/repro/serving/paged_cache.py``.  Each slot's cache is
a list of fixed-size pages (shared across layers, vLLM-style), each living
in the local (HBM) or the remote (host) pool; new pages claim the local
tier and the coldest local page spills to the remote pool when the local
budget is full.  Page tables, free lists and heat are host-side numpy and
Python, copied from the reference.

Storage: per K/V a pool ``[L, P+1, page, Kh, hd]`` per tier whose last page
is a write *sink* (never allocated, never read).  On a CUDA device the
local pools live on the card and the remote pools in pinned, device-mapped
host memory, which the decode kernels read and write in place; on the CPU
both are ordinary tensors.  Pools are updated in place (the reference's
functional ``.at[].set`` copies each pool); host-side reads and writes of a
pool first wait for the work already queued on the device.

Tier-demotion preemption (`demote_slot_pages`) moves a slot's coldest
local pages into the remote pool through `move_pages`: on the card their
bytes land in pinned host memory, where the paged kernel reads them in
place.  The elastic budget is the reference's: ``local_limit`` caps the
local pages the allocator places (`set_local_limit` shrinks it mid-run,
`demote_coldest` drains the deficit), and `grow_remote` enlarges the host
pool, on the card by a new pinned allocation that the old pages are copied
into.  Not ported yet: the sharded mesh mode.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime.telemetry import PageTouchHistogram

LOCAL, REMOTE = 0, 1


class CacheFull(RuntimeError):
    """No free page in either tier."""


@dataclasses.dataclass
class PageRef:
    tier: int
    index: int


class PagedTieredCache:
    def __init__(
        self,
        n_layers: int,
        kv_heads: int,
        head_dim: int,
        *,
        page_size: int,
        local_pages: int,
        remote_pages: int,
        max_slots: int,
        max_pages_per_slot: int,
        dtype: torch.dtype = torch.float32,
        store_v: bool = True,
        temperature: PageTouchHistogram | None = None,
        device="cuda",
    ):
        """``store_v=False`` allocates K pages only (a latent row that
        serves as both K and V; the V read aliases the K pool)."""
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        if local_pages + remote_pages < max_pages_per_slot:
            raise ValueError(
                f"pool of {local_pages}+{remote_pages} pages cannot hold one "
                f"full-length sequence ({max_pages_per_slot} pages)")
        self.device = torch.device(device)
        self.page_size = page_size
        self.n_local = local_pages
        self.n_remote = remote_pages
        self.max_slots = max_slots
        self.max_pages = max_pages_per_slot
        self.kv_names: tuple[str, ...] = ("k", "v") if store_v else ("k",)
        # +1 sink page at index n_{local,remote} (never allocated, never read)
        self.pools: dict[str, torch.Tensor] = {}
        for name in self.kv_names:
            for suffix, pages in (("local", local_pages), ("remote", remote_pages)):
                shape = (n_layers, pages + 1, page_size, kv_heads, head_dim)
                self.pools[f"{name}_{suffix}"] = (
                    self._host_pool(shape, dtype) if suffix == "remote"
                    else torch.zeros(shape, dtype=dtype, device=self.device))
        self.free: dict[int, list[int]] = {
            LOCAL: list(range(local_pages)),
            REMOTE: list(range(remote_pages)),
        }
        # Elastic HBM budget: the allocator never places more than
        # `local_limit` pages in the local pool.  Defaults to the full pool
        # (a strict no-op); `set_local_limit` shrinks it mid-run without
        # resizing the pool: pages above the limit are a *deficit* the
        # engine drains by demotion.
        self.local_limit = local_pages
        # table[slot, p] = pool index of the slot's p-th page; tier picks pool
        self.table = np.zeros((max_slots, max_pages_per_slot), dtype=np.int32)
        self.tier = np.zeros((max_slots, max_pages_per_slot), dtype=np.int32)
        self.n_pages = np.zeros(max_slots, dtype=np.int32)
        self.heat = temperature if temperature is not None else PageTouchHistogram()
        self._owner: dict[tuple[int, int], tuple[int, int]] = {}
        # (tier, pool idx) -> (slot, p): reverse page-table map, both tiers
        self.spills = 0                # pressure-driven local->remote moves
        self.promotions = 0            # remote->local page moves
        self.demotions = 0             # local->remote moves not forced by pressure

    def _host_pool(self, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        if self.device.type != "cuda":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        from repro_torch.kernels import _build

        return _build.pinned_empty(shape, dtype).zero_()

    def commit_pools(self, pools: dict[str, torch.Tensor]) -> None:
        """Install a step's pools (the decode step updates them in place, so
        this is the same tensors back)."""
        self.pools = pools

    def _sync_host(self) -> None:
        """Order a host-side pool access after the work queued on the card
        (decode kernels read and write the pinned remote pools in place)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _put_pages(self, pool: torch.Tensor, idx, pages: torch.Tensor) -> None:
        """``pool[:, idx] = pages`` across devices (pages [L, n, page, ...])."""
        self._sync_host()
        pages = pages.to(device=pool.device, dtype=pool.dtype)
        pool[:, torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                device=pool.device)] = pages

    def _take_pages(self, pool: torch.Tensor, idx) -> torch.Tensor:
        """``pool[:, idx]`` as a new tensor on the pool's device."""
        self._sync_host()
        return pool[:, torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                       device=pool.device)]

    # -- occupancy ---------------------------------------------------------
    @property
    def local_in_use(self) -> int:
        return self.n_local - len(self.free[LOCAL])

    @property
    def remote_in_use(self) -> int:
        return self.n_remote - len(self.free[REMOTE])

    @property
    def local_free(self) -> int:
        """Allocatable local pages under the elastic limit: the free-list
        depth, clipped by what the (possibly shrunken) budget still covers.
        Equal to ``len(free[LOCAL])`` at the default (full) limit."""
        return max(0, min(len(self.free[LOCAL]),
                          self.local_limit - self.local_in_use))

    @property
    def local_deficit(self) -> int:
        """Local pages in use beyond the elastic limit — resident pages a
        shrunken HBM budget no longer covers, to be drained by demotion."""
        return max(0, self.local_in_use - self.local_limit)

    def set_local_limit(self, n: int) -> int:
        """Elastically shrink (or restore) the modeled HBM page budget.

        The pool allocation is untouched — only the allocator's ceiling
        moves, so restoring the limit is free.  Returns the resulting
        deficit (pages in use above the new limit) for the caller to
        drain via :meth:`demote_coldest`."""
        self.local_limit = max(0, min(int(n), self.n_local))
        return self.local_deficit

    @property
    def sink_local(self) -> int:
        return self.n_local

    @property
    def sink_remote(self) -> int:
        return self.n_remote

    # -- allocation --------------------------------------------------------
    def owned_pages(self, tier: int) -> list[int]:
        """Pool indices currently owned by some slot in `tier`."""
        return [idx for (t, idx) in self._owner if t == tier]

    def _spill_coldest_local(self) -> int:
        """Migrate the coldest local page to the remote pool; return the
        freed local index."""
        if not self.free[REMOTE]:
            raise CacheFull("both tiers exhausted")
        victim = self.heat.coldest(LOCAL, self.owned_pages(LOCAL))
        self.move_pages(LOCAL, REMOTE, [victim], _pressure=True)
        self.free[LOCAL].remove(victim)
        return victim

    def alloc(self, slot: int) -> PageRef:
        """Append one page to `slot`. New pages are the hottest (they hold
        the sequence tail) so they claim the local tier, spilling the coldest
        local page to remote when the local budget is full."""
        p = int(self.n_pages[slot])
        if p >= self.max_pages:
            raise CacheFull(f"slot {slot} already at max_pages={self.max_pages}")
        if self.local_free > 0:
            idx = self.free[LOCAL].pop()
            tier = LOCAL
        elif (self.n_local > 0 and not self.free[LOCAL]
              and self.local_in_use <= self.local_limit):
            # Local pool physically full but within the elastic budget:
            # hottest-first spills the coldest local page to make room.
            # Under a shrunken limit the free list is non-empty, so this
            # branch is skipped and new pages go remote instead.
            idx = self._spill_coldest_local()
            tier = LOCAL
        elif self.free[REMOTE]:
            idx = self.free[REMOTE].pop()
            tier = REMOTE
        else:
            raise CacheFull("both tiers exhausted")
        self._owner[(tier, idx)] = (slot, p)
        self.heat.touch(tier, idx)           # birth touch (the sequence tail)
        self.table[slot, p] = idx
        self.tier[slot, p] = tier
        self.n_pages[slot] = p + 1
        return PageRef(tier, idx)

    def ensure_capacity(self, slot: int, length: int) -> None:
        """Allocate pages until `slot` can hold `length` tokens."""
        need = -(-length // self.page_size)
        while self.n_pages[slot] < need:
            self.alloc(slot)

    def free_slot(self, slot: int) -> None:
        for p in range(int(self.n_pages[slot])):
            idx, tier = int(self.table[slot, p]), int(self.tier[slot, p])
            self.free[tier].append(idx)
            self._owner.pop((tier, idx), None)
            self.heat.forget(tier, idx)
        self.table[slot] = 0
        self.tier[slot] = 0
        self.n_pages[slot] = 0

    # -- migration ---------------------------------------------------------
    def move_pages(self, tier_from: int, tier_to: int, ids: list[int],
                   _pressure: bool = False) -> int:
        """Move owned pages between tiers without invalidating the shared
        page table: contents are copied pool-to-pool (one batched copy per
        K/V buffer), the owning slots' table entries are retagged in place,
        and the heat histogram entries travel with the pages.  Returns the
        number of pages moved.

        Raises ``CacheFull`` when the destination tier lacks free pages and
        ``KeyError`` when an id is not currently owned in ``tier_from``.
        """
        if tier_from == tier_to or not ids:
            return 0
        if len(self.free[tier_to]) < len(ids):
            raise CacheFull(
                f"destination tier {tier_to} has {len(self.free[tier_to])} "
                f"free pages, need {len(ids)}")
        owners = [self._owner[(tier_from, int(i))] for i in ids]  # KeyError if unowned
        dsts = [self.free[tier_to].pop() for _ in ids]
        sfx = {LOCAL: "local", REMOTE: "remote"}
        for name in self.kv_names:
            src_pool = self.pools[f"{name}_{sfx[tier_from]}"]
            dst_pool = self.pools[f"{name}_{sfx[tier_to]}"]
            self._put_pages(dst_pool, dsts, self._take_pages(src_pool, ids))
        for src, dst, (slot, p) in zip(ids, dsts, owners, strict=True):
            del self._owner[(tier_from, int(src))]
            self._owner[(tier_to, dst)] = (slot, p)
            self.table[slot, p] = dst
            self.tier[slot, p] = tier_to
            self.heat.retag(tier_from, int(src), tier_to, dst)
            self.free[tier_from].append(int(src))
        if tier_from == LOCAL:
            if _pressure:
                self.spills += len(ids)
            else:
                self.demotions += len(ids)
        else:
            self.promotions += len(ids)
        return len(ids)

    def slot_pages(self, slot: int, tier: int) -> list[int]:
        """Pool indices of `slot`'s pages currently resident in `tier`,
        in sequence order (head of the sequence first)."""
        n = int(self.n_pages[slot])
        return [int(self.table[slot, p]) for p in range(n)
                if int(self.tier[slot, p]) == tier]

    def slot_residency(self, slot: int, length: int | None = None) -> dict:
        """How much of `slot`'s cache lives in each tier.  With `length`
        only the pages covering the first `length` tokens are counted (the
        portion a decode step at that kv length attends)."""
        n = int(self.n_pages[slot])
        if length is not None:
            n = min(n, -(-int(length) // self.page_size))
        tiers = self.tier[slot, :n]
        return {
            "pages": n,
            "local_pages": int((tiers == LOCAL).sum()),
            "remote_pages": int((tiers == REMOTE).sum()),
            "local_tokens": int((tiers == LOCAL).sum()) * self.page_size,
        }

    def demote_slot_pages(self, slot: int, max_pages: int | None = None) -> int:
        """Tier-demotion preemption: move up to `max_pages` of `slot`'s
        local pages to the remote pool, coldest first (the sequence tail,
        rewritten every step, goes last), freeing local pages for an
        incoming request while `slot` keeps decoding through the paged
        kernel.  Returns the pages moved (0 when the slot holds no local
        page or the remote pool is full); counted as demotions, not
        spills."""
        owned = self.slot_pages(slot, LOCAL)
        if not owned:
            return 0
        budget = len(owned) if max_pages is None else max(0, int(max_pages))
        budget = min(budget, len(self.free[REMOTE]))
        if budget <= 0:
            return 0
        victims = self.heat.ranked(LOCAL, owned, hottest_first=False)[:budget]
        return self.move_pages(LOCAL, REMOTE, victims)

    # -- elastic degradation ----------------------------------------------
    def demote_coldest(self, n: int) -> int:
        """Demote up to `n` of the globally coldest owned local pages to
        the remote pool — the elastic drain for a shrunken local budget
        (no victim slot: pressure comes from the budget, not a request).
        Capped by the remote free list; returns pages moved (counted as
        demotions, like the migrator's)."""
        owned = self.owned_pages(LOCAL)
        budget = min(max(0, int(n)), len(owned), len(self.free[REMOTE]))
        if budget <= 0:
            return 0
        victims = self.heat.ranked(LOCAL, owned, hottest_first=False)[:budget]
        return self.move_pages(LOCAL, REMOTE, victims)

    def grow_remote(self, extra: int) -> int:
        """Grow the remote (host) pool by `extra` pages — host RAM is the
        elastic tier, so this is how a ``CacheFull`` becomes degradation
        instead of failure.  Each remote pool is reallocated at its new
        size (on the card a new pinned allocation, whose failure raises)
        and the old pages copied in once the work queued on the device is
        done; existing pages keep their indices, the sink page moves to the
        new last index (readers take it per step via :meth:`sink_remote`)
        and the new pages join the free list.  Returns the new remote page
        count."""
        if extra <= 0:
            return self.n_remote
        n = self.n_remote
        self._sync_host()               # no kernel still reads or writes the old pools
        for name in self.kv_names:
            key = f"{name}_remote"
            pool = self.pools[key]
            grown = self._host_pool((pool.shape[0], n + extra + 1, *pool.shape[2:]), pool.dtype)
            grown[:, :n] = pool[:, :n]
            grown[:, n + extra] = pool[:, n]      # old pages, new pages, then the sink
            self.pools[key] = grown
        self.free[REMOTE].extend(range(n, n + extra))
        self.n_remote += extra
        return self.n_remote

    # -- per-step temperature bookkeeping ---------------------------------
    def touch_step(self, lens: np.ndarray, active: np.ndarray) -> None:
        """Record one decode step's page accesses in the heat histogram.

        Every page an active slot attends gets a read touch; the page
        receiving the new K/V row gets a heavier write touch.  Touches are
        issued tail-last so recency ties resolve toward the sequence tail.
        Call once per engine step, before :meth:`write_targets`."""
        self.heat.advance()
        ps = self.page_size
        for slot in np.nonzero(np.asarray(active))[0]:
            n = min(-(-(int(lens[slot]) + 1) // ps), int(self.n_pages[slot]))
            wr_p = min(int(lens[slot]) // ps, self.max_pages - 1)
            for p in range(n):
                self.heat.touch(int(self.tier[slot, p]),
                                int(self.table[slot, p]),
                                2.0 if p == wr_p else 1.0)

    def attended_bytes(self, lens: np.ndarray, active: np.ndarray
                       ) -> tuple[float, float]:
        """(local_bytes, remote_bytes) one decode step reads from the KV
        pools, per the page-table tiers (a K-only pool counts K once)."""
        pool = self.pools["k_local"]
        page_bytes = (pool.shape[0] * self.page_size * pool.shape[3]
                      * pool.shape[4] * pool.element_size() * len(self.kv_names))
        local = remote = 0
        for slot in np.nonzero(np.asarray(active))[0]:
            n = min(-(-(int(lens[slot]) + 1) // self.page_size),
                    int(self.n_pages[slot]))
            tiers = self.tier[slot, :n]
            remote += int((tiers == REMOTE).sum())
            local += int((tiers == LOCAL).sum())
        return local * page_bytes, remote * page_bytes

    # -- data movement -----------------------------------------------------
    def write_prompt(self, slot: int, k: torch.Tensor,
                     v: torch.Tensor | None = None) -> None:
        """Write a prefilled KV block (k, v: [L, T, Kh, hd]) into `slot`'s
        pages, allocating as needed: one batched copy per (tier, K/V).
        K-only caches (``store_v=False``) take just `k`."""
        t = k.shape[1]
        self.ensure_capacity(slot, t)
        ps = self.page_size
        n_pages = -(-t // ps)
        pad = n_pages * ps - t
        sources = {"k": k} if len(self.kv_names) == 1 else {"k": k, "v": v}
        for name, src in sources.items():
            if pad:  # zero-fill the final partial page's tail (masked by lens)
                src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, pad))
            sources[name] = src.reshape(src.shape[0], n_pages, ps, *src.shape[2:])
        for tier, suffix in ((LOCAL, "local"), (REMOTE, "remote")):
            sel = [p for p in range(n_pages) if self.tier[slot, p] == tier]
            if not sel:
                continue
            idx = self.table[slot, sel]
            for name, src in sources.items():
                self._put_pages(self.pools[f"{name}_{suffix}"], idx, src[:, sel])

    def gather(self, slot: int, length: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Reconstruct the dense [L, length, Kh, hd] K and V for `slot` on
        the local pool's device (testing / debugging; the decode path
        gathers inside the kernel).  K-only caches return the K pages for
        both (V aliases K)."""
        self._sync_host()
        ps = self.page_size
        v_name = "v" if "v_local" in self.pools else "k"
        dev = self.pools["k_local"].device
        ks, vs = [], []
        for p in range(-(-length // ps)):
            idx, tier = int(self.table[slot, p]), int(self.tier[slot, p])
            suffix = "local" if tier == LOCAL else "remote"
            n = min(ps, length - p * ps)
            ks.append(self.pools[f"k_{suffix}"][:, idx, :n].to(dev))
            vs.append(self.pools[f"{v_name}_{suffix}"][:, idx, :n].to(dev))
        if not ks:
            l_, _, _, kh, hd = self.pools["k_local"].shape
            z = torch.zeros((l_, 0, kh, hd), dtype=self.pools["k_local"].dtype, device=dev)
            return z, z
        return torch.cat(ks, dim=1), torch.cat(vs, dim=1)

    # -- device-side views -------------------------------------------------
    def device_tables(self) -> tuple[torch.Tensor, torch.Tensor]:
        return (torch.tensor(self.table, device=self.device),
                torch.tensor(self.tier, device=self.device))

    def write_target_arrays(
        self, lens: np.ndarray, active: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-slot (tier, pool index, in-page offset) int32 arrays for
        writing token ``lens[slot]``; inactive slots are redirected to the
        local sink page.  Callers must have run :meth:`ensure_capacity` for
        active slots."""
        slots = np.arange(self.max_slots)
        p_c = np.minimum(lens // self.page_size, self.max_pages - 1)
        tier = np.where(active, self.tier[slots, p_c], LOCAL)
        idx = np.where(active, self.table[slots, p_c], self.sink_local)
        off = np.where(active, lens % self.page_size, 0)
        return tuple(a.astype(np.int32) for a in (tier, idx, off))

    def write_targets(
        self, lens: np.ndarray, active: np.ndarray
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`write_target_arrays` as tensors on the pools' device."""
        return tuple(torch.tensor(a, device=self.device)
                     for a in self.write_target_arrays(lens, active))
