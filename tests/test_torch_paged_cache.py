"""The port's paged tiered KV cache against the JAX package's: the same
sequence of prompt writes, allocations (with spills), frees and page moves
gives the same page tables, tiers, free lists and counters, equal
non-sink pool contents, and equal decode-step views."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from repro.serving.paged_cache import PagedTieredCache as JCache
from repro_torch.serving.paged_cache import LOCAL, REMOTE
from repro_torch.serving.paged_cache import PagedTieredCache as TCache
from torch_helpers import as_np

L_, KH, HD, PS = 2, 2, 4, 4


def _pair():
    kw = dict(page_size=PS, local_pages=5, remote_pages=6, max_slots=3, max_pages_per_slot=5)
    return JCache(L_, KH, HD, **kw), TCache(L_, KH, HD, device="cpu", **kw)


def _same_state(jc: JCache, tc: TCache) -> None:
    np.testing.assert_array_equal(tc.table, jc.table)
    np.testing.assert_array_equal(tc.tier, jc.tier)
    np.testing.assert_array_equal(tc.n_pages, jc.n_pages)
    assert tc.free == jc.free
    assert tc._owner == jc._owner
    assert (tc.spills, tc.promotions, tc.demotions) == (jc.spills, jc.promotions, jc.demotions)
    assert (tc.local_in_use, tc.remote_in_use) == (jc.local_in_use, jc.remote_in_use)
    for key, pool in tc.pools.items():
        sink = tc.sink_local if key.endswith("local") else tc.sink_remote
        np.testing.assert_array_equal(as_np(pool)[:, :sink], as_np(jc.pools[key])[:, :sink])


def _prompt(rng, t):
    k = rng.normal(size=(L_, t, KH, HD)).astype(np.float32)
    v = rng.normal(size=(L_, t, KH, HD)).astype(np.float32)
    return k, v


def test_write_alloc_spill_free_sequence_matches_reference():
    jc, tc = _pair()
    rng = np.random.default_rng(0)
    for slot, t in ((0, 9), (1, 7), (2, 6)):       # 3 + 2 + 2 pages: spills at slot 2
        k, v = _prompt(rng, t)
        jc.write_prompt(slot, jnp.asarray(k), jnp.asarray(v))
        tc.write_prompt(slot, torch.from_numpy(k), torch.from_numpy(v))
        _same_state(jc, tc)
    assert tc.spills > 0 and tc.remote_in_use > 0
    lens, active = np.asarray([9, 7, 6], np.int32), np.ones(3, bool)
    for step in range(4):
        for c in (jc, tc):
            c.touch_step(lens, active)
            for slot in range(3):
                c.ensure_capacity(slot, int(lens[slot]) + 1)
        _same_state(jc, tc)
        for a, b in zip(tc.write_targets(lens, active), jc.write_targets(lens, active)):
            np.testing.assert_array_equal(as_np(a), as_np(b))
        for a, b in zip(tc.device_tables(), jc.device_tables()):
            np.testing.assert_array_equal(as_np(a), as_np(b))
        lens = lens + 1
        if step == 1:
            jc.free_slot(1)
            tc.free_slot(1)
            active[1] = False
            lens[1] = 0
            _same_state(jc, tc)
    for slot, n in ((0, 13), (2, 10)):
        jk, jv = jc.gather(slot, n)
        tk, tv = tc.gather(slot, n)
        np.testing.assert_array_equal(as_np(tk), as_np(jk))
        np.testing.assert_array_equal(as_np(tv), as_np(jv))


def test_move_pages_matches_reference():
    jc, tc = _pair()
    rng = np.random.default_rng(1)
    k, v = _prompt(rng, 11)
    jc.write_prompt(0, jnp.asarray(k), jnp.asarray(v))
    tc.write_prompt(0, torch.from_numpy(k), torch.from_numpy(v))
    local = sorted(tc.owned_pages(LOCAL))[:2]
    assert jc.move_pages(LOCAL, REMOTE, local) == tc.move_pages(LOCAL, REMOTE, local) == 2
    _same_state(jc, tc)
    remote = sorted(tc.owned_pages(REMOTE))[:1]
    assert jc.move_pages(REMOTE, LOCAL, remote) == tc.move_pages(REMOTE, LOCAL, remote) == 1
    _same_state(jc, tc)
    jk, _ = jc.gather(0, 11)
    tk, _ = tc.gather(0, 11)
    np.testing.assert_array_equal(as_np(tk), k)
    np.testing.assert_array_equal(as_np(tk), as_np(jk))
