"""Chunked prefill and tier-demotion preemption's cache side, against the
JAX package, on smoke configs with bridged weights (norm weights, and the
SSM leaves, redrawn away from their init values).

Held: `attention_chunk` (RoPE, fractional RoPE with qkv bias, qk-norm),
`mla_attention_chunk` and `ssm_block_chunk` against the reference's over a
half-filled cache; `prefill_chunk` for every decoder family, a prompt fed
in 2 or 3 chunks, logits and every cache entry after each chunk, and the
last chunk's against the port's whole-prompt `prefill`; and the paged
cache's `demote_slot_pages` (coldest first), `slot_residency`,
`local_free` and `attended_bytes` (a K-only MLA pool too) after the same
sequence of operations.  fp32 within 2e-4 relative; counters exact."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serving.paged_cache import PagedTieredCache as JCache
from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.serving.paged_cache import LOCAL, REMOTE
from repro_torch.serving.paged_cache import PagedTieredCache as TCache
from torch_helpers import FP32_TOL, as_np, redraw_recurrent_leaves, rel_err

DECODERS = ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b", "mamba2_370m",
            "zamba2_2p7b", "llava_next_34b"]
CHUNKS = {"llama2_7b": (4, 4, 3), "qwen3_moe_30b_a3b": (5, 6), "deepseek_v2_236b": (3, 8),
          "mamba2_370m": (4, 4, 3), "zamba2_2p7b": (6, 5), "llava_next_34b": (1, 7, 3)}
MAX_LEN = 16


def _bridged(arch: str, seed: int = 0):
    tree = jax.tree.map(np.asarray, JM.init_params(JC.get_smoke(arch), jax.random.PRNGKey(seed)))
    redraw_recurrent_leaves(tree, 41 + seed)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _bridged(arch)
        return cache[arch]
    return get


def _layer(params, i=0):
    return ({k: v[i] for k, v in params[0]["layers"].items()},
            {k: v[i] for k, v in params[1]["layers"].items()})


def _half_filled(rng, shape, start):
    """A cache of `shape` [B, S, ...] filled with noise for [0, start)."""
    c = np.zeros(shape, np.float32)
    c[:, :start] = rng.normal(size=(shape[0], start, *shape[2:]))
    return c


@pytest.mark.parametrize("arch", ["llama2_7b", "chatglm3_6b", "qwen3_32b"])
def test_attention_chunk_matches_reference(weights, arch):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp, tp = _layer(weights(arch))
    rng = np.random.default_rng(2)
    start, n = 5, 4
    x = rng.normal(size=(2, n, tcfg.d_model)).astype(np.float32)
    shape = (2, MAX_LEN, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    k, v = _half_filled(rng, shape, start), _half_filled(rng, shape, start)
    pos = np.arange(start, start + n, dtype=np.int32)
    jy, jk, jv = JL.attention_chunk(jcfg, jnp.asarray(x), jp, jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(pos), start)
    ty, tk, tv = TL.attention_chunk(tcfg, torch.from_numpy(x), tp, torch.from_numpy(k.copy()),
                                    torch.from_numpy(v.copy()), torch.from_numpy(pos), start)
    assert rel_err(ty, jy) < FP32_TOL
    assert rel_err(tk, jk) < FP32_TOL and rel_err(tv, jv) < FP32_TOL
    assert torch.equal(tk[:, start + n:], torch.zeros_like(tk[:, start + n:]))


def test_mla_attention_chunk_matches_reference(weights):
    arch = "deepseek_v2_236b"
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp, tp = _layer(weights(arch))
    rng = np.random.default_rng(3)
    start, n = 6, 3
    x = rng.normal(size=(2, n, tcfg.d_model)).astype(np.float32)
    ckv = _half_filled(rng, (2, MAX_LEN, tcfg.kv_lora_rank), start)
    krope = _half_filled(rng, (2, MAX_LEN, tcfg.rope_head_dim), start)
    pos = np.arange(start, start + n, dtype=np.int32)
    jy, jc, jr = JL.mla_attention_chunk(jcfg, jnp.asarray(x), jp, jnp.asarray(ckv),
                                        jnp.asarray(krope), jnp.asarray(pos), start)
    ty, tc, tr = TL.mla_attention_chunk(tcfg, torch.from_numpy(x), tp,
                                        torch.from_numpy(ckv.copy()),
                                        torch.from_numpy(krope.copy()), torch.from_numpy(pos),
                                        start)
    assert rel_err(ty, jy) < FP32_TOL
    assert rel_err(tc, jc) < FP32_TOL and rel_err(tr, jr) < FP32_TOL


@pytest.mark.parametrize("n", [1, 2, 7])
def test_ssm_block_chunk_matches_reference(weights, n):
    """A chunk shorter than the conv window (1, 2) and a longer one, from
    non-zero conv and SSD carries."""
    arch = "mamba2_370m"
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jp, tp = _layer(weights(arch))
    d_inner = tcfg.ssm_expand * tcfg.d_model
    conv_dim = d_inner + 2 * tcfg.ssm_n_groups * tcfg.ssm_state
    nh = d_inner // tcfg.ssm_head_dim
    rng = np.random.default_rng(4 + n)
    x = rng.normal(size=(2, n, tcfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, tcfg.ssm_conv_width - 1, conv_dim)).astype(np.float32)
    state = rng.normal(scale=0.3, size=(2, nh, tcfg.ssm_head_dim, tcfg.ssm_state)) \
        .astype(np.float32)
    jy, jc, js = JS.ssm_block_chunk(jcfg, jnp.asarray(x), jp, jnp.asarray(conv), jnp.asarray(state))
    ty, tc, ts = TSSM.ssm_block_chunk(tcfg, torch.from_numpy(x), tp, torch.from_numpy(conv),
                                      torch.from_numpy(state))
    assert rel_err(ty, jy) < FP32_TOL
    assert rel_err(tc, jc) < FP32_TOL and rel_err(ts, js) < FP32_TOL


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_chunk_matches_reference_and_whole_prefill(weights, arch):
    """The reference's MoE capacity is per call, so chunks drop what the
    reference's chunks drop at its default capacity factor; the comparison
    with the whole prompt runs dropless."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams, tparams = weights(arch)
    rng = np.random.default_rng(5)
    chunks = CHUNKS[arch]
    prompt = rng.integers(3, tcfg.vocab, (1, sum(chunks))).astype(np.int32)
    jcache = JM.init_cache(jcfg, 1, MAX_LEN)
    tcache = TM.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    start = 0
    for n in chunks:
        sl = prompt[:, start:start + n]
        jl, jcache = JM.prefill_chunk(jcfg, jparams, jcache, jnp.asarray(sl), start)
        tl, tcache = TM.prefill_chunk(tcfg, tparams, tcache, torch.from_numpy(sl), start)
        start += n
        assert tl.shape == jl.shape == (1, 1, tcfg.vocab)
        assert rel_err(tl, jl) < FP32_TOL
        assert sorted(tcache) == sorted(jcache)
        for name in tcache:
            assert rel_err(tcache[name], jcache[name]) < FP32_TOL, name
    if tcfg.n_experts:
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=float(tcfg.n_experts))
    chunked = TM.init_cache(tcfg, 1, MAX_LEN, device="cpu")
    start = 0
    for n in chunks:
        cl, chunked = TM.prefill_chunk(tcfg, tparams, chunked,
                                       torch.from_numpy(prompt[:, start:start + n]), start)
        start += n
    wl, whole = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(prompt)}, max_len=MAX_LEN)
    assert rel_err(cl, wl) < FP32_TOL
    for name in whole:
        assert rel_err(chunked[name], whole[name]) < FP32_TOL, name


def test_prefill_chunk_refuses_the_encoder(weights):
    cfg = TC.get_smoke("hubert_xlarge")
    with pytest.raises(NotImplementedError, match="encoder-only arch has no decode step"):
        TM.prefill_chunk(cfg, {}, {}, torch.zeros((1, 2), dtype=torch.int32), 0)


# ---------------------------------------------------------------------------
# The paged cache: preemption's demotion and the residency queries
# ---------------------------------------------------------------------------
def _caches(store_v=True):
    kw = dict(page_size=4, local_pages=6, remote_pages=8, max_slots=3, max_pages_per_slot=6,
              store_v=store_v)
    return JCache(2, 2, 4, **kw), TCache(2, 2, 4, device="cpu", **kw)


def _same(jc, tc, lens, active):
    np.testing.assert_array_equal(tc.table, jc.table)
    np.testing.assert_array_equal(tc.tier, jc.tier)
    assert tc.free == jc.free and tc._owner == jc._owner
    assert (tc.spills, tc.demotions, tc.promotions) == (jc.spills, jc.demotions, jc.promotions)
    assert tc.local_free == jc.local_free == len(tc.free[LOCAL])
    for slot in range(3):
        assert tc.slot_pages(slot, LOCAL) == jc.slot_pages(slot, LOCAL)
        assert tc.slot_pages(slot, REMOTE) == jc.slot_pages(slot, REMOTE)
        for length in (None, 1, 5, 9, 30):
            assert tc.slot_residency(slot, length) == jc.slot_residency(slot, length)
    assert tc.attended_bytes(lens, active) == jc.attended_bytes(lens, active)
    for key, pool in tc.pools.items():
        sink = tc.sink_local if key.endswith("local") else tc.sink_remote
        np.testing.assert_array_equal(as_np(pool)[:, :sink], as_np(jc.pools[key])[:, :sink])


@pytest.mark.parametrize("store_v", [True, False])
def test_demote_slot_pages_residency_and_attended_bytes_match_reference(store_v):
    jc, tc = _caches(store_v)
    rng = np.random.default_rng(6)
    names = ("k", "v") if store_v else ("k",)
    for slot, t in ((0, 14), (1, 9)):
        kv = [rng.normal(size=(2, t, 2, 4)).astype(np.float32) for _ in names]
        jc.write_prompt(slot, *[jnp.asarray(a) for a in kv])
        tc.write_prompt(slot, *[torch.from_numpy(a) for a in kv])
    lens, active = np.asarray([14, 9, 0], np.int32), np.asarray([True, True, False])
    for _ in range(3):
        jc.touch_step(lens, active)
        tc.touch_step(lens, active)
        lens = lens + active
    _same(jc, tc, lens, active)
    # preemption: demote slot 0's two coldest local pages, then all of slot 1's
    local_seq = [p for p in range(int(tc.n_pages[0])) if tc.tier[0, p] == LOCAL]
    assert len(local_seq) >= 3
    assert tc.demote_slot_pages(0, max_pages=2) == jc.demote_slot_pages(0, max_pages=2) == 2
    _same(jc, tc, lens, active)
    # the local pages nearest the sequence head went first, the tail stayed
    assert [int(tc.tier[0, p]) for p in local_seq] == \
        [REMOTE, REMOTE] + [LOCAL] * (len(local_seq) - 2)
    assert tc.demote_slot_pages(1) == jc.demote_slot_pages(1)
    assert tc.slot_residency(1)["local_pages"] == 0 and tc.demote_slot_pages(1) == 0
    _same(jc, tc, lens, active)
    local, remote = tc.attended_bytes(lens, active)
    page_bytes = 2 * 4 * 2 * 4 * 4 * len(names)    # layers x page x Kh x hd x fp32 x K/V
    assert remote == page_bytes * (tc.slot_residency(0, lens[0] + 1)["remote_pages"]
                                   + tc.slot_residency(1, lens[1] + 1)["remote_pages"])
    assert tc.demotions == jc.demotions and tc.spills == jc.spills
