"""The port's MoE layer, decode step and serving engine against the JAX
package's, on qwen3_moe_30b_a3b smoke with bridged weights.

`moe_block` is held to the reference at the default capacity factor (1.5,
which drops pairs) and dropless, at prefill (one group per sequence) and
decode (one global group), with a forced top-k tie, and with the expert
stack split across tiers (the remote block one grouped product per matrix,
experts with no valid slot skipped; the plain grouped product against the
reference's `_expert_ffn` on the remote block); the
decode step at cf 1.5 with an idle slot; the engines' tokens exactly,
dropless, at offload {0, 0.5} with spills forced.  fp32 within 2e-4
relative."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import engine as JE
from repro.core import tiering as JT
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import tiered_decode as JTD
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core import engine as TE
from repro_torch.core import tiering as TT
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.kernels.ref import splitk_gemm_grouped_ref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving import tiered_decode as TTD
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import (
    FP32_TOL,
    PAGED_SINKS,
    PAGED_STEP_ORDER,
    assert_pools_match,
    paged_step_inputs,
    rel_err,
    serve,
)

ARCH = "qwen3_moe_30b_a3b"
JCFG, TCFG = JC.get_smoke(ARCH), TC.get_smoke(ARCH)


def dropless(cfg):
    return dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))


@pytest.fixture(scope="module")
def weights():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _layer0(weights):
    jparams, tparams = weights
    return (jax.tree.map(lambda a: a[0], jparams["layers"]),
            TM.layer_slice(tparams["layers"], 0))


def test_bridge_carries_the_moe_tree(weights):
    """Every leaf of the reference's tree crosses with the name and shape the
    port's own `init_params` gives it."""
    _, tparams = weights
    own = TM.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: {k: tuple(v.shape) for k, v in tree["layers"].items()}  # noqa: E731
    assert shapes(tparams) == shapes(own)
    assert {"router", "experts_wi", "experts_wdown", "q_norm_w"} <= set(own["layers"])
    assert {k for k in tparams if k != "layers"} == {k for k in own if k != "layers"}


@pytest.mark.parametrize("cf", [None, float(JCFG.n_experts)], ids=["cf1.5", "dropless"])
@pytest.mark.parametrize("b,t", [(2, 7), (5, 1), (2, 200)],
                         ids=["prefill", "decode", "prefill-past-64-rows"])
def test_moe_block_matches_reference(weights, cf, b, t):
    """At prefill-past-64-rows each group's capacity passes 64 rows (75 at
    cf 1.5, 400 dropless), the rows that take the grouped GEMM's cluster
    design in bf16 on the card."""
    if t == 200:
        assert TL.expert_capacity(TCFG, t, cf) > 64
    jlp, tlp = _layer0(weights)
    x = np.random.default_rng(b * 10 + t).normal(size=(b, t, JCFG.d_model)).astype(np.float32)
    want = JL.moe_block(JCFG, jnp.asarray(x), jlp, capacity_factor=cf)
    got = TL.moe_block(TCFG, torch.from_numpy(x), tlp, capacity_factor=cf)
    assert rel_err(got, want) < FP32_TOL


def test_top_k_breaks_ties_toward_the_lower_index():
    v = np.asarray([1, 3, 2, 3, 2, 3, .5, 2], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(v), 4)
    _, tidx = TL._top_k(torch.from_numpy(v), 4)
    assert tidx.tolist() == np.asarray(jidx).tolist() == [1, 3, 5, 2]
    # bf16 rounding makes ties common: 128 experts, top 8
    probs = np.random.default_rng(3).normal(size=(50, 128)).astype(np.float32)
    probs = np.asarray(jnp.asarray(probs, jnp.bfloat16).astype(jnp.float32))
    jv, jidx = jax.lax.top_k(jnp.asarray(probs), 8)
    tv, tidx = TL._top_k(torch.from_numpy(probs), 8)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_block_with_tied_router_logits(weights):
    """Two router columns equal: every token's probabilities tie, and the
    reference keeps the lower expert first."""
    jlp, tlp = _layer0(weights)
    router = np.asarray(jlp["router"]).copy()
    router[:, 5] = router[:, 2]
    router[:, 7] = router[:, 2]
    jlp = dict(jlp, router=jnp.asarray(router))
    tlp = dict(tlp, router=torch.from_numpy(router))
    x = np.random.default_rng(9).normal(size=(4, 1, JCFG.d_model)).astype(np.float32)
    want = JL.moe_block(JCFG, jnp.asarray(x), jlp)
    got = TL.moe_block(TCFG, torch.from_numpy(x), tlp)
    assert rel_err(got, want) < FP32_TOL


@pytest.mark.parametrize("b,t", [(2, 9), (4, 1), (2, 200)],
                         ids=["prefill", "decode", "prefill-past-64-rows"])
def test_tiered_expert_skip_matches_all_experts(weights, b, t):
    """The expert stack split 4|4 across tiers: the skip path (the remote
    block one grouped product per matrix, experts without a valid slot
    skipped) equals the unsplit einsum and the reference's tiered einsum; it
    runs exactly the remote experts the router sent a pair to (an expert's
    first pair is always kept)."""
    jlp, tlp = _layer0(weights)
    split = {key: (TT.partition(tlp[key], 0.5, axis=-3), JT.partition(jlp[key], 0.5, axis=-3))
             for key in ("experts_wi", "experts_wdown")}
    assert split["experts_wi"][0].remote.shape[0] == 4
    t_tiered = dict(tlp, **{k: v[0] for k, v in split.items()})
    j_tiered = dict(jlp, **{k: v[1] for k, v in split.items()})
    x = np.random.default_rng(11).normal(size=(b, t, JCFG.d_model)).astype(np.float32)
    TL.tiered_expert_ffn.remote_experts.reset()
    got = TL.moe_block(TCFG, torch.from_numpy(x), t_tiered)
    run = int(TL.tiered_expert_ffn.remote_experts)
    plain = TL.moe_block(TCFG, torch.from_numpy(x), tlp)
    assert rel_err(got, plain) < FP32_TOL
    assert rel_err(got, JL.moe_block(JCFG, jnp.asarray(x), j_tiered)) < FP32_TOL
    # the remote experts the router kept a pair for, counted from its top-k
    g = b if t > 1 else 1
    xg = torch.from_numpy(x).reshape(g, -1, JCFG.d_model)
    _, idx = TL._top_k(torch.softmax(xg @ tlp["router"], dim=-1), TCFG.top_k)
    assert run == len({int(e) for e in idx.flatten() if e >= 4})


def test_tiered_expert_ffn_skips_experts_without_a_slot():
    """One grouped call per matrix over all three remote experts, given each
    one's count of valid slots; only expert 4 holds one, so the counter
    reads 1 and experts 3 and 5 come out zero."""
    rng = np.random.default_rng(4)
    g, e, c, d, ff = 1, 6, 3, 8, 5
    buf = rng.normal(size=(g, e, c, d)).astype(np.float32)
    valid = np.zeros((g, e, c), bool)
    valid[0, 1, :2] = valid[0, 4, 0] = True                      # experts 1 and 4 only
    buf[~valid] = 0
    wi = torch.from_numpy(rng.normal(size=(e, d, 2 * ff)).astype(np.float32))
    wdown = torch.from_numpy(rng.normal(size=(e, ff, d)).astype(np.float32))
    calls = []

    def mm(a, w):
        raise AssertionError("the expert stacks take the grouped product only")

    def grouped(x, w, counts):
        calls.append((tuple(x.shape), tuple(w.shape), counts.tolist()))
        return splitk_gemm_grouped_ref(x, w, counts)

    mm.grouped = grouped
    TL.tiered_expert_ffn.remote_experts.reset()
    got = TL.tiered_expert_ffn(torch.from_numpy(buf), torch.from_numpy(valid),
                               TT.partition(wi, 0.5, axis=-3), TT.partition(wdown, 0.5, axis=-3),
                               mm=mm)
    assert int(TL.tiered_expert_ffn.remote_experts) == 1           # expert 4 of remote 3..5
    assert calls == [((3, c, d), (3, d, 2 * ff), [0, 1, 0]), ((3, c, ff), (3, ff, d), [0, 1, 0])]
    want = TL._expert_ffn(torch.from_numpy(buf), wi, wdown)
    assert rel_err(got, want) < FP32_TOL
    assert torch.equal(got[0, 3], torch.zeros(c, d)) and torch.equal(got[0, 5], torch.zeros(c, d))


@pytest.mark.parametrize("g", [1, 3], ids=["decode", "prefill"])
def test_plain_grouped_product_matches_reference_expert_ffn(g):
    """The plain grouped product, run as `tiered_expert_ffn` runs it on the
    remote block (the [G, E, C, d] buffer as [E, G*C, d], wi, SwiGLU,
    wdown), against the reference's `_expert_ffn` on the same block; some
    experts hold no valid slot (zero rows, skipped)."""
    rng = np.random.default_rng(20 + g)
    e, c, d, ff = 5, 4, 16, 12
    n_valid = rng.integers(0, c + 1, size=(g, e))
    n_valid[:, 2] = 0                                            # expert 2: no slot at all
    valid = np.arange(c)[None, None, :] < n_valid[..., None]
    buf = rng.normal(size=(g, e, c, d)).astype(np.float32) * valid[..., None]
    wi = rng.normal(size=(e, d, 2 * ff)).astype(np.float32)
    wdown = rng.normal(size=(e, ff, d)).astype(np.float32)
    counts = torch.from_numpy(valid.sum(axis=(0, 2)).astype(np.int32))
    x = torch.from_numpy(buf).transpose(0, 1).reshape(e, g * c, d)
    gate, up = torch.chunk(splitk_gemm_grouped_ref(x, torch.from_numpy(wi), counts), 2, dim=-1)
    y = splitk_gemm_grouped_ref(torch.nn.functional.silu(gate) * up, torch.from_numpy(wdown),
                                counts)
    got = y.reshape(e, g, c, d).transpose(0, 1)
    want = JL._expert_ffn(jnp.asarray(buf), jnp.asarray(wi), jnp.asarray(wdown))
    assert rel_err(got, want) < FP32_TOL
    assert torch.equal(got[:, 2], torch.zeros(g, c, d))


def _plans(cfg_j, cfg_t, wl, ratio):
    return (JE.plan(cfg_j, JWorkload(**wl), J_TPU, global_ratio=ratio, kv_page_size=4),
            TE.plan(cfg_t, TWorkload(**wl), T_TPU, global_ratio=ratio, kv_page_size=4))


def test_paged_tiered_decode_step_matches_reference(weights):
    """cf 1.5 (capacity 1 at B = 3: pairs dropped, the idle slot routed
    too), experts and projections split at offload 0.5."""
    jparams, tparams = weights
    jplan, tplan = _plans(JCFG, TCFG, dict(batch=3, seq_len=16, phase="decode"), 0.5)
    jp, tp = jplan.partition(jparams, align=32), tplan.partition(tparams, align=32)
    assert isinstance(tp["layers"]["experts_wi"], TT.TieredTensor)
    pools, args = paged_step_inputs(JCFG.n_layers, ("k", "v"), JCFG.n_kv_heads,
                                    JCFG.resolved_head_dim)
    sinks = dict(zip(("sink_local", "sink_remote"), PAGED_SINKS))
    jl, jpools = JTD.paged_tiered_decode_step(
        JCFG, jp, {k: jnp.asarray(v) for k, v in pools.items()},
        *[jnp.asarray(args[k]) for k in PAGED_STEP_ORDER], window=2, use_kernel=True, **sinks)
    tl, tpools = TTD.paged_tiered_decode_step(
        TCFG, tp, {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        *[torch.from_numpy(args[k]) for k in PAGED_STEP_ORDER], window=2, **sinks)
    assert rel_err(tl, jl) < FP32_TOL
    assert_pools_match(tpools, jpools)


@pytest.mark.parametrize("ratio,cf", [(0.0, None), (0.5, None), (0.5, 1.5)],
                         ids=["offload0-dropless", "offload0.5-dropless", "offload0.5-cf1.5"])
def test_engine_tokens_match_reference_engine(weights, ratio, cf):
    """Dropless capacity, and the default cf 1.5, where the batched
    requests' drops couple and idle slots take part in the routing: the port
    must feed idle slots exactly what the JAX engine feeds."""
    jparams, tparams = weights
    n_new = 6 if ratio else 3          # 6 new tokens force a spill at offload 0.5
    jcfg, tcfg = (JCFG, TCFG) if cf else (dropless(JCFG), dropless(TCFG))
    jstats, jreqs = serve(JEngine, JRequest, jcfg, jparams, J_TPU, ratio, seed=13,
                          new_tokens=n_new)
    tstats, treqs = serve(TEngine, TRequest, tcfg, tparams, T_TPU, ratio, seed=13,
                          new_tokens=n_new, device="cpu")
    assert tstats.served == jstats.served == len(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert (tstats.local_pages_hwm, tstats.remote_pages_hwm, tstats.spills) == \
        (jstats.local_pages_hwm, jstats.remote_pages_hwm, jstats.spills)
    if ratio == 0.5:
        assert tstats.spills >= 1 and tstats.remote_pages_hwm >= 1
