"""The port's MLA layers, model, decode step and serving engine against the
JAX package's, on deepseek_v2_236b smoke (MLA latent KV with MoE and
shared experts) with bridged weights: the projections, the expanded-form
prefill attention, the absorbed-form decode over a dense cache, the model
at the default capacity factor 1.5, the paged decode step over K-only
latent pages (V read from the K pool, the (nd+rd)**-0.5 scale) with an
idle slot, and the engines' tokens exactly, dropless, at offload {0, 0.5}
with spills forced.  fp32 within 2e-4 relative."""
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
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import tiered_decode as JTD
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.core.tiering import TieredTensor
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

ARCH = "deepseek_v2_236b"
JCFG, TCFG = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
LATENT = JCFG.kv_lora_rank + JCFG.rope_head_dim


@pytest.fixture(scope="module")
def weights():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(1))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _layer0(weights):
    jparams, tparams = weights
    return (jax.tree.map(lambda a: a[0], jparams["layers"]),
            TM.layer_slice(tparams["layers"], 0))


def _x(seed, b, t):
    return np.random.default_rng(seed).normal(size=(b, t, JCFG.d_model)).astype(np.float32)


def test_bridge_carries_the_mla_tree(weights):
    _, tparams = weights
    own = TM.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: {k: tuple(v.shape) for k, v in tree["layers"].items()}  # noqa: E731
    assert shapes(tparams) == shapes(own)
    assert {"wq_a", "wq_b", "wkv_a", "wkv_b", "kv_a_norm_w", "q_a_norm_w", "shared_wi",
            "shared_wdown", "experts_wi"} <= set(own["layers"])
    assert "wq" not in own["layers"]
    assert {k for k in tparams if k != "layers"} == {k for k in own if k != "layers"}


def test_mla_projections_and_prefill_attention_match_reference(weights):
    jlp, tlp = _layer0(weights)
    x = _x(1, 2, 7)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for got, want in zip(TL.mla_project_q(TCFG, tx, tlp), JL.mla_project_q(JCFG, jx, jlp)):
        assert rel_err(got, want) < FP32_TOL
    for got, want in zip(TL.mla_project_kv_latent(TCFG, tx, tlp),
                         JL.mla_project_kv_latent(JCFG, jx, jlp)):
        assert rel_err(got, want) < FP32_TOL
    pos = np.arange(7, dtype=np.int32) + 2
    got = TL.mla_attention_block(TCFG, tx, tlp, torch.from_numpy(pos))
    assert rel_err(got, JL.mla_attention_block(JCFG, jx, jlp, jnp.asarray(pos))) < FP32_TOL


@pytest.mark.parametrize("ragged", [False, True])
def test_mla_decode_matches_reference(weights, ragged):
    jlp, tlp = _layer0(weights)
    rng = np.random.default_rng(2)
    ckv = rng.normal(size=(3, 12, JCFG.kv_lora_rank)).astype(np.float32)
    krope = rng.normal(size=(3, 12, JCFG.rope_head_dim)).astype(np.float32)
    pos = np.asarray([4, 11, 0], np.int32) if ragged else np.int32(6)
    x = _x(3, 3, 1)
    want = JL.mla_decode(JCFG, jnp.asarray(x), jlp, jnp.asarray(ckv), jnp.asarray(krope),
                         jnp.asarray(pos))
    got = TL.mla_decode(TCFG, torch.from_numpy(x), tlp, torch.from_numpy(ckv),
                        torch.from_numpy(krope), torch.from_numpy(np.asarray(pos)))
    for g, w in zip(got, want):
        assert rel_err(g, w) < FP32_TOL


def test_prefill_and_decode_step_match_reference(weights):
    """The whole model at cf 1.5 (per-sequence groups at prefill, one global
    group at decode), shared experts included."""
    jparams, tparams = weights
    toks = np.random.default_rng(4).integers(3, JCFG.vocab, (2, 9)).astype(np.int32)
    jl, jcache = JM.prefill(JCFG, jparams, {"tokens": jnp.asarray(toks)}, max_len=16)
    tl, tcache = TM.prefill(TCFG, tparams, {"tokens": torch.from_numpy(toks)}, max_len=16)
    assert rel_err(tl, jl) < FP32_TOL
    assert set(tcache) == {"ckv", "krope"}
    for name in tcache:
        assert tcache[name].shape == jcache[name].shape
        assert rel_err(tcache[name], jcache[name]) < FP32_TOL
    nxt = np.asarray([[5], [11]], np.int32)
    jl2, jc2 = JM.decode_step(JCFG, jparams, dict(jcache), jnp.asarray(nxt),
                              jnp.asarray([9, 4], jnp.int32))
    tl2, tc2 = TM.decode_step(TCFG, tparams, dict(tcache), torch.from_numpy(nxt),
                              torch.tensor([9, 4]))
    assert rel_err(tl2, jl2) < FP32_TOL
    assert rel_err(tc2["ckv"], jc2["ckv"]) < FP32_TOL


def test_paged_tiered_decode_step_matches_reference(weights):
    """Latent pages (one kv head of width rank + rd, K only) at cf 1.5 with
    an idle slot; every projection, the shared and the routed experts split
    at offload 0.5."""
    jparams, tparams = weights
    wl = dict(batch=3, seq_len=16, phase="decode")
    jplan = JE.plan(JCFG, JWorkload(**wl), J_TPU, global_ratio=0.5, kv_page_size=4)
    tplan = TE.plan(TCFG, TWorkload(**wl), T_TPU, global_ratio=0.5, kv_page_size=4)
    jp, tp = jplan.partition(jparams, align=32), tplan.partition(tparams, align=32)
    for key in ("wq_b", "experts_wi", "shared_wi"):
        assert isinstance(tp["layers"][key], TieredTensor), key
    assert not isinstance(tp["layers"]["wkv_b"], TieredTensor)   # resident, absorbed at decode
    pools, args = paged_step_inputs(JCFG.n_layers, ("k",), 1, LATENT)
    sinks = dict(zip(("sink_local", "sink_remote"), PAGED_SINKS))
    jl, jpools = JTD.paged_tiered_decode_step(
        JCFG, jp, {k: jnp.asarray(v) for k, v in pools.items()},
        *[jnp.asarray(args[k]) for k in PAGED_STEP_ORDER], window=2, use_kernel=True, **sinks)
    tl, tpools = TTD.paged_tiered_decode_step(
        TCFG, tp, {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        *[torch.from_numpy(args[k]) for k in PAGED_STEP_ORDER], window=2, **sinks)
    assert set(tpools) == {"k_local", "k_remote"}
    assert rel_err(tl, jl) < FP32_TOL
    assert_pools_match(tpools, jpools)


@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_engine_tokens_match_reference_engine(weights, ratio):
    """Dropless capacity, as in test_torch_moe.py."""
    jparams, tparams = weights
    n_new = 6 if ratio else 3          # 6 new tokens force a spill at offload 0.5
    jcfg = dataclasses.replace(JCFG, moe_capacity_factor=float(JCFG.n_experts))
    tcfg = dataclasses.replace(TCFG, moe_capacity_factor=float(TCFG.n_experts))
    jstats, jreqs = serve(JEngine, JRequest, jcfg, jparams, J_TPU, ratio, seed=17,
                          new_tokens=n_new)
    tstats, treqs = serve(TEngine, TRequest, tcfg, tparams, T_TPU, ratio, seed=17,
                          new_tokens=n_new, device="cpu")
    assert tstats.served == jstats.served == len(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert (tstats.local_pages_hwm, tstats.remote_pages_hwm, tstats.spills) == \
        (jstats.local_pages_hwm, jstats.remote_pages_hwm, jstats.spills)
    if ratio == 0.5:
        assert tstats.spills >= 1 and tstats.remote_pages_hwm >= 1


def test_batch_split_step_refuses_mla(weights):
    """The batch-split layout caches GQA heads; MLA serves through the paged
    path only, as in the reference."""
    _, tparams = weights
    with pytest.raises(NotImplementedError, match="MLA"):
        TTD.tiered_decode_step(TCFG, tparams, {}, torch.zeros((2, 1), dtype=torch.int32), 3)
