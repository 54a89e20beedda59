"""The port's Zamba2-style hybrid decoder, tiered grouped step, layer-by-layer
build and serving engine against the JAX package's, on zamba2_2p7b smoke
(4 Mamba-2 layers, a shared attention + MLP block before every 2, the 2
shared blocks in turn) with bridged weights: dt_bias, A_log, D and every
norm weight, the shared blocks' too, redrawn away from 0/1.

Held: prefill and decode logits and caches (the groups' K/V and every
layer's conv/state); the tiered step with an idle slot on the sink; the
layer-source build bit for bit with the ``shared`` stack tiered; the
engines' tokens, page high-water marks and spills exactly at offload
{0, 0.5}.  fp32 within 2e-4 relative."""
from __future__ import annotations

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
from repro.models import model as JM
from repro.serving import tiered_decode as JTD
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core import engine as TE
from repro_torch.core import tiering as TT
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.models import model as TM
from repro_torch.serving import tiered_decode as TTD
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import (
    FP32_TOL,
    PAGED_SINKS,
    PAGED_STEP_ORDER,
    SERVE_PROMPT_LENS,
    assert_pools_match,
    assert_trees_equal,
    flat_tree,
    paged_step_inputs,
    redraw_recurrent_leaves,
    rel_err,
    serve,
)

ARCH = "zamba2_2p7b"
JCFG, TCFG = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
N_GROUPS = TCFG.n_layers // TCFG.hybrid_attn_every
SHARED = ("wq", "wkv", "wo", "wi", "wdown")


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, JM.init_params(JCFG, jax.random.PRNGKey(2)))
    drawn = redraw_recurrent_leaves(tree, 23)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, device="cpu"), drawn


def test_bridge_carries_the_hybrid_tree(weights):
    _, tparams, drawn = weights
    own = TM.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: {k: tuple(v.shape) for k, v in flat_tree(tree)}  # noqa: E731
    assert shapes(tparams) == shapes(own)
    assert set(own["shared"]) == {"concat_proj", "ln1_w", "ln2_w", *SHARED}
    assert own["shared"]["concat_proj"].shape == (2, 2 * TCFG.d_model, TCFG.d_model)
    assert {"shared/ln1_w", "shared/ln2_w", "layers/ssm_norm_w", "final_w"} <= set(drawn)
    # padded query heads (4 real of 16) carry zero weights, as the reference's
    hd = TCFG.resolved_head_dim
    assert TCFG.padded_heads > TCFG.n_heads
    assert torch.all(own["shared"]["wq"][..., TCFG.n_heads * hd:] == 0)


def test_init_params_is_the_stack_of_layer_draws():
    whole = TM.init_params(TCFG, torch.Generator().manual_seed(4), device="cpu")
    gen = torch.Generator().manual_seed(4)
    top = TM.init_top(TCFG, gen, device="cpu")
    layers = [TM.init_layer(TCFG, gen, device="cpu") for _ in range(TCFG.n_layers)]
    assert list(whole) == ["layers", *top]
    assert_trees_equal({k: v for k, v in whole.items() if k != "layers"}, top)
    for key in layers[0]:
        assert torch.equal(whole["layers"][key], torch.stack([lp[key] for lp in layers])), key


def test_prefill_and_decode_step_match_reference(weights):
    jparams, tparams, _ = weights
    prompt = np.random.default_rng(5).integers(3, JCFG.vocab, (2, 11)).astype(np.int32)
    jl, jcache = JM.prefill(JCFG, jparams, {"tokens": jnp.asarray(prompt)}, max_len=24)
    tl, tcache = TM.prefill(TCFG, tparams, {"tokens": torch.from_numpy(prompt)}, max_len=24)
    assert rel_err(tl, jl) < FP32_TOL
    assert set(tcache) == set(jcache) == {"conv", "state", "k", "v"}
    empty = TM.init_cache(TCFG, 2, 24, device="cpu")
    for name in tcache:
        assert tcache[name].shape == jcache[name].shape == empty[name].shape, name
        assert rel_err(tcache[name], jcache[name]) < FP32_TOL, name
    assert tcache["k"].shape[0] == N_GROUPS
    nxt = np.asarray([[5], [11]], np.int32)
    # slot-aligned (scalar position) and ragged ([B] positions) decode
    for pos_j, pos_t in ((jnp.int32(11), 11),
                         (jnp.asarray([11, 6], jnp.int32), torch.tensor([11, 6]))):
        jl2, jc2 = JM.decode_step(JCFG, jparams, dict(jcache), jnp.asarray(nxt), pos_j)
        tl2, tc2 = TM.decode_step(TCFG, tparams, dict(tcache), torch.from_numpy(nxt), pos_t)
        assert rel_err(tl2, jl2) < FP32_TOL
        for name in tc2:
            assert rel_err(tc2[name], jc2[name]) < FP32_TOL, name


def _plans(ratio):
    wl = dict(batch=3, seq_len=16, phase="decode")
    return (JE.plan(JCFG, JWorkload(**wl), J_TPU, global_ratio=ratio, kv_page_size=4),
            TE.plan(TCFG, TWorkload(**wl), T_TPU, global_ratio=ratio, kv_page_size=4))


def test_tiered_hybrid_decode_step_matches_reference(weights):
    """Offload 0.5: the SSM projections, the shared blocks' projections and
    lm_head tiered; slot 2 idle, its row written to the local sink."""
    jparams, tparams, _ = weights
    jplan, tplan = _plans(0.5)
    jp, tp = jplan.partition(jparams, align=32), tplan.partition(tparams, align=32)
    assert all(isinstance(tp["shared"][k], TT.TieredTensor) for k in SHARED)
    pools, args = paged_step_inputs(N_GROUPS, ("k", "v"), TCFG.n_kv_heads,
                                    TCFG.resolved_head_dim)
    rng = np.random.default_rng(3)
    cache = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in TM.init_cache(TCFG, 3, 16, device="cpu").items() if k in ("conv", "state")}
    sinks = dict(zip(("sink_local", "sink_remote"), PAGED_SINKS))
    jl, jcache, jpools = JTD.tiered_hybrid_decode_step(
        JCFG, jp, {k: jnp.asarray(v) for k, v in cache.items()},
        {k: jnp.asarray(v) for k, v in pools.items()},
        *[jnp.asarray(args[k]) for k in PAGED_STEP_ORDER], window=2, use_kernel=True, **sinks)
    tl, tcache, tpools = TTD.tiered_hybrid_decode_step(
        TCFG, tp, {k: torch.from_numpy(v) for k, v in cache.items()},
        {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        *[torch.from_numpy(args[k]) for k in PAGED_STEP_ORDER], window=2, **sinks)
    assert rel_err(tl, jl) < FP32_TOL
    for name in ("conv", "state"):
        assert rel_err(tcache[name], jcache[name]) < FP32_TOL, name
    assert_pools_match(tpools, jpools)


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_partition_source_equals_partition_of_the_whole(ratio):
    """The ``shared`` block stack is split in a copy of the source's dict:
    the result equals `partition(whole)` bit for bit, and the source's own
    stack stays whole."""
    _, tplan = _plans(ratio)
    whole = TM.init_params(TCFG, torch.Generator().manual_seed(9), device="cpu")
    want = tplan.partition(whole, align=32)
    src = TM.layer_source(TCFG, torch.Generator().manual_seed(9), device="cpu")
    shared_before = dict(src.top["shared"])
    got = tplan.partition_source(src, align=32)
    assert_trees_equal(got, want)
    assert_trees_equal(tplan.partition_source(TM.LayerSource.from_tree(whole), align=32), want)
    assert all(isinstance(got["shared"][k], TT.TieredTensor) for k in SHARED)
    assert src.top["shared"] == shared_before
    assert not any(isinstance(v, TT.TieredTensor) for v in src.top["shared"].values())


@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_engine_tokens_match_reference_engine(weights, ratio):
    jparams, tparams, _ = weights
    jstats, jreqs = serve(JEngine, JRequest, JCFG, jparams, J_TPU, ratio, seed=13)
    tstats, treqs = serve(TEngine, TRequest, TCFG, tparams, T_TPU, ratio, seed=13,
                          device="cpu")
    assert tstats.served == jstats.served == len(SERVE_PROMPT_LENS)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert (tstats.local_pages_hwm, tstats.remote_pages_hwm, tstats.spills) == \
        (jstats.local_pages_hwm, jstats.remote_pages_hwm, jstats.spills)
    if ratio == 0.5:
        assert tstats.local_pages_hwm >= 1 and tstats.remote_pages_hwm >= 1
