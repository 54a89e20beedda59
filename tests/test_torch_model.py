"""The port's dense layers and model entry points against the JAX package
on llama2-7b smoke, with weights bridged from the reference's
`init_params` (fp32, within 2e-4 relative)."""
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
from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import ServingEngine
from torch_helpers import FP32_TOL, rel_err

JCFG, TCFG = JC.get_smoke("llama2_7b"), TC.get_smoke("llama2_7b")


@pytest.fixture(scope="module")
def weights():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def test_bridge_carries_fp32_and_bf16():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5)).astype(np.float32)
    assert torch.equal(bridge.tensor_from_numpy(a, device="cpu"), torch.from_numpy(a))
    b = np.asarray(jnp.asarray(a, jnp.bfloat16))
    t = bridge.tensor_from_numpy(b, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), b.astype(np.float32))


def test_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    t = torch.from_numpy
    assert rel_err(TL.rmsnorm(t(x), t(w)), JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))) < FP32_TOL
    pos = np.arange(5, dtype=np.int32) + 3
    for rot in (16, 8):                      # full and fractional rotary
        tc, ts = TL.rope_cos_sin(t(pos), rot, 10000.0)
        jc, js = JL.rope_cos_sin(jnp.asarray(pos), rot, 10000.0)
        assert rel_err(tc, jc) < 1e-5 and rel_err(ts, js) < 1e-5
        got = TL.apply_rope(t(x), tc, ts, rot)
        want = JL.apply_rope(jnp.asarray(x), jc, js, rot)
        assert rel_err(got, want) < FP32_TOL
    xb = jnp.asarray(x, jnp.bfloat16)
    got = TL.apply_rope(bridge.tensor_from_numpy(np.asarray(xb), "cpu"), tc, ts, 8)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, JL.apply_rope(xb, jc, js, 8)) < 1e-2


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, [3, 7]), (False, 5)])
def test_attend_matches_reference(causal, kv_len):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 7, 16, 16)).astype(np.float32)     # padded heads
    k = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    kvl_t = torch.tensor(kv_len) if isinstance(kv_len, list) else kv_len
    kvl_j = jnp.asarray(kv_len) if isinstance(kv_len, list) else kv_len
    t = torch.from_numpy
    got = TL.attend(TCFG, t(q), t(k), t(v), causal=causal, kv_len=kvl_t)
    want = JL.attend(JCFG, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     kv_len=kvl_j)
    assert rel_err(got, want) < FP32_TOL


def test_layer_blocks_match_reference(weights):
    jparams, tparams = weights
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tlp = TM.layer_slice(tparams["layers"], 0)
    x = np.random.default_rng(3).normal(size=(2, 6, 64)).astype(np.float32)
    t = torch.from_numpy
    for tq, jq in zip(TL.qkv_project(TCFG, t(x), tlp), JL.qkv_project(JCFG, jnp.asarray(x), jlp)):
        assert rel_err(tq, jq) < FP32_TOL
    assert rel_err(TL.mlp_block(TCFG, t(x), tlp), JL.mlp_block(JCFG, jnp.asarray(x), jlp)) \
        < FP32_TOL
    assert rel_err(TL.norm(TCFG, t(x), tlp, "ln1"), JL.norm(JCFG, jnp.asarray(x), jlp, "ln1")) \
        < FP32_TOL


def test_prefill_and_decode_step_match_reference(weights):
    jparams, tparams = weights
    toks = np.random.default_rng(4).integers(3, JCFG.vocab, (2, 9)).astype(np.int32)
    jl, jcache = JM.prefill(JCFG, jparams, {"tokens": jnp.asarray(toks)}, max_len=16)
    tl, tcache = TM.prefill(TCFG, tparams, {"tokens": torch.from_numpy(toks)}, max_len=16)
    assert tl.shape == (2, 1, JCFG.vocab)
    assert rel_err(tl, jl) < FP32_TOL
    assert rel_err(tcache["k"], jcache["k"]) < FP32_TOL
    assert rel_err(tcache["v"], jcache["v"]) < FP32_TOL
    nxt = np.asarray([[5], [11]], np.int32)
    # slot-aligned (scalar position) and ragged ([B] positions) decode
    for pos_j, pos_t in ((jnp.int32(9), 9),
                         (jnp.asarray([9, 4], jnp.int32), torch.tensor([9, 4]))):
        jl2, jc2 = JM.decode_step(JCFG, jparams, dict(jcache), jnp.asarray(nxt), pos_j)
        tl2, tc2 = TM.decode_step(TCFG, tparams, dict(tcache), torch.from_numpy(nxt), pos_t)
        assert rel_err(tl2, jl2) < FP32_TOL
        assert rel_err(tc2["k"], jc2["k"]) < FP32_TOL


@pytest.mark.parametrize("family", ["ssm", "hybrid", "encoder", "vlm"])
def test_unported_families_raise(family):
    """The port serves dense, MoE (MLA included), SSM and hybrid decoders;
    the families still to be ported (encoder, vlm) are refused by name, by
    the model and the engine.  The SSM and hybrid families are accepted:
    their smoke configs' params and caches have the reference's layout."""
    if family in ("ssm", "hybrid"):
        arch = "mamba2_370m" if family == "ssm" else "zamba2_2p7b"
        jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
        params = TM.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
        assert shapes(params) == shapes(jax.eval_shape(
            lambda: JM.init_params(jcfg, jax.random.PRNGKey(0))))
        assert shapes(TM.init_cache(tcfg, 2, 8, device="cpu")) == \
            shapes(JM.init_cache(jcfg, 2, 8))
        assert ServingEngine(tcfg, params, max_batch=2, max_len=8, page_size=4,
                             device="cpu").cfg.family == family
        return
    cfg = dataclasses.replace(TCFG, family=family)
    with pytest.raises(NotImplementedError, match="encoder and vlm"):
        TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match=family):
        TM.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match=family):
        ServingEngine(cfg, {}, device="cpu")
