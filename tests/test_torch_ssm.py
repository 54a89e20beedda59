"""The port's Mamba-2 blocks, SSM decoder, tiered recurrent step and serving
engine against the JAX package's, on mamba2_370m smoke with bridged
weights (dt_bias, A_log, D and every norm weight redrawn away from 0/1).

The SSD forms are held with a T that is no multiple of the chunk, with and
without an initial state, at two B/C groups (where `jnp.repeat` and
`torch.repeat_interleave` agree and `Tensor.repeat` would not); the
chunked form against T recurrent steps; the blocks with column-split
projections at offload 0.5; prefill and decode logits and caches; the
tiered step; the layer-by-layer build bit for bit; the engines' tokens
exactly at offload {0, 0.5}.  fp32 within 2e-4 relative."""
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
from repro.models import ssm as JS
from repro.serving import tiered_decode as JTD
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core import engine as TE
from repro_torch.core import tiering as TT
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.serving import tiered_decode as TTD
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import (
    FP32_TOL,
    SERVE_PROMPT_LENS,
    assert_trees_equal,
    flat_tree,
    redraw_recurrent_leaves,
    rel_err,
    serve,
)

ARCH = "mamba2_370m"
JCFG, TCFG = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
# two B/C groups: each group's B and C serve a run of consecutive heads
JCFG2, TCFG2 = (dataclasses.replace(c, ssm_n_groups=2) for c in (JCFG, TCFG))
PROJ = ("z_proj", "x_proj", "bc_proj", "ssm_out")


def _weights(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(seed)))
    drawn = redraw_recurrent_leaves(tree, seed + 11)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, device="cpu"), drawn


@pytest.fixture(scope="module")
def weights():
    return _weights(JCFG)


@pytest.fixture(scope="module")
def weights_g2():
    return _weights(JCFG2, seed=1)


def _layer(weights, i=0):
    jparams, tparams, _ = weights
    return (jax.tree.map(lambda a: a[i], jparams["layers"]),
            TM.layer_slice(tparams["layers"], i))


def _ssd_inputs(seed, b, t, h, p, g, s, with_h0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, t, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(b, t, h)))).astype(f)      # post-softplus
    a = -np.exp(rng.normal(scale=0.5, size=(h,))).astype(f)
    bm = rng.normal(size=(b, t, g, s)).astype(f)
    cm = rng.normal(size=(b, t, g, s)).astype(f)
    h0 = rng.normal(size=(b, h, p, s)).astype(f) if with_h0 else None
    return x, dt, a, bm, cm, h0


def _both(arrays):
    return ([None if v is None else jnp.asarray(v) for v in arrays],
            [None if v is None else torch.from_numpy(v) for v in arrays])


def test_bridge_carries_the_ssm_tree(weights):
    jparams, tparams, drawn = weights
    own = TM.init_params(TCFG, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: {k: tuple(v.shape) for k, v in flat_tree(tree)}  # noqa: E731
    assert shapes(tparams) == shapes(own)
    assert set(own["layers"]) == {"ln1_w", "z_proj", "x_proj", "bc_proj", "dt_proj", "conv_w",
                                  "dt_bias", "A_log", "D", "ssm_norm_w", "ssm_out"}
    assert {p.rsplit("/", 1)[-1] for p in drawn} == {"dt_bias", "A_log", "D", "ssm_norm_w",
                                                      "ln1_w", "final_w"}
    # the reference's init values and stds
    lp = own["layers"]
    assert torch.all(lp["dt_bias"] == 0) and torch.all(lp["A_log"] == 0)
    assert torch.all(lp["D"] == 1) and torch.all(lp["ssm_norm_w"] == 1)
    assert 0.07 < float(lp["conv_w"].std()) < 0.13 and 0.015 < float(lp["z_proj"].std()) < 0.025


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "h0"])
@pytest.mark.parametrize("t,chunk", [(37, 16), (32, 16), (5, 8)],
                         ids=["ragged", "whole-chunks", "short"])
def test_ssd_chunked_matches_reference(t, chunk, with_h0):
    arrays = _ssd_inputs(t * 10 + with_h0, 2, t, 4, 8, 2, 6, with_h0)
    (jx, jdt, ja, jb, jc, jh0), (tx, tdt, ta, tb, tc, th0) = _both(arrays)
    jy, jst = JS.ssd_chunked(jx, jdt, ja, jb, jc, chunk=chunk, h0=jh0)
    ty, tst = TS.ssd_chunked(tx, tdt, ta, tb, tc, chunk=chunk, h0=th0)
    assert ty.shape == (2, t, 4, 8) and tst.shape == (2, 4, 8, 6)
    assert rel_err(ty, jy) < FP32_TOL
    assert rel_err(tst, jst) < FP32_TOL


def test_segsum_matches_reference():
    a = np.random.default_rng(2).normal(size=(3, 7)).astype(np.float32)
    want, got = np.asarray(JS._segsum(jnp.asarray(a))), TS._segsum(torch.from_numpy(a)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.allclose(got[fin], want[fin], rtol=FP32_TOL, atol=1e-6)


def test_ssd_decode_step_matches_reference():
    x, dt, a, bm, cm, h0 = _ssd_inputs(3, 3, 1, 4, 8, 2, 6, True)
    args = (x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0], h0)
    jargs, targs = _both(args)
    jy, jst = JS.ssd_decode_step(*jargs)
    ty, tst = TS.ssd_decode_step(*targs)
    assert rel_err(ty, jy) < FP32_TOL and rel_err(tst, jst) < FP32_TOL


def test_chunked_form_equals_recurrent_steps():
    """The port's chunked SSD over T = 21 (chunk 8) against 21 of its own
    recurrent steps from the same initial state."""
    x, dt, a, bm, cm, h0 = (None if v is None else torch.from_numpy(v)
                            for v in _ssd_inputs(4, 2, 21, 4, 8, 2, 6, True))
    y, final = TS.ssd_chunked(x, dt, a, bm, cm, chunk=8, h0=h0)
    state, ys = h0, []
    for i in range(21):
        yi, state = TS.ssd_decode_step(x[:, i], dt[:, i], a, bm[:, i], cm[:, i], state)
        ys.append(yi)
    assert rel_err(y, torch.stack(ys, dim=1)) < FP32_TOL
    assert rel_err(final, state) < FP32_TOL


def _tiered_layer(jlp, tlp):
    """The layer with every projection split 0.5 across tiers (bc_proj
    too: its 2·G·S columns split at align 1)."""
    jt = dict(jlp, **{k: JT.partition(jlp[k], 0.5, axis=-1) for k in PROJ})
    tt = dict(tlp, **{k: TT.partition(tlp[k], 0.5, axis=-1) for k in PROJ})
    return jt, tt


def _kernel_mm(a, w):
    return TTD._mm(a, w, 2)      # the tiered GEMM's wrapper (its plain version on the CPU)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_block_and_prefill_caches_match_reference(weights, weights_g2, groups):
    jcfg, tcfg, w = (JCFG, TCFG, weights) if groups == 1 else (JCFG2, TCFG2, weights_g2)
    jlp, tlp = _tiered_layer(*_layer(w))
    assert isinstance(tlp["bc_proj"], TT.TieredTensor)
    x = np.random.default_rng(groups).normal(size=(2, 19, tcfg.d_model)).astype(np.float32)
    jy, jfinal = JS.ssm_block(jcfg, jnp.asarray(x), jlp, mm=JT.matmul)
    ty, tfinal = TS.ssm_block(tcfg, torch.from_numpy(x), tlp, mm=_kernel_mm)
    assert rel_err(ty, jy) < FP32_TOL and rel_err(tfinal, jfinal) < FP32_TOL
    # the conv cache from the block's own projections equals the
    # reference's recomputed one
    ty2, conv, state = TS.ssm_block_prefill(tcfg, torch.from_numpy(x), tlp, mm=_kernel_mm)
    jx = jnp.asarray(x)
    want_conv = jnp.concatenate([JL.matmul(jx, jlp["x_proj"]), JL.matmul(jx, jlp["bc_proj"])],
                                axis=-1)[:, -(jcfg.ssm_conv_width - 1):]
    assert torch.equal(ty2, ty) and torch.equal(state, tfinal)
    assert rel_err(conv, want_conv) < FP32_TOL


@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_block_decode_matches_reference(weights, weights_g2, groups):
    jcfg, tcfg, w = (JCFG, TCFG, weights) if groups == 1 else (JCFG2, TCFG2, weights_g2)
    jlp, tlp = _tiered_layer(*_layer(w, 1))
    rng = np.random.default_rng(7 + groups)
    d_inner = tcfg.ssm_expand * tcfg.d_model
    conv_dim = d_inner + 2 * tcfg.ssm_n_groups * tcfg.ssm_state
    nh = d_inner // tcfg.ssm_head_dim
    x = rng.normal(size=(3, 1, tcfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, tcfg.ssm_conv_width - 1, conv_dim)).astype(np.float32)
    state = rng.normal(size=(3, nh, tcfg.ssm_head_dim, tcfg.ssm_state)).astype(np.float32)
    (jx, jconv, jstate), (tx, tconv, tstate) = _both((x, conv, state))
    want = JS.ssm_block_decode(jcfg, jx, jlp, jconv, jstate, mm=JT.matmul)
    got = TS.ssm_block_decode(tcfg, tx, tlp, tconv, tstate, mm=_kernel_mm)
    for g, j in zip(got, want):
        assert g.shape == j.shape and rel_err(g, j) < FP32_TOL


def test_prefill_and_decode_step_match_reference(weights):
    jparams, tparams, _ = weights
    prompt = np.random.default_rng(5).integers(3, JCFG.vocab, (2, 11)).astype(np.int32)
    jl, jcache = JM.prefill(JCFG, jparams, {"tokens": jnp.asarray(prompt)}, max_len=24)
    tl, tcache = TM.prefill(TCFG, tparams, {"tokens": torch.from_numpy(prompt)}, max_len=24)
    assert rel_err(tl, jl) < FP32_TOL
    assert set(tcache) == set(jcache) == {"conv", "state"}
    for name in tcache:
        assert tcache[name].shape == jcache[name].shape
        assert rel_err(tcache[name], jcache[name]) < FP32_TOL, name
    empty = TM.init_cache(TCFG, 2, 24, device="cpu")
    assert {k: v.shape for k, v in empty.items()} == {k: tcache[k].shape for k in tcache}
    nxt = np.asarray([[5], [11]], np.int32)
    jl2, jc2 = JM.decode_step(JCFG, jparams, dict(jcache), jnp.asarray(nxt), jnp.int32(11))
    tl2, tc2 = TM.decode_step(TCFG, tparams, dict(tcache), torch.from_numpy(nxt), 11)
    assert rel_err(tl2, jl2) < FP32_TOL
    for name in tc2:
        assert rel_err(tc2[name], jc2[name]) < FP32_TOL, name


def _plans(ratio):
    wl = dict(batch=3, seq_len=16, phase="decode")
    return (JE.plan(JCFG, JWorkload(**wl), J_TPU, global_ratio=ratio, kv_page_size=4),
            TE.plan(TCFG, TWorkload(**wl), T_TPU, global_ratio=ratio, kv_page_size=4))


def test_tiered_ssm_decode_step_matches_reference(weights):
    jparams, tparams, _ = weights
    jplan, tplan = _plans(0.5)
    jp, tp = jplan.partition(jparams, align=32), tplan.partition(tparams, align=32)
    tiered = {k for k, v in tp["layers"].items() if isinstance(v, TT.TieredTensor)}
    assert tiered == {"z_proj", "x_proj", "ssm_out"}      # bc (32) and dt (8) round to 0
    assert isinstance(tp["lm_head"], TT.TieredTensor)
    rng = np.random.default_rng(9)
    full = TM.init_cache(TCFG, 3, 16, device="cpu")
    cache = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in full.items()}
    tokens = np.asarray([[3], [7], [5]], np.int32)
    jl, jcache = JTD.tiered_ssm_decode_step(JCFG, jp, {k: jnp.asarray(v) for k, v in cache.items()},
                                            jnp.asarray(tokens), window=2, use_kernel=True)
    tl, tcache = TTD.tiered_ssm_decode_step(TCFG, tp, {k: torch.from_numpy(v)
                                                       for k, v in cache.items()},
                                            torch.from_numpy(tokens), window=2)
    assert rel_err(tl, jl) < FP32_TOL
    for name in ("conv", "state"):
        assert rel_err(tcache[name], jcache[name]) < FP32_TOL, name


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_partition_source_equals_partition_of_the_whole(ratio):
    _, tplan = _plans(ratio)
    whole = TM.init_params(TCFG, torch.Generator().manual_seed(9), device="cpu")
    want = tplan.partition(whole, align=32)
    got = tplan.partition_source(TM.layer_source(TCFG, torch.Generator().manual_seed(9),
                                                 device="cpu"), align=32)
    assert_trees_equal(got, want)
    assert any(isinstance(v, TT.TieredTensor) for _, v in flat_tree(got))


@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_engine_tokens_match_reference_engine(weights, ratio):
    jparams, tparams, _ = weights
    jstats, jreqs = serve(JEngine, JRequest, JCFG, jparams, J_TPU, ratio, seed=13)
    tstats, treqs = serve(TEngine, TRequest, TCFG, tparams, T_TPU, ratio, seed=13,
                          device="cpu")
    assert tstats.served == jstats.served == len(SERVE_PROMPT_LENS)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(len(r.out_tokens) == 6 for r in treqs)
