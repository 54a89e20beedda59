"""The port's whole-sequence `forward` for every family, the encoder
(HuBERT-XLarge smoke: frame embeddings through ``in_proj``, non-causal
attention) and the VLM (LLaVA-NeXT-34B smoke: patch embeddings through
``vision_proj`` before the tokens) against the JAX package, with bridged
weights whose norm weights and biases are redrawn away from 1 and 0.

Held: `forward` for all seven families on plain weights and on weights
tiered at offload 0.5; `embed_inputs` with frames and with patches; VLM
prefill with patches; the prefill step of `launch.steps` for the encoder
and the VLM; the VLM engine's tokens at offload {0, 0.5}; the layer
source bit for bit; the encoder refused by the engine and the serve
command with the reference's reason; and a serve run with the SLO
scheduler on Poisson arrivals.  fp32 within 2e-4 relative."""
from __future__ import annotations

import json

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
from repro.launch import steps as JS
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.core.tiering import TieredTensor
from repro_torch.launch import serve
from repro_torch.launch import steps as TS
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import (
    FP32_TOL,
    assert_trees_equal,
    flat_tree,
    redraw_recurrent_leaves,
    rel_err,
    serve as serve_engine,
)

ARCHS = ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b", "mamba2_370m",
         "zamba2_2p7b", "hubert_xlarge", "llava_next_34b"]
BIASES = ("ln1_b", "ln2_b", "final_b", "bi", "bdown", "bq", "bkv")
REFUSAL = "encoder-only arch has no decode step"


def _bridged(arch: str, seed: int = 0):
    """(jax params, torch params) of `arch`'s smoke config from the
    reference's `init_params`, norm weights and biases redrawn."""
    tree = jax.tree.map(np.asarray, JM.init_params(JC.get_smoke(arch), jax.random.PRNGKey(seed)))
    redraw_recurrent_leaves(tree, 31 + seed)
    rng = np.random.default_rng(37 + seed)
    for path, leaf in list(flat_tree(tree)):
        *parents, key = path.split("/")
        if key in BIASES:
            node = tree
            for k in parents:
                node = node[k]
            node[key] = rng.normal(scale=0.1, size=leaf.shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _bridged(arch)
        return cache[arch]
    return get


def _batch(cfg, seed: int = 3, b: int = 2, t: int = 10) -> dict[str, np.ndarray]:
    """A forward batch as numpy: frames for the encoder, tokens (after
    t // 2 patches for the VLM) otherwise."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"frames": rng.normal(size=(b, t, TM.AUDIO_FRAME_DIM)).astype(np.float32)}
    out = {"tokens": rng.integers(3, cfg.vocab, (b, t - t // 2 if cfg.family == "vlm" else t))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(b, t // 2, TM.VISION_EMBED_DIM)).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _partitioned(arch, jparams, tparams, ratio):
    wl = dict(batch=2, seq_len=16, phase="prefill")
    jplan = JE.plan(JC.get_smoke(arch), JWorkload(**wl), J_TPU, global_ratio=ratio)
    tplan = TE.plan(TC.get_smoke(arch), TWorkload(**wl), T_TPU, global_ratio=ratio)
    return jplan.partition(jparams, align=32), tplan.partition(tparams, align=32)


@pytest.mark.parametrize("ratio", [0.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(weights, arch, ratio):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams, tparams = weights(arch)
    if ratio:
        jparams, tparams = _partitioned(arch, jparams, tparams, ratio)
        assert any(isinstance(leaf, TieredTensor) for _, leaf in flat_tree(tparams))
    jb, tb = _both(_batch(tcfg))
    want = JM.forward(jcfg, jparams, jb)
    got = TM.forward(tcfg, tparams, tb)
    assert got.shape == want.shape == (2, 10, tcfg.vocab)
    assert rel_err(got, want) < FP32_TOL


def test_encoder_forward_is_not_causal(weights):
    """The last frame changes every position's logits (HuBERT attends both
    ways); a causal decoder's earlier positions would not move."""
    cfg = TC.get_smoke("hubert_xlarge")
    _, tparams = weights("hubert_xlarge")
    frames = torch.from_numpy(_batch(cfg)["frames"])
    moved = frames.clone()
    moved[:, -1] += 1.0
    a, b = TM.forward(cfg, tparams, {"frames": frames}), TM.forward(cfg, tparams, {"frames": moved})
    assert torch.all((a[:, 0] - b[:, 0]).abs().amax(dim=-1) > 0)


@pytest.mark.parametrize("arch,with_patches", [("hubert_xlarge", False),
                                               ("llava_next_34b", True),
                                               ("llava_next_34b", False)])
def test_embed_inputs_frames_and_patches(weights, arch, with_patches):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams, tparams = weights(arch)
    batch = _batch(tcfg)
    if not with_patches:
        batch.pop("patches", None)
    jb, tb = _both(batch)
    want, got = JM.embed_inputs(jcfg, jparams, jb), TM.embed_inputs(tcfg, tparams, tb)
    t = 10 if tcfg.family == "encoder" or with_patches else 5
    assert got.shape == want.shape == (2, t, tcfg.d_model)
    assert rel_err(got, want) < FP32_TOL


def test_vlm_prefill_with_patches_matches_reference(weights):
    arch = "llava_next_34b"
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams, tparams = weights(arch)
    jb, tb = _both(_batch(tcfg))
    jl, jcache = JM.prefill(jcfg, jparams, jb, max_len=16)
    tl, tcache = TM.prefill(tcfg, tparams, tb, max_len=16)
    assert rel_err(tl, jl) < FP32_TOL
    for name in ("k", "v"):            # 5 patches + 5 tokens fill the cache
        assert tcache[name].shape == jcache[name].shape
        assert rel_err(tcache[name], jcache[name]) < FP32_TOL


@pytest.mark.parametrize("arch", ["hubert_xlarge", "llava_next_34b"])
def test_prefill_step_matches_reference(weights, arch):
    """`launch.steps`: the encoder's prefill step is the forward pass with
    no cache, the VLM's the prefill of patches and tokens; their inputs
    come from `input_specs` at the reference's shapes, through `mm` over
    weights tiered at offload 0.5."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams, tparams = _partitioned(arch, *weights(arch), 0.5)
    shape = ShapeConfig("prefill_smoke", 12, 2, "prefill")
    tb = TS.input_specs(tcfg, shape, torch.Generator().manual_seed(5), dtype=torch.float32,
                        device="cpu")
    want_shapes = ({"frames": (2, 12, 512)} if arch == "hubert_xlarge" else
                   {"tokens": (2, 6), "patches": (2, 6, 1152)})
    assert {k: tuple(v.shape) for k, v in tb.items()} == want_shapes
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    jl, jcache = JS.make_prefill_step(jcfg)(jparams, jb)
    tl, tcache = TS.make_prefill_step(tcfg, mm=TL.matmul)(tparams, tb)
    assert rel_err(tl, jl) < FP32_TOL
    assert sorted(tcache) == sorted(jcache)
    for name in tcache:
        assert rel_err(tcache[name], jcache[name]) < FP32_TOL


def test_decode_step_maker_matches_model(weights):
    arch = "llava_next_34b"
    cfg = TC.get_smoke(arch)
    _, tparams = weights(arch)
    tb = TS.input_specs(cfg, ShapeConfig("d", 8, 2, "decode"), torch.Generator().manual_seed(1),
                        device="cpu")
    cache = TM.init_cache(cfg, 2, 8, device="cpu")
    got = TS.make_decode_step(cfg)(tparams, dict(cache), tb["tokens"], tb["pos"])
    want = TM.decode_step(cfg, tparams, dict(cache), tb["tokens"], tb["pos"])
    assert tb["tokens"].shape == (2, 1) and tb["pos"] == 7
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("ratio", [0.0, 0.5])
def test_vlm_engine_tokens_match_reference_engine(weights, ratio):
    arch = "llava_next_34b"
    jparams, tparams = weights(arch)
    jstats, jreqs = serve_engine(JEngine, JRequest, JC.get_smoke(arch), jparams, J_TPU, ratio,
                                 seed=17)
    tstats, treqs = serve_engine(TEngine, TRequest, TC.get_smoke(arch), tparams, T_TPU, ratio,
                                 seed=17, device="cpu")
    assert tstats.served == jstats.served == len(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert (tstats.local_pages_hwm, tstats.remote_pages_hwm, tstats.spills) == \
        (jstats.local_pages_hwm, jstats.remote_pages_hwm, jstats.spills)


@pytest.mark.parametrize("arch", ["hubert_xlarge", "llava_next_34b"])
def test_layer_source_is_init_params_bit_for_bit(arch):
    """The drawn source's top leaves (the encoder's ``in_proj``, the VLM's
    ``vision_proj``) and layers equal `init_params`' from the same seed,
    and its layer-by-layer partition equals the partition of the whole."""
    cfg = TC.get_smoke(arch)
    whole = TM.init_params(cfg, torch.Generator().manual_seed(6), device="cpu")
    src = TM.layer_source(cfg, torch.Generator().manual_seed(6), device="cpu")
    top = "in_proj" if cfg.family == "encoder" else "vision_proj"
    assert top in src.top and ("embed" in src.top) == (cfg.family == "vlm")
    assert src.device == torch.device("cpu") and src.dtype == torch.float32
    layers = [src.layer(i) for i in range(cfg.n_layers)]
    assert_trees_equal({"layers": {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]},
                        **src.top}, whole)
    plan = TE.plan(cfg, TWorkload(batch=2, seq_len=16, phase="prefill"), T_TPU, global_ratio=0.5)
    built = plan.partition_source(TM.layer_source(cfg, torch.Generator().manual_seed(6),
                                                  device="cpu"), align=32)
    assert_trees_equal(built, plan.partition(whole, align=32))


def test_encoder_is_refused_by_the_engine_and_the_serve_command(weights):
    cfg = TC.get_smoke("hubert_xlarge")
    _, tparams = weights("hubert_xlarge")
    with pytest.raises(NotImplementedError, match=REFUSAL):
        TEngine(cfg, tparams, device="cpu")
    with pytest.raises(SystemExit, match=REFUSAL):
        serve.main(["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"])


def test_serve_command_slo_scheduler_on_poisson_arrivals(tmp_path):
    out = tmp_path / "tokens.json"
    rep = serve.main(["--smoke", "--device", "cpu", "--requests", "5", "--max-batch", "2",
                      "--new-tokens", "3", "--max-len", "24", "--offload-ratio", "0.5",
                      "--page-size", "4", "--scheduler", "slo", "--prefill-chunk", "4",
                      "--arrival-rate", "2000", "--tokens-out", str(out)])
    assert rep["served"] == 5 and rep["scheduling"]["prefill_chunks"] > 0
    tokens = json.loads(out.read_text())
    assert sorted(tokens) == [str(i) for i in range(5)]
    assert all(1 <= len(v) <= 3 for v in tokens.values())
    assert sum(c["requests"] for c in rep["scheduling"]["slo"].values()) == 5


def test_vlm_serves_through_the_serve_command():
    rep = serve.main(["--arch", "llava_next_34b", "--smoke", "--device", "cpu", "--requests", "3",
                      "--max-batch", "2", "--prompt-len", "6", "--new-tokens", "3",
                      "--max-len", "16", "--offload-ratio", "0.5", "--page-size", "4"])
    assert rep["served"] == 3 and rep["generated_tokens"] == 9
