"""The port's compiled decode step against the JAX engine's jitted one, on
smoke configs with bridged weights (offload as given, page 4, 3 slots, the
five prompts that force spills, both engines on a `ModeledClock` with the
TPU_V5E profile).

On the CPU there is no CUDA graph: a bucket's `StepGraph` runs the same
step over the same fixed input buffers eagerly, so what is held here is the
bucketing, the counters and the staging; the card's tests hold the graphs
themselves (tests/test_torch_gpu.py).  Graphed tokens must equal the eager
engine's and the JAX engine's (``jit_step=True``), and ``compile_count`` and
``compile_cache_hits`` the JAX engine's, for the static run, an adaptive run
whose window moves between buckets, and the chaos shrink, which grows the
remote pool (a new key) and, with the zero-budget runtime, forces re-plans
that move weights (graphs captured again: ``recaptures``); for MoE and
MLA + MoE, graphed by default, also the remote experts run."""
from __future__ import annotations

import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import congestion as JCong
from repro.core import engine as JE
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro.frontend.metrics import ModeledClock as JClock
from repro.models import model as JM
from repro.runtime.controller import RuntimeController as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core import congestion as TCong
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.frontend.metrics import ModeledClock as TClock
from repro_torch.models import layers as TL
from repro_torch.runtime.controller import RuntimeController as TRuntime
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import SERVE_PROMPT_LENS, redraw_recurrent_leaves

SLOTS, MAX_LEN, PAGE, NEW_TOKENS = 3, 32, 4, 6
ZERO_BUDGETS = dict(window_budget=0, migration_budget=0, drift_threshold=float("inf"))
SLOW_CHUNK = 16     # the slow source's chunk divisor: the window moves between buckets 1 and 2


def _configs(arch: str, n_layers: int | None = None, dropless: bool = False):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    if dropless:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=float(jcfg.n_experts))
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=float(tcfg.n_experts))
    return jcfg, tcfg


def _weights(jcfg):
    """The JAX init's tree (recurrent leaves and norm weights redrawn away
    from their init values) for both packages."""
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    if jcfg.family in ("ssm", "hybrid"):
        redraw_recurrent_leaves(tree, 11)
    return jax.tree.map(jax.numpy.asarray, tree), bridge.params_from_numpy(tree, device="cpu")


def _serve(side: str, cfg, params, ratio: float, *, shrink=None, runtime=None,
           new_tokens=NEW_TOKENS, **kw):
    """Serve the five prompts through one engine; returns (engine, tokens)."""
    engine_cls, request_cls, hw, clock = (
        (JEngine, JRequest, J_TPU, JClock) if side == "jax"
        else (TEngine, TRequest, T_TPU, TClock))
    if side == "torch":
        kw["device"] = "cpu"
    eng = engine_cls(cfg, params, max_batch=SLOTS, max_len=MAX_LEN, hw=hw,
                     global_offload_ratio=ratio, page_size=PAGE, clock=clock(),
                     runtime=runtime, **kw)
    if shrink is not None:
        eng.schedule_hbm_shrink(*shrink)
    rng = np.random.default_rng(7)
    reqs = [request_cls(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                        max_new_tokens=new_tokens) for i, n in enumerate(SERVE_PROMPT_LENS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.stats.served == len(reqs)
    return eng, [r.out_tokens for r in reqs]


def _counters(eng) -> tuple[int, int]:
    return eng.compile_count, eng.compile_cache_hits


@pytest.mark.parametrize("arch,ratio,n_layers", [
    ("llama2_7b", 0.0, None),
    ("llama2_7b", 0.5, None),
    ("llama2_7b", 1.0, None),
    ("opt_30b", 0.5, None),
    ("mamba2_370m", 0.5, None),
    ("zamba2_2p7b", 0.5, 12),            # six groups: both shared blocks, three times each
    ("llava_next_34b", 0.5, None),
])
def test_graphed_tokens_equal_eager_and_reference_engine(arch, ratio, n_layers):
    """Static run: graphed tokens equal eager tokens and the JAX engine's;
    the bucket counters equal the JAX engine's; the eager engine compiles
    nothing."""
    jcfg, tcfg = _configs(arch, n_layers)
    jparams, tparams = _weights(jcfg)
    jeng, want = _serve("jax", jcfg, jparams, ratio, jit_step=True)
    geng, graphed = _serve("torch", tcfg, tparams, ratio)
    eeng, eager = _serve("torch", tcfg, tparams, ratio, jit_step=False)
    assert graphed == eager == want
    assert geng.graphed and not eeng.graphed
    assert _counters(geng) == _counters(jeng) and geng.compile_count >= 1
    assert _counters(eeng) == (0, 0) and eeng.recaptures == geng.recaptures == 0
    assert geng.stats.decode_steps == jeng.stats.decode_steps


def _slow_runtime(side: str, jcfg, tcfg):
    """The default runtime over the analytical source at 1/16 of the plan's
    chunk: the host link reads as under-saturated, so the AIMD window
    climbs to 2 and falls back, crossing buckets."""
    if side == "jax":
        cfg, we, cong, hw, rt = jcfg, JWorkload, JCong, J_TPU, JRuntime
        plan = JE.plan(cfg, we(batch=SLOTS, seq_len=MAX_LEN, phase="decode"), hw,
                       global_ratio=0.5, kv_page_size=PAGE)
    else:
        cfg, we, cong, hw, rt = tcfg, TWorkload, TCong, T_TPU, TRuntime
        plan = TE.plan(cfg, we(batch=SLOTS, seq_len=MAX_LEN, phase="decode"), hw,
                       global_ratio=0.5, kv_page_size=PAGE)
    src = cong.ModelSource(cong.CongestionModel(hw), plan.window.n_streams,
                           plan.window.chunk_bytes // SLOW_CHUNK)
    return rt(cfg, plan, hw, source=src)


def _zero_runtime(side: str, jcfg, tcfg):
    """The zero-budget runtime: only a forced re-plan acts."""
    if side == "jax":
        plan = JE.plan(jcfg, JWorkload(batch=SLOTS, seq_len=MAX_LEN, phase="decode"), J_TPU,
                       global_ratio=0.5, kv_page_size=PAGE)
        return JRuntime(jcfg, plan, J_TPU, **ZERO_BUDGETS)
    plan = TE.plan(tcfg, TWorkload(batch=SLOTS, seq_len=MAX_LEN, phase="decode"), T_TPU,
                   global_ratio=0.5, kv_page_size=PAGE)
    return TRuntime(tcfg, plan, T_TPU, **ZERO_BUDGETS)


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = _configs("llama2_7b")
    return jcfg, tcfg, *_weights(jcfg)


def test_adaptive_window_crosses_buckets_like_reference_engine(llama):
    """An adaptive run whose window moves between buckets 1 and 2: one
    bucket each, hits and tokens as the JAX engine's."""
    jcfg, tcfg, jparams, tparams = llama
    jeng, want = _serve("jax", jcfg, jparams, 0.5, jit_step=True,
                        runtime=_slow_runtime("jax", jcfg, tcfg))
    teng, got = _serve("torch", tcfg, tparams, 0.5, runtime=_slow_runtime("torch", jcfg, tcfg))
    assert got == want
    assert _counters(teng) == _counters(jeng) and teng.compile_count >= 2
    assert {key[1] for key in teng._compiled} == {1, 2}
    assert teng.runtime.stats.window_max == jeng.runtime.stats.window_max == 2
    assert teng.recaptures == 0


@pytest.mark.parametrize("zero_runtime", [False, True], ids=["static", "zero_budget"])
def test_chaos_shrink_new_key_and_recaptures_like_reference_engine(llama, zero_runtime):
    """`--hbm-shrink 2:0.2`: the grown remote pool changes the key (a new
    bucket, counted as the JAX engine counts it, the old graph dropped);
    with the zero-budget runtime the forced re-plans move weights, so the
    graphs are captured again.  Tokens equal the JAX engine's either way."""
    jcfg, tcfg, jparams, tparams = llama

    def runtime(side):
        return _zero_runtime(side, jcfg, tcfg) if zero_runtime else None

    jeng, want = _serve("jax", jcfg, jparams, 0.5, jit_step=True, shrink=(2, 0.2),
                        runtime=runtime("jax"), new_tokens=8)
    teng, got = _serve("torch", tcfg, tparams, 0.5, shrink=(2, 0.2), runtime=runtime("torch"),
                       new_tokens=8)
    assert got == want
    assert _counters(teng) == _counters(jeng)
    assert teng.stats.remote_grown_pages > 0 and len({key[5] for key in teng._compiled}) >= 2
    remote = tuple(teng.pcache.pools["k_remote"].shape)
    assert all(not g.captured for key, g in teng._compiled.items() if key[5] != remote)
    if zero_runtime:
        assert teng.stats.elastic_replans > 0 and teng.recaptures >= 1
    else:
        assert teng.stats.elastic_replans == 0 and teng.recaptures == 0


def test_replan_that_moves_nothing_keeps_the_graphs(llama):
    """Installing a tree whose every leaf is the current one (a drift
    re-plan that moved nothing) drops no graph; a tree with one moved leaf
    drops them all."""
    _, tcfg, _, tparams = llama
    eng, _ = _serve("torch", tcfg, tparams, 0.5)
    assert eng._compiled and all(g.captured for g in eng._compiled.values())
    eng._install_params(dict(eng.params))
    assert all(g.captured for g in eng._compiled.values())
    moved = dict(eng.params, embed=eng.params["embed"].clone())
    eng._install_params(moved)
    assert not any(g.captured for g in eng._compiled.values())


def test_engine_with_graphs_is_freed_without_the_cycle_collector(llama):
    """A bucket's step is bound to the input buffers, not to the engine:
    dropping the last reference frees the engine (and, on the card, its
    pinned pools and graphs) at once, with the cycle collector off."""
    _, tcfg, _, tparams = llama
    eng, _ = _serve("torch", tcfg, tparams, 0.5)
    assert eng._compiled
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("w", range(1, 18))
def test_bucket_window_is_the_reference_rule(w):
    assert TEngine._bucket_window(w) == JEngine._bucket_window(w)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v2_236b"])
def test_moe_graphed_tokens_and_counters_equal_eager_and_reference_engine(arch):
    """MoE (GQA) and MLA + MoE serve graphed by default: their remote
    experts run through one grouped launch per matrix whose expert counts
    stay on the device.  Graphed tokens equal eager tokens and the JAX
    `jit_step=True` engine's, the bucket counters the JAX engine's, and the
    remote experts run (counted on the device) the eager run's."""
    jcfg, tcfg = _configs(arch, dropless=True)
    jparams, tparams = _weights(jcfg)
    jeng, want = _serve("jax", jcfg, jparams, 0.5, jit_step=True)
    ran = {}
    engines = {}
    for jit in (True, False):
        TL.tiered_expert_ffn.remote_experts.reset()
        engines[jit], got = _serve("torch", tcfg, tparams, 0.5, jit_step=jit)
        ran[jit] = int(TL.tiered_expert_ffn.remote_experts)
        assert got == want
    geng, eeng = engines[True], engines[False]
    assert geng.graphed and not eeng.graphed
    assert _counters(geng) == _counters(jeng) and geng.compile_count >= 1
    assert _counters(eeng) == (0, 0)
    assert ran[True] == ran[False] > 0
