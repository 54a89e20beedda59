"""The port's serving frontend against the JAX engine's: chunked prefill,
the priority and SLO schedulers, tier-demotion preemption and the modeled
clock, with bridged weights (the SSM and hybrid leaves and every norm
weight redrawn away from their init values; MoE dropless, as the
reference's frontend tests run it).

Held, exactly: for every decoder family at offload 0.5, the SLO engine's
tokens, chunk and preemption counters and every request's modeled TTFT
and queue delay (relative 1e-9, the same `HardwareSpec` on both sides);
the priority-preemption case's counters, tokens and the slots' residency
after every step; and, within the port, scheduling never changing tokens
(SLO against FCFS at offload 0, chunks of 1 and 64, the SSM's conv window
across chunks of 1) and the FCFS default's stats."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core.hardware import TPU_V5E as J_TPU
from repro.frontend.metrics import ModeledClock as JClock
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.frontend.metrics import ModeledClock as TClock
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import redraw_recurrent_leaves

FAMILY_ARCHS = ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b", "mamba2_370m",
                "zamba2_2p7b"]
PRIORITIES = [0, 2, 1]
REL = 1e-9


def _dropless(cfg):
    return (dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))
            if cfg.n_experts else cfg)


def _cfgs(arch):
    return _dropless(JC.get_smoke(arch)), _dropless(TC.get_smoke(arch))


@pytest.fixture(scope="module")
def weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            tree = jax.tree.map(np.asarray, JM.init_params(JC.get_smoke(arch),
                                                           jax.random.PRNGKey(0)))
            redraw_recurrent_leaves(tree, 23)
            cache[arch] = (jax.tree.map(jnp.asarray, tree),
                           bridge.params_from_numpy(tree, device="cpu"))
        return cache[arch]
    return get


def _prompts(vocab, lens, seed=23):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, n).astype(np.int32) for n in lens]


def _run(engine_cls, request_cls, cfg, params, prompts, *, new_tokens=4, priorities=None,
         **kw):
    eng = engine_cls(cfg, params, **kw)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=new_tokens,
                        priority=0 if priorities is None else priorities[i])
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run(), eng


SLO_KW = dict(max_batch=2, max_len=24, global_offload_ratio=0.5, page_size=4,
              scheduler="slo", prefill_chunk=4)


@pytest.fixture(scope="module")
def jax_slo_runs(weights):
    """Each family's JAX SLO engine run, recorded once."""
    runs = {}

    def get(arch):
        if arch not in runs:
            jcfg, _ = _cfgs(arch)
            runs[arch] = _run(JEngine, JRequest, jcfg, weights(arch)[0],
                              _prompts(jcfg.vocab, (9, 5, 12)), priorities=PRIORITIES,
                              hw=J_TPU, clock=JClock(), **SLO_KW)[:2]
        return runs[arch]
    return get


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_slo_engine_matches_reference_engine(weights, jax_slo_runs, arch):
    jreqs, jstats = jax_slo_runs(arch)
    _, tcfg = _cfgs(arch)
    treqs, tstats, _ = _run(TEngine, TRequest, tcfg, weights(arch)[1],
                            _prompts(tcfg.vocab, (9, 5, 12)), priorities=PRIORITIES,
                            hw=T_TPU, clock=TClock(), device="cpu", **SLO_KW)
    assert tstats.served == jstats.served == 3
    assert tstats.prefill_chunks == jstats.prefill_chunks > 0
    assert (tstats.preemptions, tstats.preempt_demoted_pages) == \
        (jstats.preemptions, jstats.preempt_demoted_pages)
    for t, j in zip(treqs, jreqs):
        assert t.out_tokens == j.out_tokens, f"request {t.rid}"
        assert t.t_first - t.t_submit == pytest.approx(j.t_first - j.t_submit, rel=REL)
        assert t.t_admit - t.t_submit == pytest.approx(j.t_admit - j.t_submit, rel=REL)
    assert tstats.queue_delay_p95 == pytest.approx(jstats.queue_delay_p95, rel=REL)
    assert tstats.e2e_p50 == pytest.approx(jstats.e2e_p50, rel=REL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_slo_tokens_equal_fcfs_tokens_at_offload_zero(weights, arch):
    _, tcfg = _cfgs(arch)
    prompts = _prompts(tcfg.vocab, (9, 5, 12))
    kw = dict(max_batch=2, max_len=24, global_offload_ratio=0.0, page_size=4, device="cpu")
    fcfs, fstats, _ = _run(TEngine, TRequest, tcfg, weights(arch)[1], prompts, **kw)
    slo, sstats, _ = _run(TEngine, TRequest, tcfg, weights(arch)[1], prompts,
                          priorities=PRIORITIES, scheduler="slo", prefill_chunk=4,
                          clock=TClock(), **kw)
    assert fstats.prefill_chunks == 0 and sstats.prefill_chunks > 0
    assert [r.out_tokens for r in slo] == [r.out_tokens for r in fcfs]


@pytest.mark.parametrize("chunk", [1, 64])
def test_chunked_prefill_boundary_cases(weights, chunk):
    """A chunk of one token and one longer than every prompt (the whole
    prompt) both give the FCFS engine's tokens; `prefill_passes` records
    each pass's prompt rows."""
    _, tcfg = _cfgs("llama2_7b")
    params = weights("llama2_7b")[1]
    prompts = _prompts(tcfg.vocab, (10, 7), seed=31)
    kw = dict(max_batch=2, max_len=32, global_offload_ratio=0.5, page_size=4, device="cpu")
    ref, rstats, _ = _run(TEngine, TRequest, tcfg, params, prompts, **kw)
    got, stats, _ = _run(TEngine, TRequest, tcfg, params, prompts, scheduler="slo",
                         prefill_chunk=chunk, clock=TClock(), **kw)
    assert (stats.prefill_chunks > 0) == (chunk == 1)
    assert rstats.prefill_passes == [10, 7]
    assert stats.prefill_passes == ([1] * 17 if chunk == 1 else [10, 7])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in ref]


def _reference_tokens(cfg, params, prompt, new_tokens, max_len):
    """Greedy tokens of the plain per-request prefill + decode_step path."""
    logits, cache = TM.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)[None]},
                               max_len=max_len)
    toks, pos = [int(torch.argmax(logits[0, -1]))], len(prompt)
    while len(toks) < new_tokens:
        logits, cache = TM.decode_step(cfg, params, cache, torch.tensor([[toks[-1]]]), pos)
        toks.append(int(torch.argmax(logits[0, 0])))
        pos += 1
    return toks


def test_chunk_boundary_ssm_conv_window(weights):
    """Chunks of one token through the SSM's conv window and SSD state."""
    _, tcfg = _cfgs("mamba2_370m")
    params = weights("mamba2_370m")[1]
    prompt = _prompts(tcfg.vocab, (8,), seed=37)[0]
    reqs, stats, _ = _run(TEngine, TRequest, tcfg, params, [prompt], scheduler="slo",
                          prefill_chunk=1, clock=TClock(), max_batch=1, max_len=24,
                          global_offload_ratio=0.5, device="cpu")
    assert reqs[0].out_tokens == _reference_tokens(tcfg, params, prompt, 4, 24)
    assert stats.prefill_chunks >= 7


def _preemption_engine(engine_cls, cfg, params, **kw):
    return engine_cls(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.7,
                      page_size=4, scheduler="priority", **kw)


def test_priority_preemption_matches_reference_engine(weights):
    """Two low-priority prompts fill the small local pool, then a
    high-priority arrival preempts by demoting their pages: the counters,
    the tokens and every slot's residency after every step equal the JAX
    engine's, and the victims' tokens equal the plain reference's."""
    jcfg, tcfg = _cfgs("llama2_7b")
    jparams, tparams = weights("llama2_7b")
    prompts = _prompts(tcfg.vocab, (16, 14, 12), seed=41)
    engines = (_preemption_engine(JEngine, jcfg, jparams, clock=JClock(), hw=J_TPU),
               _preemption_engine(TEngine, tcfg, tparams, clock=TClock(), hw=T_TPU,
                                  device="cpu"))
    reqs = [[cls(rid=i, prompt=p, max_new_tokens=10, priority=5 if i == 2 else 0)
             for i, p in enumerate(prompts)] for cls in (JRequest, TRequest)]
    for eng, rs in zip(engines, reqs):
        eng.submit(rs[0])
        eng.submit(rs[1])
        eng.step()                                # both low-priority requests active
        eng.submit(rs[2])                         # the high-priority arrival
    steps = 0
    while any(e.scheduler.waiting or e.prefilling or any(r is not None for r in e.active)
              for e in engines):
        for eng in engines:
            eng.step()
        steps += 1
        assert steps < 200
        for slot in range(3):
            assert engines[1].pcache.slot_residency(slot) == \
                engines[0].pcache.slot_residency(slot), (steps, slot)
        assert engines[1].stats.preemptions == engines[0].stats.preemptions
    jstats, tstats = engines[0].stats, engines[1].stats
    assert tstats.served == jstats.served == 3
    assert tstats.preemptions == jstats.preemptions >= 1
    assert tstats.preempt_demoted_pages == jstats.preempt_demoted_pages >= 1
    assert [r.preemptions for r in reqs[1]] == [r.preemptions for r in reqs[0]]
    assert sum(r.preemptions for r in reqs[1]) >= 1
    for t, j in zip(reqs[1], reqs[0]):
        assert t.out_tokens == j.out_tokens
        assert t.out_tokens == _reference_tokens(tcfg, tparams, t.prompt, 10, 32)
        assert t.t_first - t.t_submit == pytest.approx(j.t_first - j.t_submit, rel=REL)


def test_fcfs_default_unchanged_stats_extensions(weights):
    """The default engine serves FCFS whole prompts and reports the queue
    delay, end-to-end percentiles and request records."""
    _, tcfg = _cfgs("llama2_7b")
    prompts = _prompts(tcfg.vocab, (6, 6, 6), seed=43)
    reqs, stats, eng = _run(TEngine, TRequest, tcfg, weights("llama2_7b")[1], prompts,
                            max_batch=2, max_len=24, global_offload_ratio=0.3, device="cpu")
    assert eng.scheduler.name == "fcfs" and eng.clock.kind == "wall"
    assert stats.served == 3 and stats.prefill_chunks == 0 and stats.preemptions == 0
    assert len(stats.queue_delays) == 3 and len(stats.e2e_latencies) == 3
    assert stats.e2e_p95 >= stats.ttft_p95 >= 0 and stats.e2e_p95 >= stats.e2e_p50
    assert stats.queue_delay_p95 >= stats.queue_delay_p50 >= 0
    assert len(stats.requests) == 3 and all(r.out_tokens for r in reqs)
    assert stats.slo_report()["default"]["requests"] == 3
