"""Trace workloads through the port's serving frontend: the copied
`frontend.workload` against the reference's, the SLO scheduler against
FCFS on the reference's priority-skewed bursty trace (its `slo_report`
equal to the JAX engine's, relative 1e-9, on the same `HardwareSpec`),
and the idle fast-forward of the modeled clock to the next arrival."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as JC
import repro.frontend.workload as JW
import repro_torch.configs as TC
import repro_torch.frontend.workload as TW
from repro.core.hardware import TPU_V5E as J_TPU
from repro.frontend.metrics import ModeledClock as JClock
from repro.models import model as JM
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.frontend.metrics import ModeledClock as TClock
from repro_torch.serving.engine import ServingEngine as TEngine

GENERATORS = [
    ("poisson", dict(n_requests=12, rate_rps=8.0, seed=3)),
    ("poisson", dict(n_requests=7, seed=0, prompt_max=20, out_max=4)),
    ("bursty", dict(n_requests=12, burst_size=4, burst_gap_s=2.0, seed=5)),
    ("long_prompt", dict(n_requests=16, seed=5)),
]


def _trace(mod, name, kw):
    return getattr(mod, f"{name}_trace")(**kw)


@pytest.mark.parametrize("name,kw", GENERATORS)
def test_workload_generators_match_reference(name, kw):
    j, t = _trace(JW, name, kw), _trace(TW, name, kw)
    assert t.to_dict() == j.to_dict()
    for je, te in zip(j.entries, t.entries):
        np.testing.assert_array_equal(t.prompt_tokens(te, 128), j.prompt_tokens(je, 128))


@pytest.mark.parametrize("scenario", sorted(JW.SCENARIOS))
def test_scenario_traces_match_reference(scenario, tmp_path):
    j, t = JW.scenario_trace(scenario), TW.scenario_trace(scenario)
    assert t.to_dict() == j.to_dict()
    path = tmp_path / "trace.json"
    t.save(str(path))
    back = JW.Trace.load(str(path))               # the reference reads the port's file
    assert back.to_dict() == j.to_dict()
    reqs = t.to_requests(vocab=64)
    jreqs = j.to_requests(vocab=64)
    for r, jr in zip(reqs, jreqs):
        assert (r.rid, r.cls, r.priority, r.arrival_s, r.slo_ttft_s, r.max_new_tokens) == \
            (jr.rid, jr.cls, jr.priority, jr.arrival_s, jr.slo_ttft_s, jr.max_new_tokens)
        np.testing.assert_array_equal(r.prompt, jr.prompt)


def _skewed_trace(mod, n=24):
    """The reference's frontend acceptance trace (tests/test_frontend.py)."""
    classes = (mod.TenantClass("batch", priority=0, slo_ttft_s=None, share=0.7),
               mod.TenantClass("interactive", priority=2, slo_ttft_s=6e-5, share=0.3))
    return mod.bursty_trace(n, burst_size=8, burst_gap_s=5e-5, classes=classes, seed=42,
                            prompt_max=40, out_max=6)


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree.map(np.asarray, JM.init_params(JC.get_smoke("llama2_7b"),
                                                   jax.random.PRNGKey(0)))
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, device="cpu")


def _replay(engine_cls, cfg, params, trace, sched, **kw):
    eng = engine_cls(cfg, params, max_batch=4, max_len=64, global_offload_ratio=0.5,
                     page_size=4, scheduler=sched, **kw)
    reqs = trace.to_requests(cfg.vocab)
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run()


def test_slo_scheduler_beats_fcfs_on_skewed_bursty_trace(weights):
    """On the modeled clock the SLO scheduler (chunked prefill, preemption
    armed) gives the interactive class a strictly lower TTFT p95 and no
    worse attainment than FCFS on the same trace, every request's tokens
    unchanged; and its per-class report is the JAX engine's."""
    jparams, tparams = weights
    cfg = TC.get_smoke("llama2_7b")
    fcfs_reqs, fcfs = _replay(TEngine, cfg, tparams, _skewed_trace(TW), "fcfs",
                              clock=TClock(), hw=T_TPU, device="cpu")
    slo_reqs, slo = _replay(TEngine, cfg, tparams, _skewed_trace(TW), "slo",
                            clock=TClock(), hw=T_TPU, device="cpu")
    assert fcfs.served == slo.served == 24
    by_rid = {r.rid: r for r in slo_reqs}
    assert all(r.out_tokens == by_rid[r.rid].out_tokens for r in fcfs_reqs)
    f_rep, s_rep = fcfs.slo_report()["interactive"], slo.slo_report()["interactive"]
    assert s_rep["ttft_p95"] < f_rep["ttft_p95"]
    assert s_rep["attainment"] >= f_rep["attainment"]
    assert slo.prefill_chunks > 0
    _, jslo = _replay(JEngine, JC.get_smoke("llama2_7b"), jparams, _skewed_trace(JW), "slo",
                      clock=JClock(), hw=J_TPU)
    assert (slo.prefill_chunks, slo.preemptions) == (jslo.prefill_chunks, jslo.preemptions)
    want = jslo.slo_report()
    got = slo.slo_report()
    assert sorted(got) == sorted(want)
    for cls, rep in want.items():
        assert got[cls] == pytest.approx(rep, rel=1e-9), cls


def test_trace_replay_idle_fast_forward(weights):
    """Sparse arrivals: the engine fast-forwards the modeled clock to the
    next arrival instead of spinning, and queue delay stays about 0."""
    cfg = TC.get_smoke("llama2_7b")
    tr = TW.poisson_trace(4, rate_rps=0.5, prompt_max=8, out_max=2, seed=7,
                          classes=(TW.TenantClass("x", 0, None, 1.0),))
    clk = TClock()
    eng = TEngine(cfg, weights[1], max_batch=2, max_len=24, global_offload_ratio=0.0,
                  scheduler="fcfs", clock=clk, device="cpu")
    for r in tr.to_requests(cfg.vocab):
        eng.submit(r)
    stats = eng.run(max_steps=500)
    assert stats.served == 4
    assert clk.now() >= max(e.arrival_s for e in tr.entries)
    assert stats.queue_delay_p95 < 1e-3
