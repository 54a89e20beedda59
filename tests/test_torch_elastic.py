"""The port's adaptive runtime and elastic degradation at the engine level,
against the JAX engine on llama2-7b smoke with bridged weights: offload
0.5, page 4, the five prompts that force spills, both engines on a
`ModeledClock` (so the step durations the controller sees are the same
modeled seconds on both sides).  Tokens, runtime counters, the health
ladder and the final offload ratio must be equal; every run's tokens must
also equal the unpressured static run's."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import engine as JE
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro.frontend.metrics import ModeledClock as JClock
from repro.models import model as JM
from repro.runtime.controller import RuntimeController as JRuntime
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.frontend.metrics import ModeledClock as TClock
from repro_torch.runtime.controller import RuntimeController as TRuntime
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import SERVE_PROMPT_LENS

JCFG, TCFG = JC.get_smoke("llama2_7b"), TC.get_smoke("llama2_7b")
SLOTS, MAX_LEN, PAGE, RATIO, NEW_TOKENS = 3, 32, 4, 0.5, 8
SHRINK = (2, 0.2)                          # at decode step 2, keep 20% of the local pool
# the zero-budget runtime of tests/test_elastic.py: only the forced re-plan acts
ZERO_BUDGETS = dict(window_budget=0, migration_budget=0, drift_threshold=float("inf"))


@pytest.fixture(scope="module")
def weights():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _prompts() -> list[np.ndarray]:
    rng = np.random.default_rng(7)
    return [rng.integers(3, JCFG.vocab, n).astype(np.int32) for n in SERVE_PROMPT_LENS]


def _runtime(side: str):
    """A zero-budget `RuntimeController` on the engine's own plan."""
    if side == "jax":
        plan = JE.plan(JCFG, JWorkload(batch=SLOTS, seq_len=MAX_LEN, phase="decode"), J_TPU,
                       global_ratio=RATIO, kv_page_size=PAGE)
        return JRuntime(JCFG, plan, J_TPU, **ZERO_BUDGETS)
    plan = TE.plan(TCFG, TWorkload(batch=SLOTS, seq_len=MAX_LEN, phase="decode"), T_TPU,
                   global_ratio=RATIO, kv_page_size=PAGE)
    return TRuntime(TCFG, plan, T_TPU, **ZERO_BUDGETS)


def _serve(side: str, params, *, shrink=None, runtime=None, **kw):
    """Serve the five prompts through one engine; returns (engine, tokens)."""
    engine_cls, request_cls, cfg, hw, clock = (
        (JEngine, JRequest, JCFG, J_TPU, JClock) if side == "jax"
        else (TEngine, TRequest, TCFG, T_TPU, TClock))
    if side == "torch":
        kw["device"] = "cpu"
    eng = engine_cls(cfg, params, max_batch=SLOTS, max_len=MAX_LEN, hw=hw,
                     global_offload_ratio=RATIO, page_size=PAGE, clock=clock(),
                     runtime=runtime, **kw)
    if shrink is not None:
        eng.schedule_hbm_shrink(*shrink)
    reqs = [request_cls(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, [r.out_tokens for r in reqs]


def _elastic_view(eng) -> dict:
    """What the chaos runs must agree on besides tokens."""
    s = eng.stats
    out = {k: getattr(s, k) for k in (
        "served", "failed_requests", "health", "cache_full_caught", "elastic_demoted_pages",
        "remote_grown_pages", "shed_steps", "elastic_replans", "replans", "promoted_pages",
        "demoted_pages", "final_window", "spills", "local_pages_hwm", "remote_pages_hwm",
        "decode_steps")}
    out["counters"] = dataclasses.asdict(eng.health.counters)
    out["transitions"] = [tuple(t) for t in eng.health.transitions]
    out["local_limit"] = eng.pcache.local_limit
    out["n_remote"] = eng.pcache.n_remote
    if eng.runtime is not None:
        out["global_ratio"] = eng.runtime.plan.global_ratio
        out["op_ratios"] = eng.runtime.plan.op_ratios
    return out


@pytest.fixture(scope="module")
def static_tokens(weights):
    _, want = _serve("jax", weights[0])
    return want


def test_adaptive_engine_matches_reference_engine(weights, static_tokens):
    """Default budgets and the analytical source: window, re-plans and
    migration counts equal the JAX engine's, tokens the static run's."""
    jeng, jtok = _serve("jax", weights[0], adaptive=True)
    teng, ttok = _serve("torch", weights[1], adaptive=True)
    assert ttok == jtok == static_tokens
    keys = ("final_window", "replans", "promoted_pages", "demoted_pages")
    assert {k: getattr(teng.stats, k) for k in keys} == {k: getattr(jeng.stats, k) for k in keys}
    assert teng.stats.promoted_pages + teng.stats.demoted_pages > 0, "the migrator never ran"
    assert teng.runtime.report()["window"] == jeng.runtime.report()["window"]
    assert teng.runtime.plan.op_ratios == jeng.runtime.plan.op_ratios


@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_chaos_shrink_matches_reference_engine(weights, static_tokens, adaptive):
    """`--hbm-shrink 2:0.2`, statically and under the zero-budget runtime
    (whose only action is the forced re-plan): no request fails, the
    engine ends healthy, tokens equal the unpressured run's, and every
    elastic counter, transition and the final ratio equal the JAX engine's."""
    jeng, jtok = _serve("jax", weights[0], shrink=SHRINK,
                        runtime=_runtime("jax") if adaptive else None)
    teng, ttok = _serve("torch", weights[1], shrink=SHRINK,
                        runtime=_runtime("torch") if adaptive else None)
    assert ttok == jtok == static_tokens
    assert _elastic_view(teng) == _elastic_view(jeng)
    s = teng.stats
    assert s.failed_requests == 0 and s.health == "healthy"
    assert teng.health.counters.shrink_events == 1
    assert s.elastic_demoted_pages + s.remote_grown_pages > 0, "the shrink never bit"
    if adaptive:
        assert s.elastic_replans >= 1 and teng.runtime.plan.global_ratio > RATIO


def test_degraded_admission_matches_reference_engine(weights):
    """Pressure before anything is admitted: the quota sheds, the idle
    override trickles one request in, the recovering trickle the next;
    shed steps and the requests' degraded tags equal the JAX engine's."""
    views = []
    for side, params in (("jax", weights[0]), ("torch", weights[1])):
        engine_cls, request_cls, cfg, hw, clock = (
            (JEngine, JRequest, JCFG, J_TPU, JClock) if side == "jax"
            else (TEngine, TRequest, TCFG, T_TPU, TClock))
        kw = {"device": "cpu"} if side == "torch" else {}
        eng = engine_cls(cfg, params, max_batch=4, max_len=48, hw=hw, global_offload_ratio=0.1,
                         page_size=PAGE, scheduler="fcfs", clock=clock(), **kw)
        reqs = [request_cls(rid=i, prompt=p[:8], max_new_tokens=4)
                for i, p in enumerate(_prompts()[:3])]
        for r in reqs:
            eng.submit(r)
        eng.health.pressure("cache_full")
        eng.step()
        first = sum(r is not None for r in eng.active) + len(eng.prefilling)
        eng.run()
        views.append({"first_step_admitted": first, "shed_steps": eng.stats.shed_steps,
                      "served": eng.stats.served,
                      "degraded": [(r.rid, r.admitted_degraded) for r in eng.stats.requests],
                      "transitions": [tuple(t) for t in eng.health.transitions],
                      "tokens": [r.out_tokens for r in reqs]})
    assert views[1] == views[0]
    assert views[1]["first_step_admitted"] == 1 and views[1]["shed_steps"] > 0
    assert any(d for _, d in views[1]["degraded"])


def test_shrink_without_runtime_keeps_the_plan(weights):
    """Static engine: a shrink demotes and grows but never re-plans, and a
    shrink fraction outside [0, 1] is refused."""
    teng, _ = _serve("torch", weights[1], shrink=SHRINK)
    assert teng.runtime is None and teng.stats.elastic_replans == 0
    assert teng.pcache.local_limit == int(teng.pcache.n_local * SHRINK[1])
    with pytest.raises(ValueError, match="shrink fraction"):
        teng.schedule_hbm_shrink(1, 1.5)
    assert torch.is_tensor(teng.pcache.pools["k_remote"])


def test_serve_flags_run_the_runtime_and_the_shrink():
    """`--adaptive --hbm-shrink 2:0.2` on the CPU: every request served,
    none failed, the engine healthy at the end after a forced re-plan; a
    malformed shrink is refused."""
    from repro_torch.launch import serve

    out = serve.main(["--device", "cpu", "--smoke", "--requests", "5", "--max-batch", "3",
                      "--prompt-len", "10", "--new-tokens", "6", "--max-len", "32",
                      "--offload-ratio", "0.5", "--page-size", "4", "--adaptive",
                      "--hbm-shrink", "2:0.2"])
    assert out["served"] == 5 and out["failed_requests"] == 0 and out["health"] == "healthy"
    assert out["elastic_replans"] >= 1 and out["replans"] >= out["elastic_replans"]
    with pytest.raises(SystemExit, match="STEP:FRAC"):
        serve.main(["--device", "cpu", "--smoke", "--hbm-shrink", "2"])
