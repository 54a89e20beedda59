"""The port's adaptive-runtime modules against the JAX package's, on the
same inputs: AIMD window sequences, telemetry and its measurement source,
re-planner ratios, `repartition` leaves (bit for bit, and against a fresh
layer-by-layer partition at the new plan), the migrator and the paged
cache's elastic budget (page tables, free lists, gathered pages), the
health ladder and the weight-traffic accounting."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import congestion as JCong
from repro.core import engine as JE
from repro.core import hardware as JH
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.models import model as JM
from repro.models.registry import resolve as jresolve
from repro.runtime import controller as JCtl
from repro.runtime import health as JHealth
from repro.runtime import migration as JMig
from repro.runtime import replan as JRP
from repro.runtime import telemetry as JTel
from repro.serving.paged_cache import PagedTieredCache as JCache
from repro_torch import bridge
from repro_torch.core import congestion as TCong
from repro_torch.core import engine as TE
from repro_torch.core import hardware as TH
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.tiering import TieredTensor
from repro_torch.models import model as TM
from repro_torch.models.registry import resolve as tresolve
from repro_torch.runtime import controller as TCtl
from repro_torch.runtime import health as THealth
from repro_torch.runtime import migration as TMig
from repro_torch.runtime import replan as TRP
from repro_torch.runtime import telemetry as TTel
from repro_torch.serving.paged_cache import PagedTieredCache as TCache
from torch_helpers import as_np, assert_caches_match, assert_trees_equal

JCFG, TCFG = JC.get_smoke("llama2_7b"), TC.get_smoke("llama2_7b")
# the reference has no H100 preset: the port's, field for field
J_H100 = JH.HardwareSpec(**{
    f.name: (JH.TierSpec(**dataclasses.asdict(v)) if isinstance(v, TH.TierSpec) else v)
    for f in dataclasses.fields(TH.H100_SXM) for v in [getattr(TH.H100_SXM, f.name)]})
J_SYSTEMS = {**JH.SYSTEMS, J_H100.name: J_H100}


# ---------------------------------------------------------------------------
# AIMD controller, telemetry, re-planner
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hw,rtt,penalty,chunk_kb,streams,seed", [
    ("tpu_v5e", 2e-6, 0.35, 64, 1, 1),
    ("gh200", 0.7e-6, 0.6, 16, 3, 40),
    ("tpu_v5e", 6e-6, 0.1, 256, 2, 200),
    ("h100_sxm", 2e-6, 0.35, 512, 1, 1),
])
def test_aimd_window_sequence_matches_reference(hw, rtt, penalty, chunk_kb, streams, seed):
    """Each controller fed its package's analytical source from the same
    seed walks the same windows, step for step."""
    chunk = chunk_kb * 1024
    seqs = []
    for cong, hws, ctl in ((JCong, J_SYSTEMS, JCtl), (TCong, TH.SYSTEMS, TCtl)):
        model = cong.CongestionModel(hws[hw], rtt=rtt, penalty=penalty)
        src = cong.ModelSource(model, streams, chunk)
        aimd = ctl.AIMDController(window=seed, host_bw_limit=hws[hw].host.bandwidth,
                                  rtt=model.rtt, n_streams=streams, chunk_bytes=chunk)
        seqs.append([aimd.update(src.measure(aimd.window)) for _ in range(60)]
                    + [aimd.converged, aimd.increases, aimd.decreases])
    assert seqs[1] == seqs[0]


def _samples(tel):
    """A prefill-heavy burst, then decode: the mix the re-planner tracks."""
    out = []
    for i in range(10):
        prefill = 64 if i < 3 else 0
        out.append(tel.StepSample(step=i, duration_s=1e-3 * (1 + i % 3), prefill_tokens=prefill,
                                  decode_tokens=4, queue_depth=max(0, 5 - i), active_slots=4,
                                  mean_kv_len=20.0 + i, local_bytes=1e6 * (i + 1),
                                  remote_bytes=3e5 * (i + 2), window=1 + i % 2,
                                  health="spilling" if i == 4 else "healthy",
                                  local_deficit=1 if i == 4 else 0))
    return out


def test_telemetry_and_source_match_reference():
    views = []
    for tel in (JTel, TTel):
        t = tel.Telemetry(capacity=4, ema_alpha=0.5, predicted_local_bw=2e12,
                          predicted_remote_bw=6e10)
        seen = []
        for s in _samples(tel):
            t.record(s)
            src = tel.TelemetrySource(t)
            seen.append((dataclasses.astuple(src.measure(3)),
                         dataclasses.astuple(src.measure_link(0, 3)), s.tokens,
                         s.prefill_fraction, s.link_bytes, s.achieved_aggregate_bw))
        views.append((seen, t.report(), t.window_trace(), t.mean_batch, t.mean_kv_len))
    assert views[1] == views[0]


def _plans(ratio: float, batch: int = 2, seq: int = 32):
    return (JE.plan(JCFG, JWorkload(batch=batch, seq_len=seq, phase="decode"), JH.TPU_V5E,
                    global_ratio=ratio),
            TE.plan(TCFG, TWorkload(batch=batch, seq_len=seq, phase="decode"), TH.TPU_V5E,
                    global_ratio=ratio))


def test_replanner_and_controller_match_reference():
    """Drift re-plans and forced re-plans land on the same ratios; the
    controller's report over the same samples is the same."""
    views = []
    for plan, rp, tel, ctl, hw in zip(_plans(0.5), (JRP, TRP), (JTel, TTel), (JCtl, TCtl),
                                      (JH.TPU_V5E, TH.TPU_V5E)):
        rep = rp.Replanner(JCFG if rp is JRP else TCFG, hw, plan,
                           policy=rp.ReplanPolicy(drift_threshold=0.2, min_interval=3))
        t = tel.Telemetry(ema_alpha=0.6)
        seen = []
        for s in _samples(tel):
            t.record(s)
            new = rep.maybe_replan(t)
            seen.append(None if new is None else (new.global_ratio, new.op_ratios))
        for frac in (1.0, 0.6, 0.2):
            new = rep.force_ratio(frac, t)
            seen.append(None if new is None else (new.global_ratio, new.op_ratios))
        rt = ctl.RuntimeController(JCFG if rp is JRP else TCFG, plan, hw, drift_threshold=0.2,
                                   replan_min_interval=3)
        for s in _samples(tel):
            rt.on_step(s)
        views.append((seen, rep.replans, rep.last_reason, rt.report()))
    assert views[1] == views[0]
    assert any(v is not None for v in views[1][0][:10]), "no drift re-plan fired"


# ---------------------------------------------------------------------------
# repartition
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def weights():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


@pytest.mark.parametrize("new_ratio", [0.5, 0.9, 0.25, 0.0])
def test_repartition_matches_reference_and_a_fresh_partition(weights, new_ratio):
    """From a 0.5 split to `new_ratio`: the changed paths and every leaf
    equal the reference's bit for bit, the tree equals a fresh
    `partition_source` at the new plan, and every operand whose split did
    not move is the same object."""
    jparams, tparams = weights
    (ja, ta), (jb, tb) = _plans(0.5), _plans(new_ratio)
    jtree, ttree = ja.partition(jparams, align=32), ta.partition(tparams, align=32)
    jnew, jchanged = JRP.repartition(jtree, jb, align=32)
    tnew, tchanged = TRP.repartition(ttree, tb, align=32)
    assert tchanged == jchanged
    assert bool(tchanged) == (new_ratio != 0.5)
    for od in tb.registry:
        jl, tl = jresolve(jnew, od.path), tresolve(tnew, od.path)
        assert isinstance(tl, TieredTensor) == hasattr(jl, "remote"), od.path_str
        if isinstance(tl, TieredTensor):
            np.testing.assert_array_equal(as_np(tl.local), np.asarray(jl.local))
            np.testing.assert_array_equal(as_np(tl.remote), np.asarray(jl.remote))
        else:
            np.testing.assert_array_equal(as_np(tl), np.asarray(jl))
        if od.path_str not in tchanged:
            assert tl is tresolve(ttree, od.path), od.path_str
    fresh = tb.partition_source(TM.LayerSource.from_tree(tparams), align=32)
    assert_trees_equal(tnew, {key: fresh[key] for key in tnew})   # the bridged tree's key order


# ---------------------------------------------------------------------------
# Migration and the elastic budget of the paged cache
# ---------------------------------------------------------------------------
def _cache_pair(local=3, remote=4, slots=2, max_pages=4):
    kw = dict(page_size=4, local_pages=local, remote_pages=remote, max_slots=slots,
              max_pages_per_slot=max_pages)
    return JCache(2, 2, 4, **kw), TCache(2, 2, 4, device="cpu", **kw)


def _write(pair, slot, t, seed):
    rng = np.random.default_rng(seed)
    k, v = (rng.normal(size=(2, t, 2, 4)).astype(np.float32) for _ in range(2))
    pair[0].write_prompt(slot, jnp.asarray(k), jnp.asarray(v))
    pair[1].write_prompt(slot, torch.from_numpy(k), torch.from_numpy(v))
    assert_caches_match(*pair)


def _same_gather(pair, slot, n):
    for a, b in zip(pair[1].gather(slot, n), pair[0].gather(slot, n)):
        np.testing.assert_array_equal(as_np(a), as_np(b))


@pytest.mark.parametrize("budget,headroom", [(0, 1), (1, 1), (2, 0), (3, 1)])
def test_migrator_matches_reference(budget, headroom):
    pair = _cache_pair()
    _write(pair, 1, 6, 1)                  # 2 pages
    _write(pair, 0, 12, 0)                 # 3 more: slot 1's pages spill to the host
    lens, active = np.asarray([12, 6], np.int32), np.ones(2, bool)
    migrators = (JMig.Migrator(budget, headroom), TMig.Migrator(budget, headroom))
    for step in range(4):
        if step == 2:                      # slot 0 finishes: local pages free up to promote into
            for c in pair:
                c.free_slot(0)
            active[0] = False
        reports = []
        for c, m in zip(pair, migrators):
            c.touch_step(lens, active)
            reports.append(dataclasses.astuple(m.step(c, budget_used=0)))
        assert reports[1] == reports[0]
        assert_caches_match(*pair)
    assert dataclasses.astuple(migrators[1].total) == dataclasses.astuple(migrators[0].total)
    assert (migrators[1].total.promoted > 0) == (budget > 0)
    _same_gather(pair, 1, 6)


def test_elastic_budget_matches_reference():
    """set_local_limit, demote_coldest, allocation under the shrunken limit,
    grow_remote (the sink moves to the new last page), and restoring the
    limit, step by step."""
    pair = _cache_pair(local=4, remote=2, slots=3, max_pages=3)
    _write(pair, 0, 9, 2)                  # 3 local pages
    _write(pair, 1, 4, 3)                  # the fourth
    assert [c.set_local_limit(1) for c in pair] == [3, 3]
    assert_caches_match(*pair)
    assert [c.demote_coldest(5) for c in pair] == [2, 2]       # capped by the remote pool
    assert_caches_match(*pair)
    assert [c.grow_remote(3) for c in pair] == [5, 5]
    assert_caches_match(*pair)
    assert pair[1].sink_remote == 5 and pair[1].pools["k_remote"].shape[1] == 6
    assert [c.demote_coldest(pair[1].local_deficit) for c in pair] == [1, 1]
    assert_caches_match(*pair)
    _write(pair, 2, 5, 4)                  # under the limit of 1: new pages go remote
    assert pair[1].local_deficit == 0 and pair[1].remote_in_use == 5
    for slot, n in ((0, 9), (1, 4), (2, 5)):
        _same_gather(pair, slot, n)
    assert [c.set_local_limit(10) for c in pair] == [0, 0]     # restored (clipped to the pool)
    assert_caches_match(*pair)
    assert [c.grow_remote(0) for c in pair] == [5, 5]


# ---------------------------------------------------------------------------
# Health ladder, traffic accounting, the measured source
# ---------------------------------------------------------------------------
def test_health_ladder_matches_reference():
    events = [("pressure", "shrink", 3), ("observe", 3), ("observe", 0), ("pressure", "demote", 2),
              ("observe", 0), ("observe", 0), ("shed",), ("observe", 0), ("observe", 0),
              ("pressure", "grow", 4), ("pressure", "replan", 0), ("pressure", "cache_full", 0),
              ("observe", 1), ("observe", 0), ("observe", 0), ("observe", 0), ("observe", 0)]
    views = []
    for health in (JHealth, THealth):
        mon, seen = health.HealthMonitor(recover_steps=2), []
        for ev in events:
            if ev[0] == "pressure":
                mon.pressure(ev[1], pages=ev[2])
            elif ev[0] == "observe":
                mon.observe(ev[1])
            else:
                mon.shed()
            seen.append((mon.state, mon.counters.events))
        with pytest.raises(ValueError):
            mon.pressure("nonsense")
        views.append((seen, mon.report()))
    assert views[1] == views[0]
    assert views[1][1]["state"] == "healthy" and views[1][1]["elastic_replans"] == 1


@pytest.mark.parametrize("ratio", [0.0, 0.5])
@pytest.mark.parametrize("n_links", [1, 3])
def test_weight_traffic_matches_reference(weights, ratio, n_links):
    jparams, tparams = weights
    jp, tp = _plans(ratio)
    jtree, ttree = jp.partition(jparams, align=32), tp.partition(tparams, align=32)
    assert TTel.weight_tier_bytes(ttree) == JTel.weight_tier_bytes(jtree)
    assert TTel.weight_link_bytes(ttree, n_links) == JTel.weight_link_bytes(jtree, n_links)


def test_cuda_event_source_refuses_the_cpu():
    prior = TCong.ModelSource(TCong.CongestionModel(TH.H100_SXM), 1, 512 * 1024)
    with pytest.raises(ValueError, match="CUDA device"):
        TTel.CudaEventSource(prior, device="cpu")
