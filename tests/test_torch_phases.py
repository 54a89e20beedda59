"""The engine's phase regions (`obs.trace.region`) on the CPU: they nest and
cover the step, the ledger's window and pass records hold what ran, the
profiler's ranges, the ledger and the host phases track share one clock,
and the ledger keeps no engine alive.  A tiny llama2-7b engine at offload
0.8, page 4, 3 slots: 5 local KV pages, so prompts spill pages to the
remote pool."""
from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.frontend.metrics import ModeledClock
from repro_torch.models import model as TM
from repro_torch.obs import trace as T
from repro_torch.serving.engine import Request, ServingEngine

CFG = TC.get_smoke("llama2_7b")
PROMPTS = (10, 16, 7, 14, 9)
STEP_PARTS = ("dak.admit", "dak.stage", "dak.launch", "dak.fetch", "dak.finish")


@pytest.fixture(scope="module")
def params():
    return TM.init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _engine(params, **kw):
    eng = ServingEngine(CFG, params, max_batch=3, max_len=32, global_offload_ratio=0.8,
                        page_size=4, device="cpu", **kw)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(3, CFG.vocab, n).astype(np.int32),
                    max_new_tokens=5) for i, n in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def _host_spans(rec):
    return [e for e in rec.events if e["pid"] == T.HOST_PHASES and e["ph"] == "X"]


def test_regions_nest_and_cover_the_step(params):
    rec = T.ChromeTraceRecorder()
    eng, _ = _engine(params, recorder=rec)
    eng.run()
    spans = _host_spans(rec)
    steps = [e for e in spans if e["name"] == "dak.step"]
    assert len(steps) == len(eng.phases.steps) > 3
    assert [e["args"]["step"] for e in steps] == list(range(len(steps)))
    for e in spans:
        if e["name"] in ("dak.build", "dak.pin", "dak.step"):
            continue
        # every other region lies inside one step
        assert any(s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"] + 1e-3
                   for s in steps), e["name"]
    total = parts = 0.0
    for st in eng.phases.steps:
        total += st.seconds["dak.step"]
        parts += sum(st.seconds.get(name, 0.0) for name in STEP_PARTS)
        assert st.seconds.get("dak.prefill", 0.0) <= st.seconds["dak.admit"]
        assert st.seconds.get("dak.prompt_write", 0.0) <= st.seconds.get("dak.prefill", 0.0)
    assert 0 <= total - parts < 0.1 * total        # the step's self time


def test_ledger_window_is_the_steps_run(params, monkeypatch):
    eng, _ = _engine(params)
    for n in range(1, 5):
        eng.step()
        assert eng.phases.n_steps == len(eng.phases.steps) == n
        assert T.latest_ledger() is eng.phases
    window = eng.phases.window(3)
    assert [s.index for s in window] == [1, 2, 3]
    assert all(a.t1 <= b.t0 for a, b in zip(window, window[1:]))
    assert eng.phases.window(5) is None and eng.phases.window(0) is None
    passes = [p for s in eng.phases.steps for p in s.passes]
    assert [p.tokens for p in passes] == eng.stats.prefill_passes
    monkeypatch.setattr(T, "MAX_STEPS", 2)
    ring = T.PhaseLedger()
    with T.recording(ring):
        for _ in range(3):
            with T.region("dak.step"):
                pass
    assert ring.n_steps == 3 and [s.index for s in ring.steps] == [1, 2]


def test_pass_records_carry_rid_submit_and_first_pass(params):
    """Chunks of 4 tokens: a prompt's later passes carry its first pass's
    start; its prompt is written once, by its last pass."""
    eng, reqs = _engine(params, scheduler="slo", prefill_chunk=4)
    eng.run()
    passes = [p for s in eng.phases.steps for p in s.passes]
    by_rid = {r.rid: r for r in reqs}
    assert {p.rid for p in passes} == set(by_rid)
    for p in passes:
        req = by_rid[p.rid]
        assert (p.t_submit, p.t_prefill) == (req.t_submit, req.t_prefill)
        assert p.t_submit <= p.t_prefill <= p.t0 < p.t1
        if p.pos == 0:
            assert p.t0 == p.t_prefill
        last = p.pos + p.tokens == len(req.prompt)
        assert (p.write_s > 0) == last
        written = p.write_local_bytes + p.write_remote_bytes
        prompt = 2 * -(-len(req.prompt) // 4) * eng.pcache.pools["k_local"][:, 0].nbytes
        assert written >= prompt if last else written == 0
    assert sum(p.pos == 0 for p in passes) == len(reqs)
    assert any(p.pos > 0 for p in passes)


def test_prompt_write_bytes_by_tier(params):
    """A prompt write reports the bytes put into local and remote KV pages:
    its own pages and those its allocation spilled to the remote pool."""
    eng, reqs = _engine(params)
    page = 2 * eng.pcache.pools["k_local"][:, 0].nbytes          # K and V
    lens = {r.rid: len(r.prompt) for r in reqs}
    spills = 0
    while eng.scheduler.waiting or eng.prefilling or any(eng.active):
        before = eng.pcache.spills
        eng.step()
        passes = eng.phases.steps[-1].passes
        spilled = eng.pcache.spills - before
        spills += spilled
        local = sum(p.write_local_bytes for p in passes)
        remote = sum(p.write_remote_bytes for p in passes)
        # every page of the step's prompts lands local (the coldest spills);
        # the decode step's spills are not the writes'
        assert local == page * sum(-(-lens[p.rid] // 4) for p in passes)
        assert remote <= page * spilled
    assert spills and sum(p.write_remote_bytes for s in eng.phases.steps for p in s.passes)


def test_build_record_pins_the_remote_tiers(params):
    """`dak.pin` regions cover the remote layer stacks and KV pools the
    build sets up (on the CPU the top-level leaves' tiers need no copy)."""
    from repro_torch.core.tiering import TieredTensor

    eng, _ = _engine(params)
    build = eng.phases.build
    stacks = sum(t.remote.nbytes for t in eng.params["layers"].values()
                 if isinstance(t, TieredTensor))
    pools = sum(t.nbytes for t in eng.pcache.remote_buffers())
    assert stacks and pools and build.pin_bytes == stacks + pools
    assert 0 < build.seconds["dak.pin"] < build.seconds["dak.build"]


@pytest.mark.parametrize("fill", [None, 0, "tensor"])
def test_every_pin_is_one_region_with_its_bytes(fill):
    """`kernels._build.host_tier` is one `dak.pin` region carrying the bytes
    it allocates, with its fill inside; `copy_to_host` is one more, with no
    bytes (the memory is already counted)."""
    from repro_torch.kernels import _build

    src = torch.arange(24, dtype=torch.bfloat16).view(2, 3, 4)
    ledger = T.PhaseLedger()
    with T.recording(ledger):
        out = _build.host_tier((2, 3, 4), torch.bfloat16, "cpu",
                               fill=src if fill == "tensor" else fill)
        _build.copy_to_host(out[1], src[0])
    assert ledger.build.pin_bytes == 2 * 3 * 4 * 2 and ledger.build.seconds["dak.pin"] > 0
    if fill == "tensor":
        assert torch.equal(out[0], src[0])
    elif fill == 0:
        assert not out[0].any()
    assert torch.equal(out[1], src[0]) and not ledger.steps


def test_profiler_ledger_and_trace_share_the_clock(params):
    """Under torch.profiler each region is a `record_function` range whose
    start and end lie within 1 ms of its span's on the host phases track,
    and the ledger's step and pass stamps within 1 ms of their ranges."""
    from torch.profiler import ProfilerActivity, profile

    rec = T.ChromeTraceRecorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng, _ = _engine(params, recorder=rec)
        eng.run()
    ranges = sorted(((e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("dak.")), key=lambda r: r[1])
    spans = sorted(_host_spans(rec), key=lambda e: e["ts"])
    assert [r[0] for r in ranges] == [e["name"] for e in spans]
    for (_, a, b), e in zip(ranges, spans):
        assert abs(a - e["ts"]) < 1e3 and abs(b - e["ts"] - e["dur"]) < 1e3
    steps = [r for r in ranges if r[0] == "dak.step"]
    passes = [r for r in ranges if r[0] == "dak.prefill"]
    stamps = [(s.t0, s.t1) for s in eng.phases.steps]
    pass_stamps = [(p.t0, p.t1) for s in eng.phases.steps for p in s.passes]
    for (_, a, b), (t0, t1) in zip(steps + passes, stamps + pass_stamps, strict=True):
        assert abs(a - t0 * 1e6) < 1e3 and abs(b - t1 * 1e6) < 1e3


def test_modeled_clock_keeps_the_track_empty(params):
    """On a modeled clock the engine's spans are modeled seconds: the host
    phases track stays empty and the ledger still counts wall seconds."""
    rec = T.ChromeTraceRecorder()
    eng, _ = _engine(params, recorder=rec, clock=ModeledClock())
    eng.run()
    assert not _host_spans(rec)
    assert len(eng.phases.steps) > 3
    assert all(0 < s.seconds["dak.step"] == s.t1 - s.t0 for s in eng.phases.steps)


def test_deleting_the_engine_frees_it(params):
    """The ledger stays reachable and holds no engine, tensor or recorder."""
    eng, _ = _engine(params, recorder=T.ChromeTraceRecorder())
    eng.run()
    ref = weakref.ref(eng)
    ledger = eng.phases
    del eng
    gc.collect()
    assert ref() is None and T.latest_ledger() is ledger

    def plain(obj):
        if isinstance(obj, (int, float, str, type(None))):
            return True
        if isinstance(obj, dict):
            return all(plain(v) for v in obj.values())
        if isinstance(obj, (list, tuple)) or type(obj).__name__ == "deque":
            return all(plain(v) for v in obj)
        return all(plain(v) for v in vars(obj).values())

    assert plain(ledger)
