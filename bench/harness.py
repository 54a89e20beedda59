"""One run of one cell: set-up, the measured window, the metrics, the check.

Set-up builds the engine from the seed's weights and fills every slot: one
request per client, all admitted and prefilled by the first engine step,
whose decode step captures the graph.  The window then runs whole engine
steps from the first step after set-up to the end of the first step that
finishes after `seconds`; its span is the denominator of every rate.  The
clients are closed-loop (`bench.clients`): each sends its next request when
its last completes, and the next step admits it.  After each step, which
ends in the step's token fetch, every new token is stamped with the host
clock.  With `trace`, torch.profiler records the window.

The cell's metrics are readers in ``bench/metrics/<name>.py``, found by the
names in ``BENCHMARK.json``: the end-to-end ones without `trace`, the
per-layer ones with it.  Each takes the run's `Readings` and returns a
number, or None where it finds nothing to read.

After the window the program is freed and the reference judges a sample of
the served requests (`bench.judge`).  With ``judged="fp8"`` (the check's
control) the tokens judged are not the served ones but those that the
reference computed in fp8 ranks first at the same positions, through the
same checks and limits: a sound check comes out not correct.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from bench import clients, devtrace, judge, program

ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Step:
    """One engine step of the window, as the benchmark saw it."""

    seconds: float                   # host clock, end of the last step to end of this one
    ctxs: list[int]                  # context each decode row attended
    prefills: list[int]              # prompt lengths prefilled
    kv_local: float                  # bytes by the page table's tiers (program count)
    kv_remote: float
    experts: int                     # remote experts run (program count)


@dataclasses.dataclass
class Readings:
    """Everything a metric reader may read."""

    model: dict
    mix: dict
    setup_s: float
    window_s: float                  # host clock
    tokens: int                      # output tokens emitted in the window
    gaps_s: list[float]              # every gap between a request's tokens in the window
    ttfts_s: list[float]             # send to first token, each request the window served first
    steps: list[Step]
    decode_time_s: float             # the program's timers, over the window
    decode_steps: int
    prefill_time_s: float
    prefill_passes: int
    counters: program.Counters       # the program's device counts, over the window
    trace: devtrace.Trace | None


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def load_reader(root: Path, name: str):
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def card() -> dict:
    """The card's name, power limit and memory, as nvidia-smi reads them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,memory.total",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    return {"nvidia_smi": out.stdout.strip().splitlines()[0] if out.stdout else out.stderr}


def pinned_copy_gb_s(device) -> float:
    """The benchmark's own pinned host-to-device copy of 1 GiB, best of 3."""
    n = 1 << 30
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(n, dtype=torch.uint8, device=device)
    best = float("inf")
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        dev.copy_(host, non_blocking=True)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / 1e3)
    del host, dev
    return n / best / 1e9


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, t_start: float,
             root: Path = ROOT, device="cuda",
             judged: str = "fp32", log=print) -> dict:
    """One run of `cell_name`; returns the result object (without
    ``device``'s card fields when `device` is not a card).  `judged` is
    "fp32", the served tokens, or "fp8", the control's (both readings are
    then in ``result["control"]``)."""
    bench = load_bench(root)
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    model = json.loads((root / config["file"]).read_text())["model"]
    mix = clients.load_mix(cell["traffic"], root / "bench" / "traffic")
    on_card = torch.device(device).type == "cuda"
    card_bytes = torch.cuda.get_device_properties(device).total_memory if on_card else None
    mix["engine"]["hbm_budget_bytes"] = clients.hbm_budget(mix, card_bytes)
    limits = judge.load_limits(cell_name, root / "bench" / "limits")
    wanted = cell_metrics(bench, cell_name, trace)
    readers = {m["name"]: load_reader(root, m["name"]) for m in wanted}
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # -- set-up: weights, engine, every slot filled, the graph captured ----
    cfg = program.model_config(config["name"], model)
    t_build = time.perf_counter()
    engine = program.build_engine(cfg, model, mix, seed, device)
    _sync(device)
    t_fill = time.perf_counter()
    loop = clients.ClosedLoop(clients.plan(mix, model["vocab"], seed), program.make_request,
                              engine.submit)
    loop.start()
    engine.step()
    _sync(device)
    loop.observe(0.0, 0)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    log(f"set-up {setup_s:.3f} s: start to engine {t_build - t_start:.3f} s, engine built "
        f"{t_fill - t_build:.3f} s, {len(loop.plans)} slots filled and the step captured "
        f"{t0 - t_fill:.3f} s; the engine's plan: {program.plan_summary(engine)}")
    for tr in loop.tracks():
        tr.stamps = [t0] * len(tr.stamps)
        tr.sent = max(tr.sent, t0)

    # -- the window -------------------------------------------------------
    stats0 = (engine.stats.decode_time, engine.stats.decode_steps,
              engine.stats.prefill_time, len(engine.stats.prefill_passes))
    counters0 = program.read_counters()
    experts = counters0.remote_experts
    steps: list[Step] = []
    tokens = 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    rf = torch.profiler.record_function
    with rf(devtrace.WINDOW):
        t_prev = t0
        while True:
            kv = program.kv_tiers(engine)
            with rf("engine.step"):
                engine.step()
            now = time.perf_counter()
            with rf("bench.bookkeeping"):
                n_tok, ctxs, prefills = loop.observe(now, len(steps) + 1)
                seen = program.remote_experts()
            tokens += n_tok
            steps.append(Step(now - t_prev, ctxs, prefills, kv[0], kv[1], seen - experts))
            experts, t_prev = seen, now
            if now - t0 >= seconds:
                break
        _sync(device)
    t1 = time.perf_counter()
    tr_red = None
    if prof is not None:
        prof.__exit__(None, None, None)
        t_red = time.perf_counter()
        tr_red = devtrace.reduce(devtrace.events_of(prof))
        del prof
        log(f"trace reduced in {time.perf_counter() - t_red:.3f} s"
            + (f": {tr_red.device_ops} device operations" if tr_red else ": no device time"))
    counters = program.read_counters() - counters0
    st = engine.stats
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    window_s = t1 - t0
    gaps = [b - a for tr in loop.tracks() for a, b in zip(tr.stamps, tr.stamps[1:])
            if b > t0]
    ttfts = [tr.stamps[0] - tr.sent for tr in loop.tracks() if tr.stamps and tr.stamps[0] > t0]
    r = Readings(model=model, mix=mix, setup_s=setup_s, window_s=window_s, tokens=tokens,
                 gaps_s=gaps, ttfts_s=ttfts, steps=steps,
                 decode_time_s=st.decode_time - stats0[0], decode_steps=st.decode_steps - stats0[1],
                 prefill_time_s=st.prefill_time - stats0[2],
                 prefill_passes=len(st.prefill_passes) - stats0[3],
                 counters=counters, trace=tr_red)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # -- what the run served, and whether it was right ---------------------
    tracks = loop.tracks()
    attempted = [t for t in tracks if any(s > t0 for s in t.stamps)]
    failed = sum(1 for t in attempted
                 if any(not 0 <= tok < model["vocab"] for tok in t.req.out_tokens)
                 or (t.req.t_done and len(t.req.out_tokens) != t.planned.budget))
    picked = judge.sample(attempted, seed)
    log(f"window: {len(steps)} steps in {window_s:.3f} s, {tokens} tokens, "
        f"{sum(len(s.prefills) for s in steps)} admissions, "
        f"{sum(len(s.ctxs) for s in steps)} decode rows; steps that admitted "
        f"{[round(s.seconds, 3) for s in steps if s.prefills]} s, the others' median "
        f"{np.median([s.seconds for s in steps if not s.prefills] or [0]):.3f} s; remote experts run a step "
        f"{np.mean([s.experts for s in steps if not s.prefills] or [0]):.2f}; "
        f"sample of {len(picked)} requests, {sum(len(t.req.out_tokens) for t in picked)} tokens")
    del engine, loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    extra = {}
    if trace and on_card:
        extra = {**card(), "pinned_copy_1GiB_GB_s": pinned_copy_gb_s(device)}
        if tr_red is not None:
            reading = devtrace.seconds_of(tr_red.kernels, "splitk_gemm", "grouped_cluster",
                                          "paged_attn")
            extra["link_read_GB_s"] = counters.host_bytes / max(reading, 1e-9) / 1e9
        log("card: " + json.dumps(extra))
    t_ref = time.perf_counter()
    precisions = ("fp32",) if judged == "fp32" else ("fp32", judged)
    gap = (judge.gaps(model, seed, picked, device, precisions) if picked
           else {p: np.zeros(0) for p in precisions})       # nothing served: not correct
    log(f"reference over {sum(len(t.planned.prompt) + len(t.req.out_tokens) for t in picked)} "
        f"tokens in {time.perf_counter() - t_ref:.3f} s")
    readings = {p: float(g.max()) if len(g) else float("inf") for p, g in gap.items()}
    log("reference: " + json.dumps({p: {"max": readings[p], "median": float(np.median(g)),
                                        "tokens": int(len(g)), "differ": int((g > 0).sum())}
                                    for p, g in gap.items()}))
    checks = {"logit_gap": {"value": readings[judged], "limit": limits["logit_gap"]["limit"]},
              "failed": {"value": failed, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": len(attempted), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else torch.device(device).type,
                         "kind": torch.cuda.get_device_name() if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and tr_red is not None:
        result["device"].update(busy_s=tr_red.busy_s, window_s=tr_red.window_s)
        result["breakdown"] = {"device_ops": devtrace.top(tr_red.kernels),
                               "idle_gaps": devtrace.top(tr_red.idle)}
    if judged != "fp32":
        result["control"] = {p: readings[p] for p in precisions}
    result["checks"] = checks
    return result
