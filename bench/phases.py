"""Where a traced cell's device idle falls among the program's `dak.*`
regions, read from the profiler's raw events.

    python3 bench/phases.py --workload opt30b.code --seed N --seconds 51 \
        [--root DIR] [--out FILE]

Runs one traced run of the cell as ``bench/run.py --trace 1`` does, from
the checkout at ``--root`` (this one by default), keeps the events the
profiler recorded, and prints one JSON line: the run's metrics and
`analyse`'s reading of its window (the harness's log goes to standard
error).  ``--out`` also writes the whole result, the reading's top idle
labels, the ledger's step records and `region_cost_us`.  A program
without the regions reads every idle second as outside them.  Not part of
any measured run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROMPT_WRITE = "dak.prompt_write"
INDEX_PUT = "aten::_index_put_impl_"
HOST_WALK = 20000            # host events searched back for one that holds a gap


def analyse(events, devtrace) -> dict:
    """The window's device idle by its innermost `dak.*` region, the share
    of the idle inside ``engine.step`` that lies outside every region, the
    pageable device-to-host copies and the ``_index_put_impl_`` idle inside
    `PROMPT_WRITE`, the regions the trace shows on the device, and host
    syncs per step.  Regions are searched in full, other host events
    `HOST_WALK` back.  Empty without the benchmark's window."""
    win = [e for e in events if e.name == devtrace.WINDOW and not e.on_device]
    if not win:
        return {}
    w0, w1 = win[0].start, win[0].end
    dev, dtoh, host, dak, steps = [], [], [], [], []
    on_device, syncs = defaultdict(int), defaultdict(int)
    for e in events:
        a, b = max(e.start, w0), min(e.end, w1)
        if e.on_device and e.name.startswith("dak."):
            on_device["annotation" if e.annotation else "operation"] += 1
        if e.on_device and not e.annotation and e.name not in devtrace.HOST_RANGES \
                and e.name != devtrace.WINDOW:
            if b > a:
                dev.append((a, b))
                if "DtoH" in e.name and "Pageable" in e.name:
                    dtoh.append((a, b))
        elif e.on_device or b <= a or e.name == devtrace.WINDOW:
            continue
        elif e.name.startswith("dak."):
            dak.append((e.start, e.end, e.name))
        elif e.name == "engine.step":
            steps.append((e.start, e.end, e.name))
        elif e.name not in devtrace.HOST_RANGES:
            host.append((e.start, e.end, e.name))
            if "Synchronize" in e.name:
                syncs[e.name] += 1
    for spans in (dev, host, dak, steps):
        spans.sort()
    busy, gaps = devtrace._union(dev)
    if dev:
        gaps = [(w0, dev[0][0])] + gaps + [(max(b for _, b in dev), w1)]
    writes = [d for d in dak if d[2] == PROMPT_WRITE]
    starts = {id(s): [x[0] for x in s] for s in (host, dak, steps, writes)}

    def inside(mid, spans, walk=None):
        return devtrace._innermost(mid, spans, starts[id(spans)],
                                   len(spans) if walk is None else walk)

    idle_step = idle_out = idle_ip = idle_ip_in = 0.0
    by_phase, by_label = defaultdict(float), defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid, g = (a + b) / 2, (b - a) / 1e6
        step, phase, inner = inside(mid, steps), inside(mid, dak), inside(mid, host, HOST_WALK)
        if b - a >= devtrace.SHORT_GAP_US:
            by_label[f"{step or '-'} > {inner or '-'}"] += g
        if step:
            idle_step += g
            by_phase[phase or "engine.step outside dak.*"] += g
            idle_out += g if phase is None else 0.0
        else:
            by_phase["outside engine.step"] += g
        if inner == INDEX_PUT:
            idle_ip += g
            idle_ip_in += g if inside(mid, writes) else 0.0
    dtoh_in = [(a, b) for a, b in dtoh if inside((a + b) / 2, writes)]
    n = max(len(steps), 1)
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6, "steps": len(steps),
            "idle_engine_step_s": idle_step, "idle_outside_dak_s": idle_out,
            "idle_outside_dak_share": idle_out / idle_step if idle_step else None,
            "index_put_idle_s": idle_ip, "index_put_idle_in_prompt_write_s": idle_ip_in,
            "dtoh_pageable_s": sum(b - a for a, b in dtoh) / 1e6,
            "dtoh_in_prompt_write_s": sum(b - a for a, b in dtoh_in) / 1e6,
            "dak_on_device": dict(on_device), "dak_ranges": len(dak),
            "syncs_per_step": {k: v / n for k, v in syncs.items()},
            "idle_by_phase": devtrace.top(by_phase, 16),
            "idle_by_label": devtrace.top(by_label, 16)}


def region_cost_us(n: int = 200000) -> float | None:
    """Microseconds of one region with only its ledger on (no profiler, no
    recorder); None for a program without regions."""
    from repro_torch.obs import trace

    if not hasattr(trace, "region"):
        return None
    with trace.recording(trace.PhaseLedger()):
        t0 = time.perf_counter()
        for _ in range(n):
            with trace.region("dak.fetch"):
                pass
        return (time.perf_counter() - t0) / n * 1e6


def ledger_steps() -> list[dict] | None:
    """The newest ledger's step records as plain dicts."""
    from repro_torch.obs import trace

    ledger = trace.latest_ledger() if hasattr(trace, "latest_ledger") else None
    if ledger is None:
        return None
    return [{"index": s.index, "s": s.t1 - s.t0, "seconds": s.seconds,
             "passes": [vars(p) for p in s.passes]} for s in ledger.steps]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    root = args.root.resolve()
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(root / "build" / "bench-cache" / sub)
    sys.path[:0] = [str(root / "src"), str(root)]
    from bench import devtrace, harness

    kept = {}
    events_of = devtrace.events_of

    def keep(prof):                 # the harness reduces the events; keep them too
        kept["events"] = events_of(prof)
        return kept["events"]

    devtrace.events_of = keep
    try:
        res = harness.run_cell(args.workload, args.seed, args.seconds, True, T_START,
                               root=root, device=args.device,
                               log=lambda line: print(line, file=sys.stderr))
    finally:
        devtrace.events_of = events_of
    phases = analyse(kept.pop("events", []), devtrace)
    if args.out is not None:
        steps = ledger_steps()      # before `region_cost_us` makes its own ledger the newest
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"root": str(root), "seed": args.seed, "result": res,
                                        "phases": phases, "ledger": steps,
                                        "region_cost_us": region_cost_us()}, default=float))
    print(json.dumps({"root": str(root), "seed": args.seed, "correct": res["correct"],
                      "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                      "phases": {k: v for k, v in phases.items() if k != "idle_by_label"}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
