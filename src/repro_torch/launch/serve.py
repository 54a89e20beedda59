"""Serving entry point: batched requests through the port's DAK tiered engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama2_7b \\
      --requests 8 --prompt-len 128 --new-tokens 32 --max-len 160 \\
      --offload-ratio 0.5 --page-size 16 --dtype bfloat16

Runs on the CUDA device by default; ``--device cpu`` runs the plain
PyTorch path (use ``--smoke`` there).  The engine is built one layer at a
time, so HBM holds only the local tier: ``--arch opt_30b --offload-ratio
0.5 --dtype bfloat16`` serves all 48 layers of OPT-30B on one 80 GB card.  Two planning modes, as in the
reference's serve command: ``--offload-ratio R`` pins the global offload ratio,
``--hbm-gb G`` derives it from an HBM budget.  Weights and prompts are
random, drawn from seed 0.  Every decoder family runs here: dense, VLM
(``--arch llava_next_34b``, text prompts), MoE, MLA, SSM (``--arch
mamba2_370m``, which has no KV pages) and hybrid (``--arch zamba2_2p7b``);
the encoder (``--arch hubert_xlarge``) has no decode step and exits with
that reason (its entry point is `launch.steps.make_prefill_step`).

The serving frontend takes the reference's knobs: ``--scheduler
{fcfs,priority,slo}`` picks the admission policy (the SLO scheduler
chunks prefill and preempts by tier demotion), ``--prefill-chunk N`` caps
the prompt tokens prefilled per step, and the workload is either
``--trace PATH`` (replay a `frontend.workload` trace) or ``--arrival-rate
R`` (Poisson arrivals with the default tenant classes; ``--slo-ttft-ms``
overrides the interactive class's SLO).  Both trace modes run on the
modeled clock, so TTFT, queue delay and SLO figures are functions of the
schedule, not of host time.  ``--tokens-out PATH`` writes every request's
tokens as JSON.

``--adaptive`` attaches the adaptive runtime (AIMD window control on the
analytical source, phase-aware re-planning, live page migration) and
prints its ``runtime:`` summary; ``--hbm-shrink STEP:FRAC`` shrinks the
local page budget to FRAC of the pool at decode step STEP, which the
engine must absorb (demote, grow the host pool, re-plan with
``--adaptive``) with no failed request.

Every decode step runs as a captured CUDA graph (one per window bucket and
pool shape) unless ``--no-jit`` asks for the eager step.
``--check-invariants`` audits the page table after every engine step
(DAK301-305, `repro_torch.analysis`) and aborts on the first
inconsistency.  Observability as in the reference:
``--trace-out PATH`` writes a Chrome trace of the run, ``--metrics-out
PATH`` the Prometheus text of its metrics registry (``--metrics-interval
N`` rewrites it every N steps), ``--attribution`` attaches the bandwidth
attribution profiler, and ``--flight-dir DIR`` the flight recorder
(``--flight-slo-breach-ms`` dumps a bundle at the first TTFT over it).

The measurement surface is the reference's: ``--bench-json PATH`` writes
the run's machine-readable report (`bench_report`: tokens/s, TPOT, TTFT
and queue percentiles, KV pages, the window, compile and elastic counters,
``schema_version`` and a ``provenance`` stamp naming ``torch``; with
``--adaptive`` it defaults to ``BENCH_serving.json``), and `main` returns
that report.  ``--no-kernels`` serves the untiered model through the
reference path (`ServingEngine(use_kernels=False)`: no tier, no kernel,
no graph, eager plain PyTorch), the oracle whose tokens the kernel path
must emit; the all-HBM comparison is the main path at
``--offload-ratio 0`` (the same engine and graphs; nothing is tiered, so
its products are plain).
``--autotune`` sweeps the kernels' knobs per shape under the EB cost
model and runs the lint-validated winners (`kernels.autotune`);
``--autotune-cache PATH`` loads a table first if it exists (its winners
reproduce bit for bit; without ``--autotune`` unseen shapes keep the
kernels' own choices) and, with ``--autotune``, rewrites it after the run.

``--mesh-devices P`` serves one replica across P ranks (`launch.mesh`, the
reference's fetch-once mesh): each rank pins 1/P of the remote tier and
every step's all-gather rebuilds it whole.  ``--mesh-backend`` picks the
``torch.distributed`` backend, and nothing falls back: ``nccl`` (the
default on the card) needs a card per rank, ``gloo`` (the default on the
CPU) also serves ranks that share one card.  Run as is, the command spawns
its own P ranks (`launch.mesh.run_ranks`, meeting through a file store in
a temporary directory); under ``torchrun --nproc-per-node P`` each process
is one rank and joins from the environment.  Every rank serves the same
requests; rank 0 prints, with the plan line ``mesh: P host links x ...``,
each rank's counted host-link bytes and peak device memory, and writes
``--bench-json`` (with the reference's ``mesh_shape`` and
``mesh_traffic`` fields).  Without the flag there is no mesh.  NCCL with
P > 1 across cards is written but has not been run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.frontend.metrics import ModeledClock
from repro_torch.frontend.scheduler import scheduler_names
from repro_torch.frontend.workload import DEFAULT_CLASSES, Trace, poisson_trace
from repro_torch.kernels.autotune import Autotuner
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.obs.attribution import AttributionProfiler
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import BENCH_SCHEMA_VERSION, provenance, serving_registry
from repro_torch.obs.trace import ChromeTraceRecorder
from repro_torch.serving.engine import Request, ServingEngine, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _write_atomic(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a same-directory temporary file
    and ``os.replace``, so a reader never sees a torn file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        fh.write(text)
    os.replace(tmp, path)


def _bench_registry(args, engine: ServingEngine, stats, wall: float):
    """The metrics registry behind one serving run's report (the single
    producer of the report's stats and of the Prometheus exposition)."""
    return serving_registry(engine, stats, wall, meta={
        "arch": args.arch, "smoke": bool(args.smoke), "adaptive": bool(args.adaptive),
        "trace": args.trace or ("poisson" if getattr(args, "arrival_rate", None) else None),
        "requests": args.requests})


def bench_report(args, engine: ServingEngine, stats, wall: float, reg=None) -> dict:
    """The BENCH_serving.json schema, one flat dict per serving run, as the
    reference's: the registry's nested view, then ``schema_version`` and
    the ``provenance`` stamp (git revision, config, clock, ``torch``
    version) that lets a comparison refuse cross-schema or cross-config
    pairs."""
    if reg is None:
        reg = _bench_registry(args, engine, stats, wall)
    report = reg.nested()
    report["schema_version"] = BENCH_SCHEMA_VERSION
    report["provenance"] = provenance(engine, arch=args.arch)
    return report


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2_7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--offload-ratio", type=float, default=0.4,
                    help="pinned global offload ratio (ignored with --hbm-gb)")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="HBM budget in GB: plan the global ratio from the "
                         "model footprint (paper Fig. 10 mode)")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--no-kernels", action="store_true",
                    help="serve the untiered model through the reference path (no tier, no "
                         "kernel, no graph): the oracle the kernel path's tokens must equal")
    ap.add_argument("--bench-json", default=None, metavar="PATH",
                    help="write the machine-readable benchmark report here (default "
                         "BENCH_serving.json with --adaptive)")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep the kernels' knobs per (op, shape, dtype, offload ratio, hw) "
                         "under the EB cost model and run the lint-validated winners "
                         "(kernels.autotune)")
    ap.add_argument("--autotune-cache", default=None, metavar="PATH",
                    help="JSON autotune table: loaded before the run if it exists (winners "
                         "reproduce bit for bit; without --autotune unseen shapes keep the "
                         "kernels' own choices), rewritten after the run with --autotune")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh-devices", type=int, default=None, metavar="P",
                    help="serve one replica across P ranks, each with its own host link: "
                         "the remote tier shards 1/P per rank and every step rebuilds it "
                         "fetch-once with one all-gather (spawns the ranks, or joins under "
                         "torchrun)")
    ap.add_argument("--mesh-backend", default=None, choices=mesh_mod.BACKENDS,
                    help="torch.distributed backend of the mesh: nccl (default on the card; "
                         "one card per rank) or gloo (default on the CPU; ranks may share "
                         "one card)")
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--scheduler", default="fcfs", choices=sorted(scheduler_names()),
                    help="serving frontend policy: fcfs (whole-prompt admission order), "
                         "priority, or slo (earliest deadline first + chunked prefill + "
                         "tier-demotion preemption)")
    ap.add_argument("--prefill-chunk", type=int, default=None, metavar="N",
                    help="chunked prefill: at most N prompt tokens per step (default: the "
                         "scheduler's own budget; fcfs = whole prompts)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="replay a workload trace (frontend.workload JSON) on the modeled "
                         "clock; overrides --requests/--prompt-len/--new-tokens")
    ap.add_argument("--arrival-rate", type=float, default=None, metavar="RPS",
                    help="synthesize a Poisson trace at this rate (modeled seconds) with "
                         "the default tenant classes instead of submitting all at t=0")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="override the interactive class's TTFT SLO for synthesized traces "
                         "(ms, modeled clock)")
    ap.add_argument("--tokens-out", default=None, metavar="PATH",
                    help="write every request's emitted tokens as JSON {rid: [tokens]}")
    ap.add_argument("--adaptive", action="store_true",
                    help="attach the adaptive runtime (AIMD window control, phase-aware "
                         "re-planning, live page migration)")
    ap.add_argument("--hbm-shrink", default=None, metavar="STEP:FRAC",
                    help="chaos event: at decode step STEP, shrink the modeled HBM page budget "
                         "to FRAC of the local pool (e.g. 6:0.3).  The engine must degrade "
                         "(demote, re-plan to a higher offload ratio, shed admissions) and "
                         "finish with zero failed requests")
    ap.add_argument("--no-jit", action="store_true",
                    help="run every decode step eagerly instead of replaying one captured "
                         "CUDA graph per window bucket and pool shape")
    ap.add_argument("--check-invariants", action="store_true",
                    help="audit the paged cache's page-table invariants (repro_torch.analysis, "
                         "DAK301-305) after every engine step; aborts on the first "
                         "inconsistency.  Read-only host bookkeeping: tokens and stats are "
                         "unchanged")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run (per-step phase spans, "
                         "per-request lifecycle tracks, per-link counter tracks)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition of the run's metrics registry")
    ap.add_argument("--metrics-interval", type=int, default=0, metavar="N",
                    help="with --metrics-out: also rewrite the file every N engine steps "
                         "(atomic rename); 0 = end of run only")
    ap.add_argument("--attribution", action="store_true",
                    help="attach the bandwidth-attribution profiler: per-step time ledger, "
                         "bottleneck labels, achieved-vs-optimal aggregate bandwidth")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="attach the flight recorder: a ring of per-step state snapshots, "
                         "dumped as a post-mortem bundle here on an error or an SLO breach")
    ap.add_argument("--flight-slo-breach-ms", type=float, default=None,
                    help="with --flight-dir: dump a bundle the first time a request's TTFT "
                         "exceeds this (engine-clock ms)")
    args = ap.parse_args(argv)
    shrink = None
    if args.hbm_shrink:
        try:
            step_s, frac_s = args.hbm_shrink.split(":")
            shrink = (int(step_s), float(frac_s))
        except ValueError:
            raise SystemExit(f"--hbm-shrink expects STEP:FRAC (e.g. 6:0.3), "
                             f"got {args.hbm_shrink!r}") from None
    if args.bench_json is None and args.adaptive:
        args.bench_json = "BENCH_serving.json"
    args.shrink = shrink
    args.save_autotune = bool(args.autotune and args.autotune_cache)
    if args.mesh_devices is None:
        return _serve(args, None)
    if args.mesh_devices < 1:
        raise SystemExit(f"--mesh-devices takes P >= 1, got {args.mesh_devices}")
    if args.mesh_backend is None:
        args.mesh_backend = "gloo" if torch.device(args.device).type == "cpu" else "nccl"
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return _serve_rank(args)
    mesh_mod.check_backend(args.mesh_backend, args.mesh_devices)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        mesh_mod.run_ranks(_spawned_rank, args.mesh_devices, backend=args.mesh_backend,
                           init_method=f"file://{os.path.join(tmp, 'store')}",
                           args=(argv, out))
        with open(out) as fh:
            return json.load(fh)


def _spawned_rank(rank: int, argv: list[str] | None, out: str) -> None:
    """One rank `run_ranks` spawned: serve, and rank 0 hands its report back."""
    report = main(argv)
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(report, fh, default=float)


# what only rank 0 of a mesh writes (the other ranks serve the same requests
# and load the same autotune table, but do not rewrite it)
_RANK0_OUTPUTS = ("bench_json", "tokens_out", "trace_out", "metrics_out", "flight_dir")


def _serve_rank(args) -> dict:
    """Serve as one rank of the mesh: join the process group (from the
    environment under torchrun, unless the caller already has), build the
    mesh, serve; ranks other than 0 print and write nothing."""
    joined = not dist.is_initialized()
    if joined:
        mesh_mod.init_rank(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                           backend=args.mesh_backend, init_method="env://")
    try:
        if dist.get_backend() != args.mesh_backend:
            raise SystemExit(f"--mesh-backend {args.mesh_backend}, but the process group "
                             f"runs {dist.get_backend()}")
        mesh = mesh_mod.make_dev_mesh(1, args.mesh_devices)
        if dist.get_rank() == 0:
            return _serve(args, mesh)
        quiet = argparse.Namespace(**{**vars(args), **dict.fromkeys(_RANK0_OUTPUTS),
                                      "save_autotune": False})
        with contextlib.redirect_stdout(io.StringIO()):
            return _serve(quiet, mesh)
    finally:
        if joined:
            dist.destroy_process_group()


def _serve(args, mesh) -> dict:
    """One serving run (on this rank of `mesh`, when given)."""
    shrink = args.shrink
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    try:
        M.require_served(cfg)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    device = resolve_device(args.device)
    if mesh is not None:
        device = mesh_mod.rank_device(mesh.backend, device)
    trace = None
    if args.trace:
        trace = Trace.load(args.trace)
    elif args.arrival_rate:
        classes = DEFAULT_CLASSES
        if args.slo_ttft_ms is not None:
            classes = tuple(dataclasses.replace(c, slo_ttft_s=args.slo_ttft_ms / 1e3)
                            if c.slo_ttft_s is not None else c for c in classes)
        trace = poisson_trace(
            args.requests, rate_rps=args.arrival_rate, classes=classes,
            prompt_max=max(4, args.max_len - args.new_tokens - 2),
            out_max=args.new_tokens, seed=0)
    recorder = None
    if args.trace_out:
        recorder = ChromeTraceRecorder(metadata={
            "arch": args.arch, "scheduler": args.scheduler,
            "clock": "modeled" if trace is not None else "wall"})
    flight = None
    if args.flight_dir:
        flight = FlightRecorder(
            args.flight_dir,
            slo_breach_s=(args.flight_slo_breach_ms / 1e3
                          if args.flight_slo_breach_ms is not None else None))
    tuner = None
    if args.autotune or args.autotune_cache:
        if args.autotune_cache and os.path.exists(args.autotune_cache):
            tuner = Autotuner.load(args.autotune_cache, sweep=args.autotune)
            print(f"autotune: loaded {len(tuner.table)} entries "
                  f"from {args.autotune_cache} (hw={tuner.hw.name})")
        else:
            tuner = Autotuner(sweep=args.autotune)
    profiler = AttributionProfiler() if args.attribution else None
    gen = torch.Generator(device=device).manual_seed(0)
    dtype = _DTYPES[args.dtype]
    # Tiered, the engine is built layer by layer: the unsplit model is never
    # whole on the device.  The untiered reference path keeps the whole tree
    # there (the same draws: `init_params` stacks `layer_source`'s layers).
    params = (M.init_params(cfg, gen, dtype=dtype, device=device) if args.no_kernels
              else M.layer_source(cfg, gen, dtype=dtype, device=device))
    engine = ServingEngine(
        cfg, params, max_batch=args.max_batch, max_len=args.max_len,
        hbm_budget_bytes=args.hbm_gb * 1e9 if args.hbm_gb is not None else None,
        global_offload_ratio=None if args.hbm_gb is not None else args.offload_ratio,
        use_kernels=not args.no_kernels, page_size=args.page_size, scheduler=args.scheduler,
        prefill_chunk=args.prefill_chunk, adaptive=args.adaptive,
        clock=ModeledClock() if trace is not None else None, recorder=recorder,
        flight=flight, profiler=profiler, jit_step=not args.no_jit,
        check_invariants=args.check_invariants, tuner=tuner, device=device, mesh=mesh)
    del params
    if shrink is not None:
        engine.schedule_hbm_shrink(*shrink)
        print(f"chaos: HBM shrink to {shrink[1]:.0%} of the local pool "
              f"at decode step {shrink[0]}")
    print(f"plan: global={engine.plan.global_ratio:.2f} "
          f"per-op={ {k: round(v, 2) for k, v in engine.plan.op_ratios.items()} } "
          f"window={engine.window} tiered={engine.tiered} hw={engine.hw.name} "
          f"device={device} jit={engine.graphed} adaptive={args.adaptive} "
          f"mesh={engine.mesh_shape}")
    if engine.plan.mesh is not None:
        mp = engine.plan.mesh
        print(f"mesh: {mp.n_devices} host links x {mp.host_link_bw / 1e9:.0f} GB/s -> "
              f"aggregate {mp.aggregate_host_bw / 1e9:.0f} GB/s | per-link fetch-once "
              f"{mp.per_link_bytes_multicast / 1e6:.1f} MB vs naive "
              f"{mp.per_link_bytes_naive / 1e6:.1f} MB | backend {mesh.backend}")
    if args.hbm_gb is not None:
        print(f"budget: {args.hbm_gb:.1f} GB HBM vs "
              f"{engine.plan.footprint_bytes / 1e9:.1f} GB footprint")

    rng = np.random.default_rng(0)
    t0 = time.time()
    if trace is not None:
        print(f"trace: {trace.description or args.trace} ({len(trace.entries)} requests) | "
              f"scheduler {args.scheduler} chunk {engine.scheduler.chunk_tokens}")
        submitted = trace.to_requests(cfg.vocab)
    else:
        submitted = [Request(rid=rid,
                             prompt=rng.integers(3, cfg.vocab, args.prompt_len).astype(np.int32),
                             max_new_tokens=args.new_tokens)
                     for rid in range(args.requests)]
    for req in submitted:
        engine.submit(req)
    step_hook = None
    if args.metrics_out and args.metrics_interval > 0:
        def step_hook(steps: int) -> None:
            if steps % args.metrics_interval == 0:
                _write_atomic(args.metrics_out, _bench_registry(
                    args, engine, engine.stats, time.time() - t0).to_prometheus())

    stats = engine.run(step_hook=step_hook)
    wall = time.time() - t0
    print(f"served {stats.served} requests in {wall:.2f}s | "
          f"decode steps {stats.decode_steps} | TPOT {stats.tpot*1e3:.1f} ms | "
          f"TTFT p50 {stats.ttft_p50*1e3:.1f} ms p95 {stats.ttft_p95*1e3:.1f} ms | "
          f"queue p95 {stats.queue_delay_p95*1e3:.1f} ms | "
          f"e2e p95 {stats.e2e_p95*1e3:.1f} ms | prefill {stats.prefill_time:.2f}s")
    if stats.prefill_chunks or stats.preemptions:
        print(f"frontend: prefill chunks {stats.prefill_chunks} | "
              f"preemptions {stats.preemptions} "
              f"({stats.preempt_demoted_pages} pages demoted)")
    if engine.health.counters.events:
        print(f"elastic: health {stats.health} | failed requests {stats.failed_requests} | "
              f"CacheFull caught {stats.cache_full_caught} | demoted "
              f"{stats.elastic_demoted_pages} pages | remote grown {stats.remote_grown_pages} "
              f"pages | shed steps {stats.shed_steps} | elastic replans "
              f"{stats.elastic_replans}")
    slo = stats.slo_report()
    if trace is not None and slo:
        for cls, rep in slo.items():
            att = "n/a" if rep["attainment"] is None else f"{rep['attainment']*100:.0f}%"
            print(f"  class {cls}: n={rep['requests']} slo={att} "
                  f"ttft p95 {rep['ttft_p95']*1e3:.1f} ms | "
                  f"queue p95 {rep['queue_delay_p95']*1e3:.1f} ms | "
                  f"preemptions {rep['preemptions']}")
    if engine.pcache is not None:          # a pure SSM has no KV pages
        pp = engine.plan.kv_pages
        print(f"kv pages: size={pp.page_size} local={pp.local_pages} "
              f"remote={pp.remote_pages} | peak local={stats.local_pages_hwm} "
              f"peak remote={stats.remote_pages_hwm} spills={stats.spills}")
    if engine.runtime is not None:
        rt = engine.runtime.report()
        w, mig, mod = rt["window"], rt["migration"], rt["modeled"]
        print(f"runtime: window {w['static']}->{w['final']} "
              f"(converged={w['converged']}) | replans {rt['replans']} | "
              f"pages promoted {mig['promoted']} demoted {mig['demoted']} | "
              f"modeled tokens/s static {mod['static_tokens_per_s']:.3g} "
              f"adaptive {mod['adaptive_tokens_per_s']:.3g} "
              f"(gain {mod['gain']:.3f})")
    if engine.graphed:
        print(f"compiled step: {engine.compile_count} buckets | cache hits "
              f"{engine.compile_cache_hits} | recaptures {engine.recaptures}")
    if mesh is not None:
        _print_mesh_ranks(mesh, device)
    if profiler is not None:
        prep = profiler.report()
        btl = prep["bottleneck"]
        fr = btl["optimal_fraction"]
        labels = ", ".join(f"{k} {v}" for k, v in btl["labels"].items() if v)
        print(f"attribution: {prep['steps']} steps | labels: {labels or 'none'}"
              f" | transitions {btl['transitions']} | bw optimality "
              f"mean {fr['mean']:.3f} max {fr['max']:.3f}")
    reg = _bench_registry(args, engine, stats, wall)
    report = bench_report(args, engine, stats, wall, reg=reg)
    if args.bench_json:
        with open(args.bench_json, "w") as fh:
            json.dump(report, fh, indent=2, default=float)
        print(f"wrote {args.bench_json}")
    if args.trace_out:
        recorder.save(args.trace_out)
        print(f"wrote {args.trace_out} ({len(recorder.events)} trace events)")
    if args.metrics_out:
        _write_atomic(args.metrics_out, reg.to_prometheus())
        print(f"wrote {args.metrics_out}")
    if args.tokens_out:
        with open(args.tokens_out, "w") as fh:
            json.dump({str(r.rid): list(r.out_tokens) for r in submitted}, fh, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.tokens_out}")
    if tuner is not None:
        print(f"autotune: {tuner.counters()}")
        if args.save_autotune:
            tuner.save(args.autotune_cache)
            print(f"wrote {args.autotune_cache} ({len(tuner.table)} entries)")
    if flight is not None and flight.dumped:
        print(f"flight bundles: {', '.join(flight.dumped)}")
    return report


def _print_mesh_ranks(mesh, device: torch.device) -> None:
    """Each rank's counted host-link bytes and peak device memory, gathered
    to every rank and printed (by rank 0)."""
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    mine = {"weights": mesh.link_bytes["weights"], "kv": mesh.link_bytes["kv"],
            "fetches": mesh.fetches, "peak": peak}
    every: list[dict] = [{}] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    for rank, r in enumerate(every):
        print(f"mesh rank {rank}: host link {r['weights'] / 1e6:.3f} MB weights over "
              f"{r['fetches']} fetches + {r['kv'] / 1e6:.3f} MB kv | peak device memory "
              f"{r['peak'] / 1e9:.3f} GB")


if __name__ == "__main__":
    main()
