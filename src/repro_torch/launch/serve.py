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
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.frontend.metrics import ModeledClock
from repro_torch.frontend.scheduler import scheduler_names
from repro_torch.frontend.workload import DEFAULT_CLASSES, Trace, poisson_trace
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
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
    args = ap.parse_args(argv)

    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    try:
        M.require_served(cfg)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    device = resolve_device(args.device)
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
    gen = torch.Generator(device=device).manual_seed(0)
    # built layer by layer: the unsplit model is never whole on the device
    engine = ServingEngine(
        cfg, M.layer_source(cfg, gen, dtype=_DTYPES[args.dtype], device=device),
        max_batch=args.max_batch, max_len=args.max_len,
        hbm_budget_bytes=args.hbm_gb * 1e9 if args.hbm_gb is not None else None,
        global_offload_ratio=None if args.hbm_gb is not None else args.offload_ratio,
        page_size=args.page_size, scheduler=args.scheduler,
        prefill_chunk=args.prefill_chunk,
        clock=ModeledClock() if trace is not None else None, device=device)
    print(f"plan: global={engine.plan.global_ratio:.2f} "
          f"per-op={ {k: round(v, 2) for k, v in engine.plan.op_ratios.items()} } "
          f"window={engine.window} hw={engine.hw.name} device={device}")
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
    stats = engine.run()
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
    if args.tokens_out:
        with open(args.tokens_out, "w") as fh:
            json.dump({str(r.rid): list(r.out_tokens) for r in submitted}, fh, sort_keys=True)
            fh.write("\n")
        print(f"wrote {args.tokens_out}")
    return {"served": stats.served, "wall_s": wall,
            "generated_tokens": stats.generated_tokens,
            "tokens_per_s": stats.generated_tokens / wall if wall > 0 else 0.0,
            "tpot_ms": stats.tpot * 1e3, "ttft_p50_ms": stats.ttft_p50 * 1e3,
            "prefill_chunks": stats.prefill_chunks, "preemptions": stats.preemptions,
            "slo": slo}


if __name__ == "__main__":
    main()
