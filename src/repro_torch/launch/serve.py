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
random, drawn from seed 0.  Every served family runs here: dense, MoE,
MLA, SSM (``--arch mamba2_370m``, which has no KV pages) and hybrid
(``--arch zamba2_2p7b``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    # built layer by layer: the unsplit model is never whole on the device
    engine = ServingEngine(
        cfg, M.layer_source(cfg, gen, dtype=_DTYPES[args.dtype], device=device),
        max_batch=args.max_batch, max_len=args.max_len,
        hbm_budget_bytes=args.hbm_gb * 1e9 if args.hbm_gb is not None else None,
        global_offload_ratio=None if args.hbm_gb is not None else args.offload_ratio,
        page_size=args.page_size, device=device)
    print(f"plan: global={engine.plan.global_ratio:.2f} "
          f"per-op={ {k: round(v, 2) for k, v in engine.plan.op_ratios.items()} } "
          f"window={engine.window} hw={engine.hw.name} device={device}")
    if args.hbm_gb is not None:
        print(f"budget: {args.hbm_gb:.1f} GB HBM vs "
              f"{engine.plan.footprint_bytes / 1e9:.1f} GB footprint")

    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        engine.submit(Request(
            rid=rid,
            prompt=rng.integers(3, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens))
    stats = engine.run()
    wall = time.time() - t0
    print(f"served {stats.served} requests in {wall:.2f}s | "
          f"decode steps {stats.decode_steps} | TPOT {stats.tpot*1e3:.1f} ms | "
          f"TTFT p50 {stats.ttft_p50*1e3:.1f} ms p95 {stats.ttft_p95*1e3:.1f} ms | "
          f"e2e p95 {stats.e2e_p95*1e3:.1f} ms | prefill {stats.prefill_time:.2f}s")
    if engine.pcache is not None:          # a pure SSM has no KV pages
        pp = engine.plan.kv_pages
        print(f"kv pages: size={pp.page_size} local={pp.local_pages} "
              f"remote={pp.remote_pages} | peak local={stats.local_pages_hwm} "
              f"peak remote={stats.remote_pages_hwm} spills={stats.spills}")
    return {"served": stats.served, "wall_s": wall,
            "generated_tokens": stats.generated_tokens,
            "tokens_per_s": stats.generated_tokens / wall if wall > 0 else 0.0,
            "tpot_ms": stats.tpot * 1e3, "ttft_p50_ms": stats.ttft_p50 * 1e3}


if __name__ == "__main__":
    main()
