"""Fault-tolerant training driver.

Counterpart of ``src/repro/launch/train.py``: synthetic pipeline -> train
step (remat, microbatches, AdamW) -> async checkpointing ->
restart-on-failure -> straggler monitoring, in one process on one device:
the card by default (it raises without one), the CPU only when asked with
``--device cpu``.  The reference's driver also builds a dev mesh whose
param specs it never applies; this one has none (the specs are
`launch.sharding.param_specs`, the mesh step `steps.make_dp_train_step_compressed`).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2_3b --smoke \\
      --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 4 \\
      --batch 2 --seq 32 --fail-at 2 --ckpt-dir DIR   # exercises the restart path
"""
from __future__ import annotations

import argparse
import math
import tempfile
import time
from pathlib import Path

import torch

import repro_torch.configs as C
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.distributed.fault import FaultInjector, RestartLoop, StragglerDetector
from repro_torch.launch import steps as S
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.serving.engine import resolve_device
from repro_torch.tree import leaves

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (tests restart)")
    ap.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    return run(C.get_smoke(args.arch) if args.smoke else C.get(args.arch), args)


def run(cfg: ModelConfig, args: argparse.Namespace) -> dict:
    """Train `cfg` as `args` say.  Returns the reference's dict (``losses``,
    ``restarts``, ``final_step``) and ``state`` (the final params and
    optimizer state), ``saves`` (each save's `SaveResult`) and
    ``restores`` (each restore's step, seconds and bytes)."""
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or str(
        Path(tempfile.gettempdir()) / f"repro_torch_ckpt_{args.arch}"
                                      f"{'_smoke' if args.smoke else ''}")
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    dtype = _DTYPES[args.dtype]

    pipe = SyntheticPipeline(cfg, shape)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0), dtype=dtype,
                           device=device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=5, total_steps=max(10, args.steps))
    opt_state = adamw.init(params)
    train_step = S.make_train_step(cfg, opt_cfg, num_microbatches=args.microbatches)

    ckpt = CheckpointManager(ckpt_dir, keep_last=2)
    injector = FaultInjector({args.fail_at} if args.fail_at >= 0 else None)
    straggler = StragglerDetector()
    losses: list[float] = []
    saves: list = []
    restores: list[dict] = []
    state = {"params": params, "opt": opt_state}

    def finish_save() -> None:
        """Wait for the save in flight, if any, and keep its result."""
        ckpt.wait()
        res = ckpt.last_result
        if res is not None and (not saves or saves[-1] is not res):
            saves.append(res)

    def restore_latest() -> int:
        nonlocal state
        finish_save()
        latest = ckpt.latest_step()
        if latest is None:
            return 0
        t0 = time.time()
        tree, extra = ckpt.restore(latest, like=state)
        if device.type == "cuda":
            torch.cuda.synchronize()
        state = tree
        restores.append({"step": latest, "seconds": time.time() - t0,
                         "bytes": sum(t.numel() * t.element_size()
                                      for t in leaves(tree))})
        pipe.restore(extra.get("pipeline", {"step": latest}))
        print(f"[restore] resumed from step {latest}")
        return latest

    start = restore_latest() if args.restore else 0

    def body(start_step: int) -> int:
        step = start_step
        while step < args.steps:
            injector.maybe_fail(step)
            batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}
            t0 = time.time()
            loss, state["params"], state["opt"], gnorm = train_step(
                state["params"], state["opt"], batch)
            loss = float(loss)
            dt = time.time() - t0
            if straggler.observe(dt):
                print(f"[straggler] step {step} took {dt:.3f}s")
            losses.append(loss)
            if step % args.log_every == 0:
                tok_s = args.batch * args.seq / max(dt, 1e-9)
                print(f"step {step:5d} loss {loss:8.4f} gnorm {float(gnorm):7.3f} "
                      f"{dt*1e3:7.1f} ms  {tok_s/1e3:8.1f} ktok/s")
            step += 1
            if step % args.ckpt_every == 0 or step == args.steps:
                finish_save()
                ckpt.save_async(step, state, extra={"pipeline": pipe.snapshot()})
        finish_save()
        return step

    loop = RestartLoop(max_restarts=3)
    final = loop.run(body, start, on_restart=restore_latest)
    if not all(math.isfinite(v) for v in losses):
        raise FloatingPointError("non-finite loss")
    print(f"done: {final} steps, restarts={loop.restarts}, "
          f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return {"losses": losses, "restarts": loop.restarts, "final_step": final,
            "state": state, "saves": saves, "restores": restores}


if __name__ == "__main__":
    main()
