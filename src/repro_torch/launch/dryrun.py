"""Multi-pod dry run: trace every (arch x shape x mesh) cell.

Counterpart of ``src/repro/launch/dryrun.py``.  The reference lowers and
compiles each cell's train, prefill or decode step on 512 faked host
devices and reads the compiled HLO.  The port traces the same step once:
`launch.mesh.make_production_mesh` makes a fake process group of 256
(16 x 16, "data" x "model") or 512 (2 x 16 x 16, with "pod") ranks, this
process rank 0; params, optimizer state, batches and caches become
DTensors sharded by the spec trees of `launch.sharding`, their local
shards fake tensors (shapes, no storage); and the plain step of
`launch.steps` runs on them under `launch.hlo_cost.TraceCounter`, which
counts per-device FLOPs, unfused aten bytes and collectives.  The dry run
runs on no device: it allocates nothing, needs no card, and is the one
entry point of the port that does not ask for one.

The reference's rules carry over: inference shards params FSDP only when
the TP-resident bf16 weights pass 10 GB; training always shards them, and
a model whose bf16 weights fit in 8 GB trains ZeRO-1 on the same ranks
relabelled as an (N/4, 4) mesh; `steps.pick_microbatches` sizes the
gradient accumulation.  A train cell traces one microbatch and counts it
``microbatches`` times (`TraceCounter.scan`, the reference's while body
times its trip count); the accumulator's set-up, the scaling and the
optimizer count once.

Each cell writes one JSON under ``--out`` (default ``build/dryrun/``):
the reference's keys where they mean the same thing, ``trace_s`` in place
of ``lower_s``/``compile_s``, the link figure and its source, the bytes'
basis, and ``replicated_ops``, the ops DTensor had no sharding plan for
and that ran on replicated inputs (op -> count and collective bytes).
``memory`` holds the local shards of the step's arguments and outputs and,
as ``temp_size_in_bytes``, the peak of live local bytes the step made (a
finalizer on each traced tensor, `hlo_cost._Totals.track`).  A skip
or an error is a record too, with its reason or traceback; the sweep goes
on, prints one line a cell and ``dry-run done: ok= skip= err=``, and
exits 1 on any error.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
import traceback
from pathlib import Path
from typing import Any

import torch

import repro_torch.configs as C
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, cell_applicable
from repro_torch.launch import hlo_analysis, hlo_cost, sharding, steps
from repro_torch.launch.mesh import Mesh, axis_size, data_axes, fake_mesh, make_production_mesh
from repro_torch.tree import tree_map

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
DEVICE = "cpu"           # the fake shards' device (they hold no storage)


class SkipCell(Exception):
    pass


def _mesh_axes(sizes: tuple[int, ...]) -> tuple[str, ...]:
    return ("pod", "data", "model")[-len(sizes):]


def _place(tree: Any, named: Any) -> Any:
    """Each (meta or fake) global tensor of `tree` as a DTensor whose local
    shard is a fake tensor, placed as its `sharding.NamedSharding` says
    (the specs shard only dims the mesh divides).  An int leaf stays an
    int."""
    from torch.distributed.tensor import DTensor, Shard

    def place(t, ns):
        if not isinstance(t, torch.Tensor):
            return t
        local = list(t.shape)
        for dim, p in enumerate(ns.placements):
            if isinstance(p, Shard):
                local[p.dim] //= ns.mesh.size(dim)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device=DEVICE), ns.mesh,
                                  ns.placements, run_check=False)

    return tree_map(place, tree, named)


def lower_cell(arch: str | ModelConfig, shape_name: str | ShapeConfig,
               mesh: Mesh | tuple[int, ...], *, dtype: torch.dtype = torch.bfloat16,
               fsdp: bool | None = None, num_microbatches: int | None = None,
               trace_microbatches: int | None = 1,
               full_depth: bool = False) -> tuple[hlo_cost.HloCost, dict]:
    """Traces one (arch x shape) on `mesh` and returns (its per-device cost,
    aux).  `arch` and `shape_name` may be a `ModelConfig` and a
    `ShapeConfig`, and `mesh` a tuple of sizes (a fake mesh over "data",
    "model", and "pod" first for three), so a test can trace a small cell.

    Every layer of a model is the same block (a hybrid's period is
    ``hybrid_attn_every`` layers), so unless `full_depth` the step is
    traced at one period and at two, and the cost of the whole depth is
    extrapolated from the difference (`hlo_cost.extrapolate`), the
    reference's scanned layer body times its trip count.  Where the second
    period counts less than nothing in some figure (DTensor planned the two
    periods differently), the whole depth is traced instead.  The rules
    that read the model's size (FSDP, ZeRO-1, microbatches) read the whole
    config.  A train step's microbatch loop traces `trace_microbatches`
    trips (None: every trip) and counts the first one for all of them."""
    cfg = C.get(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    if not isinstance(mesh, Mesh):
        mesh = fake_mesh(tuple(mesh), _mesh_axes(tuple(mesh)))

    if fsdp is None:
        # Training always FSDP-shards params (grads/optimizer dominate).
        # Inference only FSDP-shards when TP-sharded weights don't fit HBM:
        # FSDP at decode re-gathers every weight every token.
        tp_resident = cfg.param_count() * 2 / mesh.shape["model"]
        fsdp = shape.step == "train" or tp_resident > 10e9

    # Small models don't earn 16-way TP: train them on the same ranks
    # relabelled as a (batch, 4) mesh (tp=4 keeps the transients sharded).
    if (shape.step == "train"
            and sharding.train_strategy(cfg, mesh) == "zero1"
            and shape.global_batch % (mesh.size // 4) == 0):
        if "pod" in mesh.axis_names:
            mesh = fake_mesh((2, mesh.size // 8, 4), ("pod", "data", "model"))
        else:
            mesh = fake_mesh((mesh.size // 4, 4), ("data", "model"))
    aux: dict[str, Any] = {"step": shape.step}
    plan: dict[str, Any] = {"fsdp": fsdp}
    if shape.step == "train":
        plan["strategy"] = sharding.train_strategy(cfg, mesh)
        mb = num_microbatches or steps.pick_microbatches(
            cfg, shape, axis_size(mesh, data_axes(mesh)))
        plan["mb"] = mb
        plan["traced"] = mb if trace_microbatches is None else min(mb, trace_microbatches)
        aux.update(microbatches=mb, microbatches_traced=plan["traced"],
                   strategy=plan["strategy"])

    period = cfg.hybrid_attn_every if cfg.family == "hybrid" else 1
    t0 = time.time()
    if full_depth or cfg.n_layers <= 2 * period or cfg.n_layers % period:
        cost = _trace(cfg, shape, mesh, dtype, plan, top=12)
        aux["layers_traced"] = [cfg.n_layers]
    else:
        c1, c2 = (_trace(dataclasses.replace(cfg, n_layers=n), shape, mesh, dtype, plan,
                         top=None) for n in (period, 2 * period))
        if hlo_cost.grows(c1, c2):
            cost = hlo_cost.extrapolate(c1, c2, cfg.n_layers / period - 1)
            aux["layers_traced"] = [period, 2 * period]
        else:       # the second period's plan is not the first's: trace it all
            cost = _trace(cfg, shape, mesh, dtype, plan, top=12)
            aux["layers_traced"] = [cfg.n_layers]
    aux["trace_s"] = round(time.time() - t0, 2)
    aux["fsdp"] = bool(fsdp)
    aux["mesh_shape"] = dict(mesh.shape)
    aux["params"] = float(cfg.param_count())
    aux["active_params"] = float(cfg.active_param_count())
    aux["chips"] = mesh.size
    return cost, aux


def _trace(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, dtype: torch.dtype,
           plan: dict, top: int | None) -> hlo_cost.HloCost:
    """One trace of the cell's step at `cfg`'s depth."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    p_shapes = steps.params_shapes(cfg, dtype)
    p_spec = sharding.param_specs(cfg, p_shapes, mesh, fsdp=plan["fsdp"])
    # The shards are made fake under the mode; the step runs with the mode
    # off, so the fake shards carry it into every op on them while the small
    # index tensors DTensor and the model make for themselves are real.
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    tc = hlo_cost.TraceCounter(fake)
    with fake:
        inputs = steps.input_specs(cfg, shape, None, dtype, device=DEVICE)
        batch = _place({k: v for k, v in inputs.items() if k != "pos"},
                       sharding.named(mesh, sharding.batch_specs(cfg, shape, mesh)))
    out_specs = None
    if shape.step == "train":
        sharded_specs = sharding.param_specs(cfg, p_shapes, mesh, fsdp=True)
        zero1 = plan["strategy"] == "zero1"
        if zero1:
            p_spec = sharding.param_specs(cfg, p_shapes, mesh, fsdp=False)
        with fake:
            params = _place(p_shapes, sharding.named(mesh, p_spec))
            opt = _place(steps.opt_shapes(p_shapes),
                         sharding.named(mesh, sharding.opt_specs(sharded_specs)))
        fn = steps.make_train_step(
            cfg, num_microbatches=plan["mb"], grad_specs=sharded_specs if zero1 else None,
            **({} if plan["traced"] == plan["mb"] else {"loop": tc.scan}))
        args: tuple = (params, opt, batch)
    else:
        with fake:
            params = _place(p_shapes, sharding.named(mesh, p_spec))
        out_specs = sharding.cache_specs(cfg, shape, mesh) if cfg.has_decoder else None
        if shape.step == "prefill":
            fn = steps.make_prefill_step(cfg)
            args = (params, batch)
        else:
            with fake:
                cache = _place(steps.cache_shapes(cfg, shape, dtype),
                               sharding.named(mesh, out_specs))
            fn = steps.make_decode_step(cfg)
            args = (params, cache, batch["tokens"], inputs["pos"])
    tc.hold(args)
    with tc:
        out = fn(*args)
        if out_specs is not None:           # the reference's out_shardings
            out = (out[0], steps.constrain_tree(out[1], out_specs))
    return tc.cost(argument_bytes=hlo_cost.local_bytes(args),
                   output_bytes=hlo_cost.local_bytes(out), top=top)


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        cost, aux = lower_cell(arch, shape_name, mesh)
        chips = aux.pop("chips")
        shape = SHAPES[shape_name]
        cfgN = aux["active_params"]
        tokens = (shape.global_batch * shape.seq_len
                  if shape.step != "decode" else shape.global_batch)
        model_flops = (6.0 if shape.step == "train" else 2.0) * cfgN * tokens

        rec.update(
            status="ok", **aux,
            chips=chips,
            flops_per_device=cost.flops,
            hbm_bytes_per_device=cost.bytes,
            hbm_bytes_basis=cost.bytes_basis,
            collective_bytes_per_device=cost.collective_bytes,
            collective_by_kind=cost.collective_by_kind,
            collective_counts=cost.collective_counts,
            top_dots=dict(cost.dot_flops_by_shape),
            replicated_ops=cost.replicated_ops,
            sharded_ops=cost.sharded_ops,
            memory=hlo_analysis.memory_dict(cost),
            model_flops=model_flops,
            link_bw=hlo_analysis.NVLINK4_BW,
            link_source=hlo_analysis.NVLINK4_SOURCE,
        )
        rl = hlo_analysis.roofline(
            rec["flops_per_device"], rec["hbm_bytes_per_device"],
            rec["collective_bytes_per_device"], chips)
        rec.update(
            t_compute=rl.t_compute, t_memory=rl.t_memory,
            t_collective=rl.t_collective, dominant=rl.dominant,
            useful_flops_ratio=(model_flops / max(1.0, rl.flops)),
        )
    except SkipCell as e:
        rec.update(status="skip", reason=str(e))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    rec["wall_s"] = round(time.time() - t0, 2)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_id}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="DAK multi-pod dry-run (no device)")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    # DTensor warns at each two-dim all-reduce that a flattened mesh would
    # take one collective; the count is what the record keeps
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

    archs = C.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                rec = run_cell(arch, shape_name, multi_pod, out_dir)
                tag = rec["status"]
                n_ok += tag == "ok"
                n_skip += tag == "skip"
                n_err += tag == "error"
                msg = (f"[{tag:5s}] {arch:20s} {shape_name:12s} "
                       f"{'2x16x16' if multi_pod else '16x16':8s} "
                       f"wall={rec['wall_s']:7.1f}s")
                if tag == "ok":
                    msg += (f" dominant={rec['dominant']:10s}"
                            f" mem/dev={rec['memory'].get('temp_size_in_bytes', 0)/1e9:6.2f}GB"
                            f" useful={rec['useful_flops_ratio']:.2f}")
                if tag == "error":
                    msg += " " + rec["error"][:120]
                print(msg, flush=True)
    print(f"dry-run done: ok={n_ok} skip={n_skip} err={n_err}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
