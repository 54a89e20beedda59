"""The rank side of tests/test_torch_mesh.py and tests/test_torch_mesh_plan.py:
functions that `launch.mesh.run_ranks` spawns as gloo ranks on the CPU.

Each rank runs every case of its mesh size and writes what it saw as JSON
to ``<dir>/p<P>_r<rank>.json``; the tests read those files.  The module
imports no JAX (every rank would pay for it): weights come from the parent
process through ``<dir>/params.pt``, the JAX package's own draws bridged to
the port.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core.hardware import TPU_V5E
from repro_torch.launch.mesh import make_dev_mesh

DENSE_ARCHS = ("llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b")
RECURRENT_ARCHS = ("mamba2_370m", "zamba2_2p7b")
RATIOS = (0.0, 0.5)


def serve(cfg, params, ratio, mesh=None, adaptive=False):
    """tests/test_mesh_serving.py's `_serve` on the port: 2 slots, max_len 24,
    the reference's default page size and hardware, two 5-token prompts."""
    from repro_torch.serving.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params, max_batch=2, max_len=24, hw=TPU_V5E,
                        global_offload_ratio=ratio, mesh=mesh, adaptive=adaptive, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, 5).astype(np.int32),
                    max_new_tokens=3) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, [r.out_tokens for r in reqs]


def _roundtrip(params, mesh) -> dict:
    """Partition at a 4-link plan, shard, fetch: every leaf's tiers come back
    bit for bit and each rank held one disjoint 1/P slice."""
    from repro_torch.core import engine as TE
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.tiering import TieredTensor
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import shard_tiered_params

    cfg = C.get_smoke("llama2_7b")
    plan = TE.plan(cfg, WorkloadSpec(batch=2, seq_len=24, phase="decode"), TPU_V5E,
                   global_ratio=0.5, mesh=MeshSpec(n_devices=4, axis_name="model"))
    tiered = plan.partition(params, align=32)
    sharded = shard_tiered_params(tiered, mesh, "model")

    def leaves(tree):
        for v in tree.values():
            if isinstance(v, dict):
                yield from leaves(v)
            elif isinstance(v, TieredTensor):
                yield v

    shard_ok = all(leaf.shard.shape[leaf.axis] * 4 == leaf.remote.shape[leaf.axis]
                   for leaf in leaves(sharded) if leaf.mesh_axes is not None)
    fetched = ops.mesh_fetch_params(sharded, mesh, "model")
    pairs = list(zip(leaves(fetched), leaves(tiered), strict=True))
    return {"any_sharded": any(leaf.mesh_axes == "model" for leaf in leaves(sharded)),
            "shards_quarter": shard_ok,
            "fetched_whole": all(got.mesh_axes is None for got, _ in pairs),
            "bitwise": all(torch.equal(g.remote, w.remote) and torch.equal(g.local, w.local)
                           for g, w in pairs)}


def _move_pages(mesh) -> dict:
    """tests/test_mesh_serving.py's move_pages / grow_remote case on the port."""
    from repro_torch.serving.paged_cache import LOCAL, REMOTE, PagedTieredCache

    cache = PagedTieredCache(2, 2, 4, page_size=4, local_pages=4, remote_pages=4, max_slots=2,
                             max_pages_per_slot=4, mesh=mesh, mesh_axis="model", device="cpu")
    specs = [cache.remote_spec]
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.normal(size=(2, 8, 2, 4)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 8, 2, 4)).astype(np.float32))
    cache.write_prompt(0, k, v)                     # 2 local pages
    cache.move_pages(LOCAL, REMOTE, cache.slot_pages(0, LOCAL)[:1])
    shapes = [list(cache.pools["k_remote"].shape)]
    moved_back = cache.move_pages(REMOTE, LOCAL, cache.slot_pages(0, REMOTE)[:1])
    cache.move_pages(LOCAL, REMOTE, cache.slot_pages(0, LOCAL)[:2])
    grown = cache.grow_remote(4)
    shapes.append(list(cache.pools["k_remote"].shape))
    specs.append(cache.remote_spec)
    gk, gv = cache.gather(0, 8)
    return {"sharded": cache.remote_sharded, "specs": specs, "shapes": shapes,
            "local_shape": list(cache.pools["k_local"].shape), "moved_back": moved_back,
            "grown": grown, "remote_pages": cache.slot_pages(0, REMOTE),
            "gather_exact": bool(torch.equal(gk, k) and torch.equal(gv, v))}


def _grid(rank: int) -> dict:
    """A 2 x 2 ("data", "model") mesh: this rank's indices and the sums of
    the ranks along each of its lines."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import axis_size, data_axes

    grid = make_dev_mesh(2, 2)
    sums = {}
    for axis in ("data", "model"):
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=grid.group(axis))
        sums[axis] = t.item()
    return {"index": [grid.axis_index("data"), grid.axis_index("model")], "sums": sums,
            "data_axes": list(data_axes(grid)), "size": axis_size(grid, ("data", "model"))}


def _serve_command(rank: int, tmp: str) -> dict:
    """`launch.serve.main --mesh-devices 2` as this rank (the torchrun path:
    the process group is already up); rank 0 writes the tokens."""
    import torch.distributed as dist

    from repro_torch.launch import serve

    out = os.path.join(tmp, "serve_tokens_mesh.json")
    report = serve.main(["--device", "cpu", "--smoke", "--requests", "3", "--max-batch", "2",
                         "--prompt-len", "6", "--new-tokens", "4", "--max-len", "24",
                         "--offload-ratio", "0.5", "--page-size", "4", "--mesh-devices", "2",
                         "--tokens-out", out])
    dist.barrier()                        # rank 0 wrote the tokens
    with open(out) as fh:
        tokens = json.load(fh)
    return {"tokens": tokens, "mesh_shape": report["mesh_shape"],
            "mesh_traffic": report["mesh_traffic"]}


def serving_cases(rank: int, n: int, tmp: str) -> None:
    """Every mesh serving case at P = n, on this rank."""
    torch.set_num_threads(1)              # the ranks share the host's cores
    mesh = make_dev_mesh(1, n)
    params = torch.load(os.path.join(tmp, "params.pt"))
    out: dict = {"tokens": {}, "plan_mesh": {}, "mesh_shape": {}}
    for arch in DENSE_ARCHS + (RECURRENT_ARCHS if n == 4 else ()):
        cfg = C.get_smoke(arch)
        for ratio in (RATIOS if arch in DENSE_ARCHS else (0.5,)):
            eng, toks = serve(cfg, params[arch], ratio, mesh=mesh)
            key = f"{arch}/{ratio}"
            out["tokens"][key] = toks
            out["plan_mesh"][key] = eng.plan.mesh is not None
            out["mesh_shape"][key] = eng.mesh_shape
    if n == 2:
        out["serve"] = _serve_command(rank, tmp)
    if n == 4:
        cfg = C.get_smoke("llama2_7b")
        mesh.reset_counters()
        eng, _ = serve(cfg, params["llama2_7b"], 0.5, mesh=mesh)
        pc = eng.pcache
        out["pools"] = {"sharded": pc.remote_sharded, "spec": pc.remote_spec,
                        "remote_shape": list(pc.pools["k_remote"].shape),
                        "local_shape": list(pc.pools["k_local"].shape),
                        "gathered_shape": list(pc.compute_pools()["k_remote"].shape)}
        out["report"] = eng.mesh_traffic_report()
        out["link_bytes"] = dict(mesh.link_bytes)
        out["fetches"] = mesh.fetches
        eng, toks = serve(cfg, params["llama2_7b"], 0.5, mesh=mesh, adaptive=True)
        rt = eng.runtime.report()
        out["adaptive"] = {"tokens": toks, "windows": len(eng.runtime.windows),
                           "window_per_link": len(rt["window"]["per_link"]),
                           "bw_per_link": rt["telemetry"]["bandwidth"]["per_link"]}
        out["roundtrip"] = _roundtrip(params["llama2_7b"], mesh)
        out["move_pages"] = _move_pages(mesh)
        out["grid"] = _grid(rank)
    with open(os.path.join(tmp, f"p{n}_r{rank}.json"), "w") as fh:
        json.dump(out, fh, default=float)


def collective_cases(rank: int, n: int, tmp: str) -> None:
    """`distributed.collectives` at P = n: each rank's gradients are drawn
    from its own seed; the parent recomputes them in numpy."""
    from repro_torch.distributed import collectives as TC

    torch.set_num_threads(1)
    group = make_dev_mesh(1, n).group("model")
    g = {"w": torch.from_numpy(np.random.default_rng(rank).normal(size=(4, 6)).astype(np.float32)),
         "b": torch.from_numpy(np.random.default_rng(100 + rank).normal(size=(3,))
                               .astype(np.float32))}
    residual = TC.ErrorFeedback.init(g)
    corrected, residual = TC.ErrorFeedback.apply(g, residual)
    summed = {k: TC.compressed_psum(v, group) for k, v in corrected.items()}
    scattered = TC.reduce_scatter_grads(g, group)
    gathered = TC.all_gather_params(scattered, group)
    out = {"psum": {k: v.tolist() for k, v in summed.items()},
           "residual": {k: v.tolist() for k, v in residual.items()},
           "scattered": {k: v.tolist() for k, v in scattered.items()},
           "gathered": {k: v.tolist() for k, v in gathered.items()}}
    with open(os.path.join(tmp, f"coll{n}_r{rank}.json"), "w") as fh:
        json.dump(out, fh)
