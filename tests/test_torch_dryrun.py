"""The port's dry run against the JAX package's: the roofline arithmetic,
per-device counts of hand-built DTensor ops on a fake (data 2, model 4)
mesh, smoke cells' FLOPs against the reference's ``hlo_cost.analyze`` of
the same cells (its figures from a subprocess, tests/torch_dryrun_reference.py),
a decode cell's all-reduces against the count the spec trees imply, the
sweep's skip/error/exit behaviour, the production mesh moving from 256 to
512 ranks, and the dry run with no card.

The dense and MoE cells agree to the FLOP.  The train cell does not: the
port's train step recomputes each layer's forward in the backward pass
(``torch.utils.checkpoint``, what the trainer runs on the card), while the
reference's compiled CPU module counts no recomputed forward.  Traced with
remat off, the port's train step equals the reference's count; with remat on
it adds the recomputed forward, at most a third of the step's dots.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

import repro_torch.configs as TC
from repro.launch import hlo_analysis as JHA
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, hlo_analysis, hlo_cost, sharding, steps
from repro_torch.launch import mesh as LM

REPO = Path(__file__).resolve().parents[1]
MESH = (2, 4)
# [name, arch, step, seq_len, batch, microbatches]
CELLS = [["dense_decode", "llama2_7b", "decode", 64, 4, 1],
         ["dense_prefill", "llama2_7b", "prefill", 32, 4, 1],
         ["moe_decode", "qwen3_moe_30b_a3b", "decode", 64, 4, 1],
         ["dense_train", "llama2_7b", "train", 32, 4, 2]]


@pytest.fixture(scope="module", autouse=True)
def _leave_no_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference(tmp_path_factory) -> dict:
    out = tmp_path_factory.mktemp("dryrun_ref") / "ref.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO / "tests")]))
    subprocess.run([sys.executable, str(REPO / "tests" / "torch_dryrun_reference.py"),
                    str(out), json.dumps(CELLS)], env=env, check=True, timeout=600)
    return json.loads(out.read_text())


def _cell(name: str, **kw):
    _, arch, step, seq, batch, mb = next(c for c in CELLS if c[0] == name)
    return dryrun.lower_cell(TC.get_smoke(arch), ShapeConfig(name, seq, batch, step), MESH,
                             num_microbatches=mb if step == "train" else None, **kw)


# --------------------------------------------------------------------------
# Roofline and collective arithmetic
# --------------------------------------------------------------------------
def test_roofline_and_collective_stats_equal_the_reference():
    figures = dict(flops_per_device=3.1e14, bytes_per_device=2.2e11,
                   coll_bytes_per_device=7.5e9, chips=256)
    peaks = (989e12, 3.35e12, 450e9)
    ours = hlo_analysis.roofline(**figures)          # the H100 defaults
    ref = JHA.roofline(**figures, peak_flops=peaks[0], hbm_bw=peaks[1],
                       ici_bw_per_chip=peaks[2])
    for field in ("t_compute", "t_memory", "t_collective", "flops", "hbm_bytes",
                  "collective_bytes", "chips"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.dominant == ref.dominant and ours.bound_time == ref.bound_time
    assert hlo_analysis._TRAFFIC_FACTOR == JHA._TRAFFIC_FACTOR
    kinds = {"all-reduce": 1024.0, "all-gather": 300.0, "all-to-all": 64.0}
    counts = {"all-reduce": 2, "all-gather": 1, "all-to-all": 1}
    a, b = hlo_analysis.CollectiveStats(kinds, counts), JHA.CollectiveStats(kinds, counts)
    assert (a.total_bytes, a.raw_bytes) == (b.total_bytes, b.raw_bytes)


# --------------------------------------------------------------------------
# Hand-counted ops on a (data 2, model 4) fake mesh
# --------------------------------------------------------------------------
def _dt(dm, shape, placements, dtype=torch.bfloat16):
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= dm.size(i)
    t = torch.empty(local, dtype=dtype)
    return DTensor.from_local(t, dm, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _trace(fn):
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    dm = LM.fake_mesh(MESH, ("data", "model")).device_mesh
    with fake:
        args = fn(dm, None)
    with hlo_cost.TraceCounter(fake) as tc:
        out = fn(dm, args)
    return tc.cost(), out


def test_mm_shard_shard_output_per_device():
    def step(dm, a):
        if a is None:
            return (_dt(dm, (8, 64), [Shard(0), Replicate()]),
                    _dt(dm, (64, 32), [Replicate(), Shard(1)]))
        return a[0] @ a[1]

    cost, out = _trace(step)
    assert out.placements == (Shard(0), Shard(1))
    # local [4, 64] @ [64, 8]: 2 * 4 * 64 * 8; bytes 512 + 1024 in, 64 out (bf16)
    assert cost.flops == cost.local_flops == 2 * 4 * 64 * 8
    assert cost.bytes == 2 * (4 * 64 + 64 * 8 + 4 * 8)
    assert cost.collective_counts == {}


def test_mm_partial_output_and_its_all_reduce():
    def step(dm, a):
        if a is None:
            return (_dt(dm, (8, 32), [Shard(0), Shard(1)]),
                    _dt(dm, (32, 64), [Replicate(), Shard(0)]))
        y = a[0] @ a[1]
        return y, y.redistribute(dm, [Shard(0), Replicate()])

    cost, (y, _) = _trace(step)
    assert y.placements == (Shard(0), Partial())
    # local [4, 8] @ [8, 64]; the global count scaled by 1/2 (rows) and by
    # 1/4 (partial over model): 2 * 8 * 32 * 64 / 8
    assert cost.flops == cost.local_flops == 2 * 4 * 8 * 64
    # one all-reduce of the local [4, 64] bf16 output, ring factor 2
    assert cost.collective_counts == {"all-reduce": 1}
    assert cost.collective_raw_by_kind == {"all-reduce": 4 * 64 * 2}
    assert cost.collective_by_kind == {"all-reduce": 2 * 4 * 64 * 2}
    stats = hlo_analysis.collective_stats(cost)
    assert (stats.raw_bytes, stats.total_bytes) == (4 * 64 * 2, cost.collective_bytes)


def test_bmm_per_device():
    def step(dm, a):
        if a is None:
            return (_dt(dm, (4, 8, 16), [Shard(0), Replicate()]),
                    _dt(dm, (4, 16, 32), [Shard(0), Shard(2)]))
        return torch.bmm(a[0], a[1])

    cost, out = _trace(step)
    assert out.placements == (Shard(0), Shard(2))
    assert cost.flops == cost.local_flops == 2 * 2 * 8 * 16 * 8
    assert cost.collective_counts == {}


@pytest.mark.parametrize("op", ["addmm", "baddbmm", "einsum_gqa", "einsum_mla"])
def test_more_dot_kinds_per_device(op):
    """The per-device rule (global FLOPs x local/global output numel /
    Partial mesh sizes) against the local dots DTensor runs, and against a
    hand count: addmm and baddbmm, and the two einsum forms the attention
    and the absorbed MLA decode reduce to (permutes, views and a bmm)."""
    cases = {
        # (global shapes, placements, fn, per-device FLOPs by hand)
        "addmm": ([(32,), (8, 64), (64, 32)],
                  [[Replicate(), Shard(0)], [Shard(0), Replicate()], [Replicate(), Shard(1)]],
                  lambda b, x, w: torch.addmm(b, x, w), 2 * 4 * 64 * 8),
        "baddbmm": ([(4, 8, 32), (4, 8, 16), (4, 16, 32)],
                    [[Shard(0), Shard(2)], [Shard(0), Replicate()], [Shard(0), Shard(2)]],
                    lambda c, a, b: torch.baddbmm(c, a, b), 2 * 2 * 8 * 16 * 8),
        "einsum_gqa": ([(4, 1, 2, 4, 16), (4, 64, 4, 16)],
                       [[Shard(0), Replicate()], [Shard(0), Shard(1)]],
                       lambda q, k: torch.einsum("btgkh,bskh->bgkts", q, k),
                       2 * 2 * 2 * 4 * 1 * 16 * 16),
        "einsum_mla": ([(4, 8, 32), (4, 64, 32)],
                       [[Shard(0), Replicate()], [Shard(0), Shard(1)]],
                       lambda q, c: torch.einsum("bhr,bsr->bhs", q, c), 2 * 2 * 8 * 16 * 32),
    }
    shapes, placements, fn, hand = cases[op]

    def step(dm, a):
        if a is None:
            return tuple(_dt(dm, s, p) for s, p in zip(shapes, placements))
        return fn(*a)

    cost, _ = _trace(step)
    assert cost.flops == cost.local_flops == hand


def test_in_place_cache_write_counts_the_region_only():
    def step(dm, a):
        if a is None:
            # a [B, S, hd] cache, batch over data, sequence over model
            return (_dt(dm, (4, 64, 16), [Shard(0), Shard(1)]),
                    _dt(dm, (4, 16), [Shard(0), Replicate()]))
        cache, new = a
        cache[:, 37] = new
        return cache

    cost, out = _trace(step)
    assert out.placements == (Shard(0), Shard(1))
    # read and write of the local [2, 16] bf16 region, no gather of the cache
    assert cost.bytes == 2 * 2 * 16 * 2
    assert cost.collective_counts == {}
    assert cost.sharded_ops == {"__setitem__": 1.0}


def test_all_to_all_is_counted_as_all_to_all():
    def step(dm, a):
        if a is None:
            return (_dt(dm, (8, 16), [Replicate(), Shard(0)]),)
        return a[0].redistribute(dm, [Replicate(), Shard(1)])

    cost, out = _trace(step)
    assert out.placements == (Replicate(), Shard(1))
    assert out._local_tensor.shape == (8, 4)
    assert cost.collective_counts == {"all-to-all": 1}
    assert cost.collective_raw_by_kind == {"all-to-all": 2 * 16 * 2}


# --------------------------------------------------------------------------
# Smoke cells against the reference's hlo_cost
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["dense_decode", "dense_prefill", "moe_decode"])
def test_cell_flops_equal_the_reference(reference, name):
    cost, aux = _cell(name)
    assert aux["layers_traced"] == [2]
    assert cost.flops == pytest.approx(reference[name]["flops"], rel=0.01)
    assert cost.flops == cost.local_flops


def test_train_cell_flops_equal_the_reference_but_for_remat(reference, monkeypatch):
    ref = reference["dense_train"]["flops"]
    with_remat, aux = _cell("dense_train")
    assert aux["microbatches"] == 2 and aux["microbatches_traced"] == 1
    real = steps.make_train_step
    monkeypatch.setattr(steps, "make_train_step",
                        lambda *a, **kw: real(*a, **{**kw, "remat": False}))
    without, _ = _cell("dense_train")
    assert without.flops == pytest.approx(ref, rel=0.01)
    assert 0 < with_remat.flops - without.flops <= without.flops / 3
    # the one microbatch traced, counted twice, is every microbatch traced
    monkeypatch.setattr(steps, "make_train_step", real)
    every, _ = _cell("dense_train", trace_microbatches=None)
    assert every.flops == with_remat.flops
    assert every.collective_counts == with_remat.collective_counts


def test_decode_all_reduces_are_what_the_specs_imply():
    """llama2-7b smoke (d 64, padded heads 16 of 16 dims, 4 kv heads, 2
    layers), decode at batch 4 against a 64-deep cache on (data 2, model
    4), FSDP off.  The embedding's spec puts d_model on "model", so the
    residual stream is d-sharded: each RMSNorm (2 a layer and the final
    one) all-reduces its mean, [B/2, 1, 1] fp32.  ``wkv`` is FSDP-only,
    replicated at inference, so x(d-sharded) @ wkv is a partial sum over
    model that the k and v hints (replicated over model) all-reduce:
    [B/2, 1, 4, 16] bf16 each.  The cache spec shards the sequence over
    model, so the softmax all-reduces its max and its sum, [B/2, 16 heads]
    fp32 each.  Nothing else is a sum across devices."""
    cfg = TC.get_smoke("llama2_7b")
    cost, aux = dryrun.lower_cell(cfg, ShapeConfig("d", 64, 4, "decode"), MESH, fsdp=False)
    b, L, hp, kv, hd = 4 // 2, cfg.n_layers, cfg.padded_heads, cfg.n_kv_heads, 16
    norms, kvs, softmax = 2 * L + 1, 2 * L, 2 * L
    assert cost.collective_counts["all-reduce"] == norms + kvs + softmax == 13
    raw = norms * b * 4 + kvs * b * kv * hd * 2 + softmax * b * hp * 4
    assert cost.collective_raw_by_kind["all-reduce"] == raw
    assert cost.collective_by_kind["all-reduce"] == 2 * raw


def test_depth_extrapolation_is_exact():
    cfg = dataclasses.replace(TC.get_smoke("llama2_7b"), n_layers=4)
    shape = ShapeConfig("d", 64, 4, "decode")
    full, _ = dryrun.lower_cell(cfg, shape, MESH, full_depth=True)
    ext, aux = dryrun.lower_cell(cfg, shape, MESH)
    assert aux["layers_traced"] == [1, 2]
    assert ext.flops == full.flops and ext.bytes == pytest.approx(full.bytes, rel=1e-12)
    assert ext.collective_counts == full.collective_counts
    assert ext.collective_by_kind == pytest.approx(full.collective_by_kind, rel=1e-12)


# --------------------------------------------------------------------------
# Specs, meshes, the sweep and no card
# --------------------------------------------------------------------------
def test_named_maps_specs_onto_the_device_mesh():
    mesh = LM.make_production_mesh(multi_pod=True)
    assert mesh.device_mesh.mesh_dim_names == ("pod.data", "model")
    ns = sharding.named(mesh, {"a": (("pod", "data"), None, "model"), "b": ()})
    assert ns["a"].placements == (Shard(0), Shard(2))
    assert ns["b"].placements == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="part of mesh dim"):
        sharding.placements(mesh.device_mesh.mesh_dim_names, ("data", None))
    assert steps.constrain_tree({"x": torch.ones(2)}, {"x": ("data",)})["x"].sum() == 2


def test_production_mesh_moves_from_256_to_512_ranks():
    m = LM.make_production_mesh()
    assert (m.shape, m.size, dist.get_world_size()) == ({"data": 16, "model": 16}, 256, 256)
    m = LM.make_production_mesh(multi_pod=True)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert (m.size, dist.get_world_size(), dist.get_rank()) == (512, 512, 0)
    assert m.device_mesh.shape == (32, 16) and m.group("model").size() == 16
    m = LM.make_production_mesh()
    assert dist.get_world_size() == 256 and m.device_mesh.shape == (16, 16)


def test_sweep_records_skips_errors_and_exits_1(tmp_path, monkeypatch, capsys):
    dryrun.main(["--arch", "hubert_xlarge", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert "dry-run done: ok=0 skip=2 err=0" in capsys.readouterr().out
    rec = json.loads((tmp_path / "hubert_xlarge__decode_32k__pod2x16x16.json").read_text())
    assert rec["status"] == "skip" and "encoder-only" in rec["reason"]

    real = dryrun.lower_cell

    def small(arch, shape_name, mesh, **kw):
        if "pod" in mesh.axis_names:
            raise RuntimeError("no plan for this cell")
        return real(TC.get_smoke(arch), ShapeConfig(shape_name, 64, 4, "decode"), MESH, **kw)

    monkeypatch.setattr(dryrun, "lower_cell", small)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama2_7b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "[ok   ] llama2_7b" in out and "[error] llama2_7b" in out
    assert "dry-run done: ok=1 skip=0 err=1" in out
    ok = json.loads((tmp_path / "llama2_7b__decode_32k__pod16x16.json").read_text())
    err = json.loads((tmp_path / "llama2_7b__decode_32k__pod2x16x16.json").read_text())
    assert err["status"] == "error" and "no plan for this cell" in err["trace"]
    assert ok["link_bw"] == 450e9 and "NVLink" in ok["link_source"]
    assert "unfused aten" in ok["hbm_bytes_basis"]
    for key in ("flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device",
                "collective_by_kind", "collective_counts", "top_dots", "model_flops",
                "t_compute", "t_memory", "t_collective", "dominant", "useful_flops_ratio",
                "chips", "wall_s", "trace_s", "replicated_ops", "memory"):
        assert key in ok, key
    assert {"argument_size_in_bytes", "output_size_in_bytes"} <= set(ok["memory"])


def test_dry_run_needs_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    cost, aux = _cell("dense_decode")
    assert cost.flops > 0 and aux["chips"] == 8
