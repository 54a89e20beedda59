"""The port's planning layer against the JAX package: hardware presets,
`plan`, `kv_page_plan`, the operand registry and `TieringPlan.partition`
split shapes, for llama2-7b (full and smoke) on two presets."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import engine as JE
from repro.core import hardware as JH
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.models import model as JM
from repro_torch.core import engine as TE
from repro_torch.core import hardware as TH
from repro_torch.core import tiering as TT
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.models import model as TM
from repro_torch.models.registry import operand_registry

RATIOS = [0.0, 0.3, 0.5, 1.0]
PRESETS = ["tpu_v5e", "gh200"]


def _plans(arch: str, smoke: bool, hw: str, ratio: float):
    jcfg = JC.get_smoke(arch) if smoke else JC.get(arch)
    tcfg = TC.get_smoke(arch) if smoke else TC.get(arch)
    jp = JE.plan(jcfg, JWorkload(batch=4, seq_len=64, phase="decode"),
                 JH.SYSTEMS[hw], global_ratio=ratio, kv_page_size=8)
    tp = TE.plan(tcfg, TWorkload(batch=4, seq_len=64, phase="decode"),
                 TH.SYSTEMS[hw], global_ratio=ratio, kv_page_size=8)
    return jcfg, tcfg, jp, tp


def test_configs_and_presets_are_copies():
    assert dataclasses.asdict(TC.get("llama2_7b")) == dataclasses.asdict(JC.get("llama2_7b"))
    assert dataclasses.asdict(TC.get_smoke("llama2_7b")) == \
        dataclasses.asdict(JC.get_smoke("llama2_7b"))
    assert TC.get_smoke("llama2_7b").padded_heads == JC.get_smoke("llama2_7b").padded_heads == 16
    assert TC.get("llama2_7b").padded_heads == 32
    for name in ("tpu_v5e", "gh200", "rtx6000_blackwell"):
        assert dataclasses.asdict(TH.SYSTEMS[name]) == dataclasses.asdict(JH.SYSTEMS[name])
    h100 = TH.H100_SXM
    assert (h100.peak_flops, h100.hbm.bandwidth, h100.hbm.capacity,
            h100.host.bandwidth) == (989e12, 3.35e12, 80e9, 64e9)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("hw", PRESETS)
@pytest.mark.parametrize("ratio", RATIOS)
def test_plan_matches_reference(smoke, hw, ratio):
    jcfg, tcfg, jp, tp = _plans("llama2_7b", smoke, hw, ratio)
    assert tp.op_ratios == jp.op_ratios
    assert tp.param_ratios == jp.param_ratios
    assert tp.kv_ratio == jp.kv_ratio
    assert dataclasses.asdict(tp.kv_pages) == dataclasses.asdict(jp.kv_pages)
    assert dataclasses.asdict(tp.window) == dataclasses.asdict(jp.window)
    assert tp.global_ratio == jp.global_ratio and tp.latency == jp.latency
    assert [dataclasses.astuple(o) for o in tp.registry] == \
        [dataclasses.astuple(o) for o in jp.registry]
    assert dataclasses.asdict(
        TE.kv_page_plan(tcfg, TWorkload(batch=3, seq_len=40, phase="decode"), ratio, 4)) == \
        dataclasses.asdict(
            JE.kv_page_plan(jcfg, JWorkload(batch=3, seq_len=40, phase="decode"), ratio, 4))
    if ratio == 0.5:
        # uniform half-and-half split with a one-slot window on every preset
        assert all(abs(r - 0.5) < 1e-9 for r in tp.op_ratios.values())
        assert tp.window.n_inflight == 1
        assert tp.kv_pages.local_pages == tp.kv_pages.remote_pages


def _split_shapes(tree) -> dict:
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update({f"{key}/{k}": v for k, v in _split_shapes(leaf).items()})
        elif hasattr(leaf, "local"):
            out[key] = (tuple(leaf.local.shape), tuple(leaf.remote.shape), leaf.axis)
        else:
            out[key] = tuple(leaf.shape)
    return out


@pytest.mark.parametrize("ratio", RATIOS)
def test_partition_split_shapes_match_reference(ratio):
    """Split shapes of both partitions agree: the smoke config on real
    arrays (numbers too), the full config on shapes only (meta tensors on
    the port's side, abstract evaluation on the reference's)."""
    jcfg, tcfg, jp, tp = _plans("llama2_7b", True, "tpu_v5e", ratio)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    from repro_torch import bridge

    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jsplit = jp.partition(jparams, align=32)
    tsplit = tp.partition(tparams, align=32)
    assert _split_shapes(tsplit) == _split_shapes(jsplit)
    for od in tp.registry:
        jl, tl = jsplit[od.path[0]], tsplit[od.path[0]]
        if len(od.path) == 2:
            jl, tl = jl[od.path[1]], tl[od.path[1]]
        if ratio > 0:
            assert isinstance(tl, TT.TieredTensor)
            TT.validate(tl)
            np.testing.assert_array_equal(tl.local.numpy(), np.asarray(jl.local))
            np.testing.assert_array_equal(tl.remote.numpy(), np.asarray(jl.remote))

    jcfg, tcfg, jp, tp = _plans("llama2_7b", False, "tpu_v5e", ratio)
    jshapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    meta = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), jshapes)
    jfull = jax.eval_shape(lambda p: jp.partition(p, align=128), jshapes)
    assert _split_shapes(tp.partition(meta, align=128)) == _split_shapes(jfull)


def test_init_params_layout_matches_reference():
    cfg = TC.get_smoke("llama2_7b")
    gen = torch.Generator().manual_seed(0)
    tparams = TM.init_params(cfg, gen, device="cpu")
    jshapes = jax.eval_shape(lambda: JM.init_params(JC.get_smoke("llama2_7b"),
                                                    jax.random.PRNGKey(0)))
    assert _split_shapes(tparams) == _split_shapes(jshapes)
    hd, nh = cfg.resolved_head_dim, cfg.n_heads
    assert torch.all(tparams["layers"]["wq"][..., nh * hd:] == 0)
    assert torch.all(tparams["layers"]["wo"][..., nh * hd:, :] == 0)
    assert abs(float(tparams["lm_head"].std()) - 0.02) < 0.002
    assert torch.all(tparams["final_w"] == 1)
    assert [od.path for od in operand_registry(cfg)] == [
        ("layers", "wq"), ("layers", "wkv"), ("layers", "wo"), ("layers", "wi"),
        ("layers", "wdown"), ("lm_head",)]
