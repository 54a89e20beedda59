"""Layer-by-layer engine construction on the CPU: `init_params` is the stack
of `init_layer` draws; `TieringPlan.partition_source` over a drawn layer
source gives, leaf by leaf and bit for bit, the tree `partition` gives on
the whole model; and an engine built from the source emits the same tokens
as one built from the whole tree.  Dense (llama2-7b, OPT-30B), MoE
(Qwen3-30B-A3B, expert stacks split on axis -3) and MLA + MoE (DeepSeek-V2)
smoke configs at offload {0.5, 1}."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.tiering import TieredTensor
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request, ServingEngine
from torch_helpers import assert_trees_equal, flat_tree, serve

ARCHS = ["llama2_7b", "opt_30b", "qwen3_moe_30b_a3b", "deepseek_v2_236b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_is_the_stack_of_layer_draws(arch):
    cfg = TC.get_smoke(arch)
    whole = TM.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    gen = torch.Generator().manual_seed(4)
    top = TM.init_top(cfg, gen, device="cpu")
    layers = [TM.init_layer(cfg, gen, device="cpu") for _ in range(cfg.n_layers)]
    assert list(whole) == ["layers", *top]
    for key, leaf in top.items():
        assert torch.equal(whole[key], leaf), key
    assert list(whole["layers"]) == list(layers[0])
    for key in layers[0]:
        assert torch.equal(whole["layers"][key], torch.stack([lp[key] for lp in layers])), key
    hd, nh = cfg.resolved_head_dim, cfg.n_heads
    if not cfg.use_mla and cfg.padded_heads > nh:
        assert torch.all(whole["layers"]["wq"][..., nh * hd:] == 0)


def test_drawn_source_gives_its_layers_in_order_once():
    cfg = TC.get_smoke("llama2_7b")
    src = TM.layer_source(cfg, torch.Generator().manual_seed(0), device="cpu")
    src.layer(0)
    with pytest.raises(ValueError, match="in order"):
        src.layer(0)
    with pytest.raises(ValueError, match="in order"):
        src.layer(2)


def _plan(cfg, ratio):
    return TE.plan(cfg, WorkloadSpec(batch=3, seq_len=32, phase="decode"), TPU_V5E,
                   global_ratio=ratio, kv_page_size=4)


@pytest.mark.parametrize("ratio", [0.5, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_source_equals_partition_of_the_whole(arch, ratio):
    cfg = TC.get_smoke(arch)
    plan = _plan(cfg, ratio)
    whole = TM.init_params(cfg, torch.Generator().manual_seed(9), device="cpu")
    want = plan.partition(whole, align=32)
    src = TM.layer_source(cfg, torch.Generator().manual_seed(9), device="cpu")
    got = plan.partition_source(src, align=32)
    assert_trees_equal(got, want)
    assert_trees_equal(plan.partition_source(TM.LayerSource.from_tree(whole), align=32), want)
    tiered = [k for k, v in flat_tree(got) if isinstance(v, TieredTensor)]
    assert len(tiered) == sum(plan.op_ratios.get(od.op, 0) > 0 for od in plan.registry)
    if cfg.family == "moe":
        assert got["layers"]["experts_wi"].axis == -3


def test_partition_source_at_offload_zero_keeps_every_leaf_whole():
    cfg = TC.get_smoke("opt_30b")
    whole = TM.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    src = TM.layer_source(cfg, torch.Generator().manual_seed(2), device="cpu")
    assert_trees_equal(_plan(cfg, 0.0).partition_source(src, align=32), whole)


@pytest.mark.parametrize("ratio", [0.5, 1.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_from_a_source_emits_the_whole_trees_tokens(arch, ratio):
    cfg = TC.get_smoke(arch)
    whole = TM.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    src = TM.layer_source(cfg, torch.Generator().manual_seed(5), device="cpu")
    wstats, wreqs = serve(ServingEngine, Request, cfg, whole, TPU_V5E, ratio, seed=21,
                          device="cpu")
    sstats, sreqs = serve(ServingEngine, Request, cfg, src, TPU_V5E, ratio, seed=21,
                          device="cpu")
    assert sstats.served == wstats.served == len(wreqs)
    assert [r.out_tokens for r in sreqs] == [r.out_tokens for r in wreqs]
    assert (sstats.local_pages_hwm, sstats.remote_pages_hwm) == \
        (wstats.local_pages_hwm, wstats.remote_pages_hwm)
    assert all(len(r.out_tokens) == 6 and np.all(np.asarray(r.out_tokens) < cfg.vocab)
               for r in sreqs)
