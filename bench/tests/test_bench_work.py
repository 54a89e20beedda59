"""Roofline work of the configuration from its published shapes, and the
share of it the card's HBM forces across the link, against numbers worked
by hand."""
import json

import pytest

from bench import clients, peaks, work
from bench.tests.conftest import ROOT


def model(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())["model"]


def test_opt_30b():
    m = model("opt-30b")
    # 4 x 7168^2 attention (56 heads of 128) + 2 x 7168 x 28672, 48 layers; the
    # head tied to the embedding (7168 x 50272), multiplied once
    assert work.attn_params(m) == 205_520_896
    assert work.mlp_params(m) == 411_041_792
    assert work.head_params(m) == 360_349_696
    assert work.dense_gemm_params(m) == 48 * 616_562_688 == 29_595_009_024
    assert work.weight_params(m) == 29_595_009_024 + 360_349_696 == 29_955_358_720
    assert work.step_weight_params(m, 16) == 29_955_358_720
    assert work.kv_bytes_per_token(m) == 1_376_256              # 2 x 56 x 128 x 2 B x 48
    # a decode row: 2 FLOPs a weight, plus QK^T and PV over 100 keys
    assert work.decode_flops(m, [100]) == 2 * 29_955_358_720 + 48 * 4 * 56 * 128 * 100
    assert work.prefill_flops(m, 3) == (2 * 3 * 48 * 616_562_688 + 48 * 4 * 7168 * 6
                                        + 2 * 360_349_696)


def test_opt_30b_offload_ratio():
    m = model("opt-30b")
    card = 85_017_624_576                    # an H100 80GB HBM3 as torch reads it (79.18 GiB)
    for name in ("azure-conv", "azure-code"):
        mix = clients.load_mix(name)
        mix["engine"]["hbm_budget_bytes"] = clients.hbm_budget(mix, card)
        assert mix["engine"]["hbm_budget_bytes"] == pytest.approx(0.9 * card - 10e9)
        # 16 slots x 2048 tokens of KV: 45.097 GB beside 59.911 GB of weights
        assert work.kv_pool_bytes(m, mix) == 16 * 2048 * 1_376_256 == 45_097_156_608
        footprint = 2 * 29_955_358_720 + 45_097_156_608
        assert work.offload_ratio(m, mix) == pytest.approx(1 - (0.9 * card - 10e9) / footprint)
        assert work.offload_ratio(m, mix) == pytest.approx(0.366563, abs=1e-5)
    with pytest.raises(ValueError):
        clients.hbm_budget(clients.load_mix("azure-conv"), None)
    # a budget that holds everything offloads nothing
    roomy = {"engine": {"hbm_budget_bytes": 2e11}, "clients": 16, "max_len": 2048}
    assert work.offload_ratio(m, roomy) == 0.0


def test_moe_arithmetic():
    m = {"family": "moe", "n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 6, "vocab": 10, "n_experts": 4, "top_k": 2, "moe_d_ff": 6}
    assert work.expert_params(m) == 3 * 8 * 6
    # one row reaches its 2 experts; many reach all 4
    assert work.experts_reached(m, 1) == pytest.approx(2.0)
    assert work.experts_reached(m, 64) == pytest.approx(4.0)
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8
    assert work.weight_params(m) == 2 * (attn + 8 * 4 + 4 * 144) + 2 * 80
    assert work.step_weight_params(m, 1) == 2 * (attn + 8 * 4 + 2 * 144) + 80


def test_bound_takes_the_slowest_resource():
    assert work.bound_s(3.35e12, 0, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 64e9, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 0, 989e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e12, 128e9, 0) == pytest.approx(2.0)
    assert work.split_bound_s(128e9, 0.5, 0) == pytest.approx(1.0)
    assert (peaks.BF16_FLOPS, peaks.HBM_BYTES_S, peaks.LINK_BYTES_S) == (989e12, 3.35e12, 64e9)
