"""The port's kernel lints (`repro_torch.analysis.kernel_lints`, DAK101-103
over the CUDA kernels): each rule fires on a seeded violation, the
schedule and alignment checks give the reference's findings on the same
inputs, every served config is clean at full width, and the shared-memory
footprints equal the numbers worked by hand from the `.cu` formulas."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.analysis import kernel_lints as JKL
from repro.analysis import surface as JS
from repro.core import engine as JE
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro_torch.analysis import kernel_lints as KL
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.core.tiering import split_sizes
from repro_torch.kernels import splitk_flashattn as A
from repro_torch.kernels import splitk_gemm as G
from repro_torch.kernels.autotune import Autotuner

FP = KL.flash_prefill
BF, F32 = torch.bfloat16, torch.float32


def _rules(findings) -> set[str]:
    return {f.rule for f in findings}


def _gemm(**kw) -> KL.GemmLaunch:
    base = dict(name="w", m=4, k=4096, n_loc=2048, n_rem=2048, k_split=800, window=2,
                dtype_bytes=2)
    return KL.GemmLaunch(**{**base, **kw})


def test_clean_launches_have_no_finding():
    assert KL.check_gemm_launch(_gemm(), H100_SXM) == []
    assert KL.check_gemm_launch(_gemm(m=128, k_split=0, window=8), H100_SXM) == []
    assert KL.check_attn_launch(KL.AttnLaunch("a", "paged", 32, 32, 128, 16, 10, 1, 2),
                                H100_SXM) == []
    assert KL.check_prefill_launch(KL.PrefillLaunch("p", 128, 2048, 2048, dtype_bytes=2),
                                   H100_SXM) == []


def test_dak101_fires_on_shared_memory_and_on_a_clamped_window():
    # a window past the split-K ring's DSMEM_MAX: fp32, M 16, 8-stage ring per 10 KB
    fs = KL.check_gemm_launch(_gemm(m=16, k_split=4096, window=64, dtype_bytes=4), H100_SXM)
    assert _rules(fs) == {"DAK101"} and "DSMEM_MAX" in fs[0].detail
    # the whole-K ring stops at 8 stages
    fs = KL.check_gemm_launch(_gemm(m=128, k_split=0, window=9), H100_SXM)
    assert _rules(fs) == {"DAK101"} and "MAX_WINDOW" in fs[0].detail
    # no finding for a ring cut to the loads a CTA has
    assert KL.check_gemm_launch(_gemm(k_split=32, window=8), H100_SXM) == []
    # a paged launch whose one stage of K and V boxes alone passes 227 KiB
    big = KL.AttnLaunch("a", "paged", 8, 8, 1024, 64, 4, 1, 4)
    fs = KL.check_attn_launch(big, H100_SXM)
    assert {"DAK101"} == _rules(fs) and any("232448" in f.detail for f in fs)
    assert any("RING_MAX" in f.detail for f in fs)
    # the attention ring's cap of 8 loads in flight
    fs = KL.check_attn_launch(KL.AttnLaunch("a", "batch", 32, 32, 32, 32, 40, 12, 2),
                              H100_SXM)
    assert _rules(fs) == {"DAK101"} and "MAX_WINDOW" in fs[0].detail
    # the limit is the per-CTA opt-in, not the profile's whole-chip vmem_bytes
    assert KL.SMEM_OPTIN_BYTES == 227 * 1024 < H100_SXM.vmem_bytes


def test_dak102_fires_on_the_tma_rules():
    cases = [_gemm(k_split=48),                        # not a multiple of DECODE_BK
             _gemm(m=17),                              # the split-K design takes M <= 16
             _gemm(n_rem=2044),                        # a row of 4088 B
             _gemm(aligned=False),                     # a base off 16 bytes
             _gemm(box_n=512),                         # a box past 256 elements
             _gemm(n_loc=0, n_rem=0)]                  # degenerate
    for g in cases:
        assert _rules(KL.check_gemm_launch(g, H100_SXM)) == {"DAK102"}, g
    assert KL.check_gemm_launch(_gemm(m=17, k_split=0), H100_SXM) == []   # whole K takes it
    attn = [KL.AttnLaunch("a", "paged", 32, 32, 128, 512, 4, 1, 2, tma=True),
            KL.AttnLaunch("a", "paged", 32, 32, 60, 16, 4, 1, 2, tma=True),   # 120-B rows
            KL.AttnLaunch("a", "batch", 30, 8, 128, 32, 4, 1, 2),
            KL.AttnLaunch("a", "paged", 8, 8, 2048, 16, 4, 1, 2)]
    for a in attn:
        assert _rules(KL.check_attn_launch(a, H100_SXM)) == {"DAK102"}, a
    assert KL.check_attn_launch(dataclasses.replace(attn[1], tma=None), H100_SXM) == []
    for p in (KL.PrefillLaunch("p", 128, 256, 256, block_q=64, dtype_bytes=2),
              KL.PrefillLaunch("p", 512, 256, 256)):
        assert _rules(KL.check_prefill_launch(p, H100_SXM)) == {"DAK102"}


@pytest.mark.parametrize("hd,db,tiles,other", [
    (128, 2, (128, 128), (128, 64)),     # the wgmma design; mma.sync's tile is a finding here
    (64, 2, (128, 128), (128, 64)),
    (80, 2, (128, 64), (128, 128)),      # the mma.sync design
    (128, 4, (64, 64), (128, 64)),       # the FMA design
])
def test_dak102_holds_each_design_to_its_tiles(hd, db, tiles, other):
    """A tuned prefill tile must be the one the launch's design is compiled
    with (`flash_prefill.tiles`), which depends on hd as well as dtype."""
    ok = KL.PrefillLaunch("p", hd, 256, 256, block_q=tiles[0], block_k=tiles[1],
                          dtype_bytes=db)
    assert KL.check_prefill_launch(ok, H100_SXM) == []
    fs = KL.check_prefill_launch(dataclasses.replace(ok, block_q=other[0], block_k=other[1]),
                                 H100_SXM)
    assert _rules(fs) == {"DAK102"}
    assert FP.design(hd, {2: BF, 4: F32}[db]) in fs[0].detail


def test_dak103_fires_on_grid_coverage_and_schedules():
    fs = KL.check_gemm_launch(_gemm(grid=5), H100_SXM)
    assert _rules(fs) == {"DAK103"}
    assert KL.check_gemm_launch(_gemm(grid=(32 + 32) * 6), H100_SXM) == []
    order = G.host_first_order(2, 3, 2)
    assert sorted(order.tolist()) == list(range(10)) and order[:6].min() == 4
    broken = order.copy()
    broken[1] = broken[0]
    assert _rules(KL.check_order_permutation(broken, 10)) == {"DAK103"}
    assert _rules(KL.check_prefill_launch(KL.PrefillLaunch("p", 64, 65536 * 128 + 1, 16,
                                                           dtype_bytes=2), H100_SXM)) \
        == {"DAK103"}


def test_grouped_lints_pass_on_the_qwen3_plan_and_fire_on_broken_geometry():
    """The grouped remote-expert launches of Qwen3-30B-A3B's served plan at
    offload 0.5, at decode and at 2048- and 4096-token prefills (expert rows
    1, 192, 384), are clean in bf16 and fp32; each rule fires on a geometry
    broken on purpose."""
    cfg = TC.get("qwen3_moe_30b_a3b")
    shapes = KL.operand_shapes(cfg)
    plan = TE.plan(cfg, TWorkload(batch=4, seq_len=256, phase="decode"), H100_SXM,
                   global_ratio=0.5, kv_page_size=16)
    for tokens in (2048, 4096):
        launches = KL.describe_grouped_launches(cfg, plan, shapes, align=128, batch=4,
                                                prefill_tokens=tokens, dtype_bytes=2)
        assert [(g.name, g.e, g.m) for g in launches] == [
            ("layers/experts_wi@decode", 64, 1), ("layers/experts_wi@prefill", 64, tokens // 2048 * 192),
            ("layers/experts_wdown@decode", 64, 1),
            ("layers/experts_wdown@prefill", 64, tokens // 2048 * 192)]
        for db in (2, 4):
            for g in launches:
                assert KL.check_grouped_launch(dataclasses.replace(g, dtype_bytes=db),
                                               H100_SXM) == [], g
        assert KL.check_kernels(cfg, plan, H100_SXM, shapes, align=128, dtype_bytes=2,
                                max_len=tokens) == []
    wi = KL.GroupedGemmLaunch("wi", e=64, m=384, k=2048, n=1536, window=1)
    assert G.grouped_tiling(384, BF).cluster == 6
    # DAK101: a window whose ring of 6 x 64 / 2 stages passes 227 KiB
    fs = KL.check_grouped_launch(dataclasses.replace(wi, window=64), H100_SXM)
    assert _rules(fs) == {"DAK101"} and "CLUSTER_SMEM_MAX" in fs[0].detail
    # DAK102: rows off 16 bytes, an unaligned base, an unswizzlable box, a K
    # split off the box, the cluster design in fp32
    for bad in (dict(n=1532), dict(aligned=False), dict(box=(32, 64)), dict(k_split=96),
                dict(dtype_bytes=4, design="cluster")):
        assert _rules(KL.check_grouped_launch(dataclasses.replace(wi, **bad), H100_SXM)) \
            == {"DAK102"}, bad
    # DAK103: a cluster past 8, an M axis not of whole clusters, rows left
    # out, a dead cluster, N tiles missing
    for bad in (dict(cluster=12, grid=(24, 64, 12)), dict(grid=(24, 64, 7)),
                dict(mb=32), dict(grid=(24, 64, 12)), dict(grid=(23, 64, 6))):
        assert _rules(KL.check_grouped_launch(dataclasses.replace(wi, **bad), H100_SXM)) \
            == {"DAK103"}, bad


def _same(port, ref) -> None:
    assert [(f.rule, f.where, f.detail) for f in port] == \
        [(f.rule, f.where, f.detail) for f in ref]


def test_schedule_checks_give_the_reference_findings():
    rng = np.random.default_rng(0)
    orders = [np.array([0, 1, 1, 3]), np.array([2, 3, 0, 1]), np.arange(5), np.array([4, 1])]
    for o in orders:
        _same(KL.check_order_permutation(o, 4), JKL.check_order_permutation(o, 4))
    assert G.host_first_order(3, 4).tolist() == JKL.splitk_gemm.host_first_order(3, 4).tolist()
    for trial in range(20):
        b, mp, ps = int(rng.integers(1, 9)), int(rng.integers(1, 7)), int(rng.integers(1, 9))
        tier = rng.integers(0, 2, size=(b, mp)).astype(np.int32)
        lens = rng.integers(0, mp * ps + 1, size=b).astype(np.int32)
        _same(KL.check_paged_slot_order(tier, lens, ps, where=f"t{trial}"),
              JKL.check_paged_slot_order(tier, lens, ps, where=f"t{trial}"))
        assert A.host_first_slot_order(tier, lens, ps).tolist() == \
            np.asarray(JKL.splitk_flashattn.host_first_slot_order(tier, lens, ps)).tolist()


@pytest.mark.parametrize("arch", ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
                                  "zamba2_2p7b", "opt_30b"])
def test_alignment_invariants_give_the_reference_findings(arch):
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    shapes = KL.operand_shapes(tcfg)
    assert shapes == JS.operand_shapes(jcfg)
    wl = dict(batch=4, seq_len=256, phase="decode")
    odd = {k: (*v[:-1], v[-1] - 36) for k, v in shapes.items()}   # ragged last dims
    for ratio in (0.3, 0.5, 1.0):
        jp = JE.plan(jcfg, JWorkload(**wl), J_TPU, global_ratio=ratio, kv_page_size=16)
        tp = TE.plan(tcfg, TWorkload(**wl), T_TPU, global_ratio=ratio, kv_page_size=16)
        for sh in (shapes, odd):
            for align in (1, 128, 100):
                _same(KL.check_alignment_invariants(tp, sh, align=align),
                      JKL.check_alignment_invariants(jp, sh, align=align))


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_check_kernels_clean_for_every_served_config(arch):
    """Every config id at full width and offload {0, 0.5, 1}, in bf16 (what
    the card serves), with and without a tuner; in fp32 too, where only
    MLA's 576-wide pages of 16 rows leave the ring one stage under RING_MAX."""
    cfg = TC.get(arch)
    shapes = KL.operand_shapes(cfg)
    align = 32 if cfg.d_model < 1024 else 128
    for ratio in (0.0, 0.5, 1.0):
        plan = TE.plan(cfg, TWorkload(batch=4, seq_len=256, phase="decode"), H100_SXM,
                       global_ratio=ratio, kv_page_size=16)
        assert KL.check_kernels(cfg, plan, H100_SXM, shapes, align=align, dtype_bytes=2) == []
        tuner = Autotuner()
        assert KL.check_kernels(cfg, plan, H100_SXM, shapes, align=align, dtype_bytes=2,
                                tuner=tuner) == [] and tuner.validate() == []
        f32 = KL.check_kernels(cfg, plan, H100_SXM, shapes, align=align)
        if cfg.use_mla:
            assert {(f.rule, "RING_MAX" in f.detail) for f in f32} == {("DAK101", True)}
        else:
            assert f32 == []
    gemms, attns, _ = KL.describe_launches(cfg, plan, shapes, align=align, batch=4,
                                           max_len=256, dtype_bytes=2)
    tiered = []       # column-split operands whose remote extent is not rounded away
    for od in plan.registry:
        shape = shapes.get(od.path_str)
        if shape is None or od.axis % len(shape) != len(shape) - 1:
            continue
        ratio = plan.op_ratios.get(od.op, 0.0)
        if ratio > 0 and split_sizes(shape[-1], ratio, od.align or align)[1] > 0:
            tiered.append(od.path_str)
    assert [g.name for g in gemms] == tiered and tiered
    assert bool(attns) == (plan.kv_pages is not None)


def test_footprints_match_hand_worked_numbers():
    # split-K (splitk_gemm.cu decode_smem): M 4 -> MB 4; bf16 stage
    # (32*64 + 4*32) * 2 = 4352 B, a multiple of 128; window 2 of 25 loads
    assert G.smem_footprint_bytes(4, 4096, 2048, 2048, window=2, k_split=800, dtype=BF) \
        == 2 * (4352 + 8)
    # fp32 M 16: (2048 + 512) * 4 = 10240 B a stage; window 64 cut by
    # DSMEM_MAX = 204800 to 20 stages
    assert G.ring_stages(16, 4096, window=64, k_split=4096, dtype=F32) == (20, "DSMEM_MAX")
    assert G.smem_footprint_bytes(16, 4096, 1, 1, window=64, k_split=4096, dtype=F32) \
        == 20 * (10240 + 8)
    # M 3 -> MB 4 in fp32: 8704 B; a split of 32 rows has one load
    assert G.smem_footprint_bytes(3, 4096, 1, 1, window=8, k_split=32, dtype=F32) == 8712
    # whole K (whole_k_smem): BM 128 at M 128, window 9 -> 8 stages of
    # (128*32 + 32*64) * 2 B
    assert G.smem_footprint_bytes(128, 4096, 1, 1, window=9, k_split=0, dtype=BF) \
        == 8 * 6144 * 2
    # BM 16 at M 4, K 40 has 2 chunks: window 8 -> 2 stages of (512 + 2048) * 4 B
    assert G.smem_footprint_bytes(4, 40, 1, 1, window=8, k_split=0, dtype=F32) == 2 * 10240
    # paged (paged_flashattn.cu paged_smem): llama2-7b bf16, page 16 x 128: a
    # 4096-B box; window 1 -> 2 stages = 16384 B (merge 4*1*130*4 = 2080 is
    # smaller), 2 mbarriers, (10 pages + 4 slots) ints
    assert A.paged_smem_footprint_bytes(4, 32, 32, 128, 16, 10, window=1, dtype=BF) \
        == 16384 + 16 + 56
    # MLA bf16, 576 wide (paged_flashattn.cu cluster_smem): 9 boxes of 64
    # columns, each a slot of 16 rows x 128 B; V taken from the K pool, so a
    # stage is 9 * 2048 = 18432 B; window 4 -> 5 stages, each with a full and
    # an empty mbarrier, beside 1024 B of alignment slack, Q (9 * 2048), the
    # partial scores (2 buffers x 4 warps x 32 lanes x 8 floats) and (10
    # pages + 4 slots) ints
    assert A.paged_smem_footprint_bytes(4, 128, 1, 576, 16, 10, window=4, dtype=BF,
                                        alias_v=True) \
        == 1024 + 18432 + 8192 + 56 + 5 * (18432 + 16)
    # a separate V pool doubles a stage to 36864 B: 227 KB less 128 B holds 5
    mla = A.paged_design(4, 128, 1, 576, 16, 10, window=8, dtype=BF)
    assert (mla.name, mla.cluster, mla.stages, mla.cut) == ("cluster", 8, 5, "SMEM_MAX")
    # fp32 keeps the head-group design: a 36864-B box, 73728 a stage of K and
    # V; RING_MAX 98304 fits 1
    assert A.ring_stages(4, 2 * 36864, 10) == (1, "RING_MAX")
    # a GQA group at hd 128 (DPL 4: up to 8 heads a CTA): the merge scratch,
    # 4 warps * 8 heads * (32*4 + 2) floats = 16640 B, outgrows a ring of 2
    # stages of two 256-B boxes (pages of 1 bf16 row)
    assert A.paged_smem_footprint_bytes(2, 32, 8, 128, 1, 4, window=1, dtype=BF) \
        == 16640 + 16 + 24
    # batch-split (splitk_flashattn.cu split_smem): CHUNK 32 rows x 128 bf16 =
    # 8192-B box; kv 288 -> 9 chunks; window 1 -> 2 stages
    assert A.smem_footprint_bytes(32, 32, 128, 288, window=1, dtype=BF) == 2 * 16384 + 16
    # window 8 -> 9 stages, RING_MAX 98304 / 16384 fits 6
    assert A.smem_footprint_bytes(32, 32, 128, 288, window=8, dtype=BF) == 6 * 16384 + 48
    # flash_prefill (fma_smem, tc_smem, wg_smem): fp32 (3*64*(hd+1) + 64*65 +
    # 192) * 4; bf16 off hd 64 and 128 (mma.sync) (128 + 4*64) * (padded hd +
    # 8) * 2; bf16 at hd 64 and 128 (wgmma) 1024 + (128 + 4*128) * hd * 2 + 9 * 8
    assert FP.smem_footprint_bytes(128, dtype=F32) == (3 * 64 * 129 + 64 * 65 + 192) * 4
    assert FP.smem_footprint_bytes(80, dtype=BF) == 384 * 136 * 2
    assert FP.smem_footprint_bytes(256, dtype=F32) == 214784 <= KL.SMEM_OPTIN_BYTES
    assert FP.smem_footprint_bytes(128, dtype=BF) == 1024 + 640 * 256 + 72 == 164936
    assert FP.smem_footprint_bytes(128, dtype=BF, which="mma") == 384 * 136 * 2


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_prefill_gemm_lints_clean_for_every_served_config(arch):
    """Every tiered column-split GEMM of every config id at offload 0.5, at
    the prefill of 128, 704 and 2048 tokens in bf16, is a clean cluster
    launch (DAK101-103): no served shape falls to whole K, whose rows a
    tensor map could not describe."""
    cfg = TC.get(arch)
    shapes = KL.operand_shapes(cfg)
    align = 32 if cfg.d_model < 1024 else 128
    plan = TE.plan(cfg, TWorkload(batch=4, seq_len=256, phase="decode"), H100_SXM,
                   global_ratio=0.5, kv_page_size=16)
    for tokens in (128, 704, 2048):
        gemms, _, _ = KL.describe_launches(cfg, plan, shapes, align=align, batch=4, max_len=256,
                                           dtype_bytes=2, prefill_tokens=tokens)
        prefill = [g for g in gemms if g.name.endswith("@prefill")]
        assert len(prefill) == len(gemms) // 2 and prefill
        assert [g.name for g in prefill if g.k_split == 0] == []     # none keeps whole K
        for g in prefill:
            assert g.m == tokens and KL.check_gemm_launch(g, H100_SXM) == [], g
            t = G.gemm_tiling(g.m, g.k, g.n_loc, g.n_rem, BF, k_split=g.k_split)
            assert t.design == "cluster" and t.reads == -(-tokens // 1024)


def test_cluster_gemm_lints_fire_on_broken_geometry():
    """llama2-7b's wi at offload 0.5 and 2048 rows: 16 M tiles of 128 in two
    clusters of 8, one K split; each rule fires on a geometry broken on
    purpose."""
    wi = KL.GemmLaunch("wi", m=2048, k=4096, n_loc=11008, n_rem=11008, k_split=4096, window=2,
                       dtype_bytes=2)
    assert G.gemm_tiling(2048, 4096, 11008, 11008, BF).grid == (344 * 2, 1, 8)
    assert KL.check_gemm_launch(wi, H100_SXM) == []
    # DAK101: a window whose ring of 8 x 64 / 2 stages of 24 KB passes 227 KiB
    fs = KL.check_gemm_launch(dataclasses.replace(wi, window=64), H100_SXM)
    assert _rules(fs) == {"DAK101"} and "CLUSTER_SMEM_MAX" in fs[0].detail
    # DAK102: rows off 16 bytes, an unaligned base, a box row of 64 B (no
    # 128-byte swizzle), a K split off the 64-row box
    for bad in (dict(n_rem=11004), dict(aligned=False), dict(box_n=32), dict(k_split=96)):
        assert _rules(KL.check_gemm_launch(dataclasses.replace(wi, **bad), H100_SXM)) \
            == {"DAK102"}, bad
    # DAK103: a cluster past 8, N tiles missing, rows left out, a dead
    # cluster row, splits that leave K uncovered
    for bad in (dict(cluster=12, grid=(688, 1, 12), window=1), dict(grid=(687, 1, 8)),
                dict(grid=(344, 1, 8)), dict(grid=(344 * 3, 1, 8)), dict(grid=688),
                dict(mb=64)):
        assert _rules(KL.check_gemm_launch(dataclasses.replace(wi, **bad), H100_SXM)) \
            == {"DAK103"}, bad
