"""The port's CUDA kernels and engine on the card, against their plain
PyTorch versions on the same inputs.  Every test here is marked `gpu` and
skips without a card; run them on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.  Bounds are
the reference's kernel tolerances: 2e-4 relative in fp32, 5e-2 in bf16."""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.tiering import TieredTensor
from repro_torch.kernels import _build, flash_prefill, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.splitk_flashattn import (
    _launch_paged,
    _paged_launch,
    launch_design,
    paged_reads,
    paged_splitk_flashattn,
    scatter_rows,
    scatter_rows_ref,
    splitk_flashattn,
)
from repro_torch.kernels.splitk_gemm import (
    _launch_grouped,
    gemm_tiling,
    grouped_tiling,
    splitk_gemm,
    splitk_gemm_grouped,
)
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving import tiered_decode as TD
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged_cache import PagedTieredCache
from torch_helpers import (  # noqa: F401  (cuda_device is a fixture)
    SERVE_PROMPT_LENS,
    assert_trees_equal,
    cuda_device,
    rel_err,
)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def _pinned(t: torch.Tensor) -> torch.Tensor:
    out = _build.pinned_empty(t.shape, t.dtype)
    out.copy_(t)
    return out


def test_pinned_tier_is_mapped_host_memory(cuda_device):
    t = _pinned(torch.arange(10, dtype=torch.float32, device=cuda_device))
    assert t.device.type == "cpu" and t.is_pinned()
    assert _build.load().libs["host_mem"].dak_check_mapped(t.data_ptr()) == 0
    assert _build.load().libs["host_mem"].dak_check_mapped(torch.ones(4).data_ptr()) != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n_loc,n_rem", [(4, 256, 128, 128), (33, 200, 136, 72),
                                             (5, 100, 0, 30), (7, 64, 64, 0),
                                             (129, 320, 136, 200), (704, 320, 0, 200),
                                             (2000, 320, 136, 0)])
@pytest.mark.parametrize("window", [1, 2, 4])
def test_splitk_gemm_matches_plain(cuda_device, dtype, m, k, n_loc, n_rem, window):
    """Every design (bf16 past 16 rows the cluster design) against the plain
    version; a second launch bitwise equal, and the host bytes counted equal
    to the tiling model (`gemm_tiling(...).reads` remote tiers)."""
    gen = torch.Generator(device=cuda_device).manual_seed(m * k)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    wl = torch.randn((k, n_loc), generator=gen, device=cuda_device).to(dtype)
    wr_dev = torch.randn((k, n_rem), generator=gen, device=cuda_device).to(dtype)
    wr = _pinned(wr_dev)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    tiling = gemm_tiling(m, k, n_loc, n_rem, dtype, sm_count=sms)
    before = splitk_gemm.launches
    splitk_gemm.host_bytes.reset()
    got = splitk_gemm(x, wl, wr, window=window)
    torch.cuda.synchronize()
    assert splitk_gemm.launches == before + 1
    assert int(splitk_gemm.host_bytes) == tiling.reads * wr.nbytes
    assert rel_err(got, tref.splitk_gemm_ref(x, wl, wr_dev)) < TOL[dtype]
    assert torch.equal(splitk_gemm(x, wl, wr, window=window), got)
    if n_rem:
        # a serving mesh's remote tier, gathered on the card: the same bits
        assert torch.equal(splitk_gemm(x, wl, wr_dev, window=window), got)
        with pytest.raises(ValueError, match="pinned host memory"):
            splitk_gemm(x, wl, wr_dev.cpu(), window=window)     # unpinned host memory
        with pytest.raises(ValueError, match="pinned host memory"):
            splitk_gemm(x, wl, torch.empty_like(wr_dev, device="meta"), window=window)


# id: B, H, Kh, hd, page, MP (table width), pool pages per tier, lens, the
# pages' tiers ("mixed" at random, "local", "remote"), scale, V read from K
PAGED_CASES = {
    "gqa-small": (4, 8, 2, 32, 8, 4, (6, 5), (5, 0, 17, 32), "mixed", None, False),
    "gqa-small-scale": (4, 8, 2, 32, 8, 4, (6, 5), (5, 0, 17, 32), "mixed", 0.11, False),
    "full-width": (4, 32, 32, 128, 16, 10, (20, 20), (150, 144, 139, 158), "mixed", None, False),
    "full-width-edge-lens": (4, 32, 32, 128, 16, 10, (20, 20), (0, 1, 16, 17), "mixed", None,
                             False),
    "full-width-long": (4, 32, 32, 128, 16, 128, (300, 300), (2048, 1937, 17, 0), "mixed",
                        None, False),
    "full-width-all-local": (3, 32, 32, 128, 16, 40, (100, 4), (640, 300, 1), "local", None,
                             False),
    "full-width-all-remote": (3, 32, 32, 128, 16, 40, (4, 100), (640, 0, 33), "remote", None,
                              False),
    "gqa-full-width-long": (2, 32, 8, 128, 16, 64, (90, 90), (1024, 999), "mixed", None, False),
    "k-only-16-heads": (3, 16, 1, 72, 4, 64, (80, 80), (7, 250, 3), "mixed", 0.07, True),
    "hd30": (3, 4, 2, 30, 4, 40, (50, 50), (9, 0, 150), "mixed", None, False),
    "hd576": (2, 8, 1, 576, 16, 12, (20, 20), (180, 33), "mixed", None, False),
    "hd1024": (2, 2, 2, 1024, 16, 6, (10, 10), (90, 16), "mixed", None, False),
    # DeepSeek-V2's MLA decode: 128 heads over one latent kv head of width
    # kv_lora 512 + rope 64, V read from the K pool, scale (nd + rd)**-0.5;
    # bf16 runs the cluster design (blocks of 16 heads, clusters of up to 8
    # a slot): one block (G 16), one cluster of 8 (G 128), two clusters of 5
    # (G 144), every page local or remote, lengths 0, 1, 16 and 17, a long
    # cache
    "mla-full-width": (4, 128, 1, 576, 16, 10, (20, 20), (150, 0, 37, 160), "mixed",
                       192 ** -0.5, True),
    "mla-g16": (3, 16, 1, 576, 16, 10, (20, 20), (150, 0, 37), "mixed", 192 ** -0.5, True),
    "mla-g144": (2, 144, 1, 576, 16, 10, (20, 20), (150, 17), "mixed", 192 ** -0.5, True),
    "mla-all-local": (3, 128, 1, 576, 16, 10, (40, 4), (160, 1, 16), "local", 192 ** -0.5,
                      True),
    "mla-all-remote": (3, 128, 1, 576, 16, 10, (4, 40), (17, 0, 150), "remote", 192 ** -0.5,
                       True),
    "mla-edge-lens": (4, 128, 1, 576, 16, 10, (20, 20), (0, 1, 16, 17), "mixed", 192 ** -0.5,
                      True),
    "mla-long": (2, 128, 1, 576, 16, 128, (300, 300), (2048, 1937), "mixed", 192 ** -0.5,
                 True),
    # the dense variants' decode shapes: OPT-30B (56 heads padded to 112 over
    # 56 kv heads), Qwen2.5-14B (48 padded heads over 8), ChatGLM3-6B and
    # StarCoder2-3B (32 over 2: a group of 16, split across CTAs)
    "opt30b-h112-kh56": (4, 112, 56, 128, 16, 10, (20, 20), (150, 0, 37, 160), "mixed", None,
                         False),
    "qwen2p5-h48-kh8": (4, 48, 8, 128, 16, 10, (20, 20), (150, 0, 37, 160), "mixed", None,
                        False),
    "chatglm3-h32-kh2": (4, 32, 2, 128, 16, 10, (20, 20), (150, 0, 37, 160), "mixed", None,
                         False),
    # Zamba2-2.7B's shared attention: 32 heads over 32 kv heads of 80, a TMA
    # box row of 160 B (bf16) or 320 B (fp32)
    "zamba2-h32-kh32-hd80": (4, 32, 32, 80, 16, 10, (20, 20), (150, 0, 37, 160), "mixed", None,
                             False),
}


def _paged_case(case, dtype, dev):
    b, h, kh, hd, ps, mp, (p_loc, p_rem), lens, tiers, scale, alias_v = PAGED_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + mp)
    q = torch.from_numpy(rng.normal(size=(b, h, hd))).to(dev, dtype)
    pools_dev = {n: torch.from_numpy(rng.normal(size=(p + 1, ps, kh, hd))).to(dev, dtype)
                 for n, p in (("k_local", p_loc), ("v_local", p_loc), ("k_remote", p_rem),
                              ("v_remote", p_rem))}
    if alias_v:
        pools_dev["v_local"], pools_dev["v_remote"] = pools_dev["k_local"], pools_dev["k_remote"]
    pools = {k: v for k, v in pools_dev.items() if k.endswith("local")}
    pools["k_remote"] = _pinned(pools_dev["k_remote"])
    pools["v_remote"] = pools["k_remote"] if alias_v else _pinned(pools_dev["v_remote"])
    tier = {"mixed": rng.integers(0, 2, size=(b, mp)), "local": np.zeros((b, mp), np.int64),
            "remote": np.ones((b, mp), np.int64)}[tiers]
    table = np.where(tier > 0, rng.integers(0, p_rem, size=(b, mp)),
                     rng.integers(0, p_loc, size=(b, mp)))
    as_dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    return q, pools, pools_dev, as_dev(table), as_dev(tier), as_dev(lens), lens, scale


@pytest.mark.parametrize("window", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_attention_matches_plain(cuda_device, case, dtype, window):
    """Paged attention at small and full width (H = Kh = 32, hd 128, page
    16), lengths 0, 1, 16 and 17 and long caches (up to 2048), every page
    local or every page remote, GQA, V read from the K pool, a `scale`
    override, hd 30 and hd above 256 (bf16: the cluster design; fp32:
    element loads), MLA's 128 heads and 16, 144; one launch per call, zeros
    for lens 0, the same bits on a second launch, and the remote bytes
    counted on the card equal to `paged_reads` for the design launched."""
    q, pools, pools_dev, table, tier, lens_t, lens, scale = _paged_case(case, dtype, cuda_device)
    design = launch_design(q, pools["k_local"], pools["v_local"], pools["k_remote"],
                           pools["v_remote"], table, window)
    b, h, hd = q.shape
    _, ps, kh, _ = pools["k_local"].shape
    model = paged_reads(tier.cpu().numpy(), np.asarray(lens), ps, h, kh, hd, ELEM_BYTES[dtype],
                        alias=design.alias, heads_per_cta=design.heads_per_cta,
                        cluster=design.cluster)
    assert design.name == ("cluster" if dtype == torch.bfloat16 and hd > 256 else "head-group")
    before = paged_splitk_flashattn.launches
    paged_splitk_flashattn.host_bytes.reset()
    got = ops.paged_decode_attention(q, pools, table, tier, lens_t, window=window, scale=scale)
    again = ops.paged_decode_attention(q, pools, table, tier, lens_t, window=window,
                                       scale=scale)
    torch.cuda.synchronize()
    assert paged_splitk_flashattn.launches == before + 2
    assert int(paged_splitk_flashattn.host_bytes) == 2 * model
    want = tref.paged_flashattn_ref(q, pools_dev["k_local"], pools_dev["v_local"],
                                    pools_dev["k_remote"], pools_dev["v_remote"],
                                    table, tier, lens_t, scale=scale)
    assert rel_err(got, want) < TOL[dtype]
    assert torch.equal(got, again)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(got[i] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["gqa-small", "full-width", "full-width-all-remote",
                                  "mla-full-width", "zamba2-h32-kh32-hd80"])
def test_paged_attention_gathered_remote_pools_on_card(cuda_device, case, dtype):
    """A serving mesh gathers the remote pools into device buffers: paged
    attention over them gives the pinned pools' result bit for bit, and a
    remote pool in unpinned host memory or on another device is refused."""
    q, pools, pools_dev, table, tier, lens_t, _, scale = _paged_case(case, dtype, cuda_device)
    got = ops.paged_decode_attention(q, pools, table, tier, lens_t, window=2, scale=scale)
    gathered = {**pools, "k_remote": pools_dev["k_remote"], "v_remote": pools_dev["v_remote"]}
    before = paged_splitk_flashattn.launches
    on_card = ops.paged_decode_attention(q, gathered, table, tier, lens_t, window=2,
                                         scale=scale)
    torch.cuda.synchronize()
    assert paged_splitk_flashattn.launches == before + 1
    assert torch.equal(on_card, got)
    for bad in (pools_dev["k_remote"].cpu(), torch.empty_like(pools_dev["k_remote"],
                                                              device="meta")):
        with pytest.raises(ValueError, match="pinned host memory"):
            ops.paged_decode_attention(q, {**gathered, "k_remote": bad, "v_remote": bad},
                                       table, tier, lens_t, scale=scale)


@pytest.mark.parametrize("case", ["mla-full-width", "mla-g144", "mla-all-remote", "hd576"])
def test_mla_cluster_design_reads_each_page_once_per_cluster(cuda_device, case):
    """The cluster design against the head-group design it replaced at bf16
    above hd 256 (both through the wrapper's private launch): the same
    attention within the bf16 bound, and the remote bytes counted once per
    cluster (V from the K stage when the pools alias) against once per CTA
    and per K and V box."""
    q, pools, _, table, tier, lens_t, lens, scale = _paged_case(case, torch.bfloat16,
                                                                 cuda_device)
    args = (q, pools["k_local"], pools["v_local"], pools["k_remote"], pools["v_remote"], table)
    b, h, hd = q.shape
    _, ps, kh, _ = pools["k_local"].shape
    got, counted, model = {}, {}, {}
    for design in (None, "head-group"):
        d = launch_design(*args, 2, design)
        model[d.name] = paged_reads(tier.cpu().numpy(), np.asarray(lens), ps, h, kh, hd, 2,
                                    alias=d.alias, heads_per_cta=d.heads_per_cta,
                                    cluster=d.cluster)
        paged_splitk_flashattn.host_bytes.reset()
        got[d.name] = _launch_paged(_paged_launch(*args, tier, lens_t, 2, scale, design))
        torch.cuda.synchronize()
        counted[d.name] = int(paged_splitk_flashattn.host_bytes)
    assert counted == model and set(counted) == {"cluster", "head-group"}
    assert rel_err(got["cluster"], got["head-group"]) < TOL[torch.bfloat16]
    # MLA's 128 heads: each remote page 256 times (128 CTAs x K and V) against
    # once; G heads in ceil(G / 128) clusters in general
    g, loads = h // kh, 1 if PAGED_CASES[case][-1] else 2
    assert counted["cluster"] > 0
    assert counted["head-group"] * loads * -(-g // 128) == counted["cluster"] * 2 * g


def test_scatter_rows_into_a_gathered_remote_pool(cuda_device):
    """The row writer takes the remote tier on the card (a mesh's gathered
    pool) as it takes the pinned one."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    pool_dev = torch.randn((7, 4, 2, 8), generator=gen, device=cuda_device)
    rows = torch.randn((3, 2, 8), generator=gen, device=cuda_device)
    wr_tier = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda_device)
    wr_idx = torch.tensor([2, 5, 0], dtype=torch.int32, device=cuda_device)
    wr_off = torch.tensor([3, 1, 0], dtype=torch.int32, device=cuda_device)
    pool = pool_dev.clone()
    scatter_rows(pool, rows, wr_tier, wr_idx, wr_off, 1, 6, remote=True)
    torch.cuda.synchronize()
    scatter_rows_ref(pool_dev, rows[wr_tier == 1], wr_idx[wr_tier == 1], wr_off[wr_tier == 1])
    assert torch.equal(pool, pool_dev)


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("arch,n_layers", [("llama2_7b", 2), ("qwen3_moe_30b_a3b", 2),
                                           ("zamba2_2p7b", 12)])    # Zamba2: both shared blocks
def test_one_rank_mesh_engine_matches_engine_on_card(cuda_device, tmp_path, arch, n_layers,
                                                     backend):
    """A one-rank mesh on the card: the remote tier is pinned as the rank's
    slice, gathered into device buffers every step and read there by the
    kernels; tokens equal the engine without a mesh, graphed and eager."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as LM

    cfg = dataclasses.replace(TC.get(arch), n_layers=n_layers)
    LM.init_rank(0, 1, backend=backend, init_method=f"file://{tmp_path / 'store'}")
    try:
        mesh = LM.make_dev_mesh(1, 1)
        toks = {}
        for name, m, jit in (("plain", None, True), ("mesh", mesh, True), ("eager", mesh, False)):
            eng = ServingEngine(
                cfg, TM.layer_source(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                                     device=cuda_device),
                max_batch=3, max_len=32, global_offload_ratio=0.5, page_size=4,
                jit_step=jit, device=cuda_device, mesh=m)
            rng = np.random.default_rng(7)
            reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                            max_new_tokens=6) for i, n in enumerate(SERVE_PROMPT_LENS)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            toks[name] = [r.out_tokens for r in reqs]
            del eng
        assert toks["mesh"] == toks["eager"] == toks["plain"]
        assert mesh.link_bytes["weights"] > 0 and mesh.fetches > 0
    finally:
        dist.destroy_process_group()
        gc.collect()


@pytest.mark.parametrize("remote", [False, True])
def test_scatter_rows_matches_plain(cuda_device, remote):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    pool_dev = torch.randn((7, 4, 2, 8), generator=gen, device=cuda_device)
    rows = torch.randn((3, 2, 8), generator=gen, device=cuda_device)
    wr_tier = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda_device)
    wr_idx = torch.tensor([2, 5, 0], dtype=torch.int32, device=cuda_device)
    wr_off = torch.tensor([3, 1, 0], dtype=torch.int32, device=cuda_device)
    pool = _pinned(pool_dev) if remote else pool_dev.clone()
    tier_sel = 1 if remote else 0
    scatter_rows(pool, rows, wr_tier, wr_idx, wr_off, tier_sel, 6, remote=remote)
    torch.cuda.synchronize()
    sel = wr_tier == tier_sel
    scatter_rows_ref(pool_dev, rows[sel], wr_idx[sel], wr_off[sel])
    assert torch.equal(pool.to(cuda_device), pool_dev)


def _engine_matches_plain_reference(cfg, ratio, dev, new_tokens=8, from_source=False,
                                    priorities=(0, 0, 0, 0, 0), **engine_kw):
    """Serve 5 prompts that force spills (3 slots, page 4) on the card and
    hold every request's tokens to the plain per-request reference on the
    card, with the same weights unsplit in HBM; the engine is built from the
    whole tree, or with `from_source` from a layer source of the same seed,
    and takes `engine_kw` (a scheduler, a prefill chunk)."""
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    weights = (TM.layer_source(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
               if from_source else params)
    eng = ServingEngine(cfg, weights, max_batch=3, max_len=32, global_offload_ratio=ratio,
                        page_size=4, device=dev, **engine_kw)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=new_tokens, priority=priorities[i])
            for i, n in enumerate(SERVE_PROMPT_LENS)]
    for r in reqs:
        eng.submit(r)
    assert eng.run().served == len(reqs)
    for r in reqs:
        logits, cache = TM.prefill(cfg, params, {"tokens": torch.tensor(r.prompt,
                                                                         device=dev)[None]},
                                   max_len=32)
        want, pos = [int(torch.argmax(logits.reshape(-1)))], len(r.prompt)
        while len(want) < new_tokens:
            logits, cache = TM.decode_step(
                cfg, params, cache, torch.tensor([[want[-1]]], device=dev), pos)
            want.append(int(torch.argmax(logits.reshape(-1))))
            pos += 1
        assert r.out_tokens == want, f"request {r.rid}"
    return eng


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_engine_matches_plain_reference_on_card(cuda_device, ratio):
    """The engine on the card (kernels, pinned remote tiers) emits exactly
    the tokens of the plain per-request reference on the card (fp32,
    llama2-7b smoke, page 4, prompts that force spills)."""
    _engine_matches_plain_reference(TC.get_smoke("llama2_7b"), ratio, cuda_device)


@pytest.mark.parametrize("ratio", [0.5, 1.0])
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v2_236b"])
def test_moe_mla_engine_matches_plain_reference_on_card(cuda_device, arch, ratio):
    """MoE (GQA) and MLA + MoE smoke on the card, dropless capacity (a
    finite one couples the batched requests' drops): the engine's tokens
    equal the plain reference's, and every remote weight tier is pinned."""
    cfg = TC.get_smoke(arch)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))
    eng = _engine_matches_plain_reference(cfg, ratio, cuda_device)
    tiered = [w for w in eng.params["layers"].values() if isinstance(w, TieredTensor)]
    assert any(w.axis == -3 for w in tiered)
    assert all(w.remote.is_pinned() and w.local.device.type == "cuda" for w in tiered)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 12])
def test_tiered_expert_ffn_matches_plain(cuda_device, dtype, rows):
    """The expert FFN over a 4|4 split stack: local experts batched from
    HBM, the remote block through one grouped direct-access launch per
    matrix over the pinned stacks, experts without a valid slot skipped on
    the device; held against the einsum over both tiers on the card."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows)
    g, e, d, ff = 1, 8, 256, 96
    buf = torch.randn((g, e, rows, d), generator=gen, device=cuda_device).to(dtype)
    valid = torch.zeros((g, e, rows), dtype=torch.bool, device=cuda_device)
    valid[0, [0, 2, 5, 6], 0] = True                   # remote experts 5 and 6 run
    valid[0, 5, :] = True
    buf = buf.masked_fill(~valid[..., None], 0)
    wi = (torch.randn((e, d, 2 * ff), generator=gen, device=cuda_device) * 0.05).to(dtype)
    wdown = (torch.randn((e, ff, d), generator=gen, device=cuda_device) * 0.05).to(dtype)
    split = {}
    for name, w in (("wi", wi), ("wdown", wdown)):
        split[name] = TieredTensor(local=w[:4].contiguous(), remote=_pinned(w[4:]), axis=-3)
    before = (splitk_gemm.launches, splitk_gemm_grouped.launches,
              int(TL.tiered_expert_ffn.remote_experts))
    got = TL.tiered_expert_ffn(buf, valid, split["wi"], split["wdown"],
                               mm=TD.kernel_mm(2))
    torch.cuda.synchronize()
    assert splitk_gemm.launches == before[0]
    assert splitk_gemm_grouped.launches - before[1] == 2
    assert int(TL.tiered_expert_ffn.remote_experts) - before[2] == 2
    assert rel_err(got, TL._expert_ffn(buf, wi, wdown)) < TOL[dtype]


# id: E, M, K, N, active experts; the wrapper picks K splits (tickets) for
# few tiles; M <= 16 and fp32 take the split-K design (M tiles of up to 64
# rows), bf16 past 16 rows the cluster design (clusters of 1, 2, 3, 6 and
# two of 5 M tiles of 128 rows)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,m,k,n,active", [
    (4, 1, 256, 128, (1, 3)), (3, 5, 512, 64, (0, 1, 2)), (6, 24, 96, 72, (5,)),
    (4, 150, 256, 192, (0, 2)), (64, 1, 2048, 1536, (7, 40)), (5, 3, 128, 64, ()),
    (3, 65, 512, 64, (0, 2)), (3, 384, 256, 128, (1,)), (2, 1100, 128, 64, (0, 1)),
    (5, 300, 96, 200, (4,)), (4, 192, 256, 128, ()),
], ids=["split-K", "M5", "ragged-N", "M-tiles", "qwen3", "none-active", "cluster-2",
        "cluster-6", "clusters-of-5", "cluster-ragged-N", "cluster-none-active"])
@pytest.mark.parametrize("window", [1, 2])
def test_splitk_gemm_grouped_matches_plain(cuda_device, dtype, e, m, k, n, active, window):
    gen = torch.Generator(device=cuda_device).manual_seed(e * m + k)
    x = torch.randn((e, m, k), generator=gen, device=cuda_device).to(dtype)
    w_dev = (torch.randn((e, k, n), generator=gen, device=cuda_device) * 0.05).to(dtype)
    counts = torch.zeros(e, dtype=torch.int32, device=cuda_device)
    counts[list(active)] = 2
    before = splitk_gemm_grouped.launches
    splitk_gemm_grouped.host_bytes.reset()
    got = splitk_gemm_grouped(x, _pinned(w_dev), counts, window=window)
    torch.cuda.synchronize()
    assert splitk_gemm_grouped.launches == before + 1
    assert rel_err(got, tref.splitk_gemm_grouped_ref(x, w_dev, counts)) < TOL[dtype]
    reads = grouped_tiling(m, dtype).reads
    assert int(splitk_gemm_grouped.host_bytes) == len(active) * k * n * ELEM_BYTES[dtype] * reads
    assert torch.equal(got[counts == 0], torch.zeros_like(got[counts == 0]))
    # a serving mesh's remote experts, gathered on the card: the same bits
    assert torch.equal(splitk_gemm_grouped(x, w_dev, counts, window=window), got)
    with pytest.raises(ValueError, match="pinned host memory"):
        splitk_gemm_grouped(x, w_dev.cpu(), counts)          # unpinned host memory
    with pytest.raises(ValueError, match="int32"):
        splitk_gemm_grouped(x, _pinned(w_dev), counts.long())


@pytest.mark.parametrize("m", [17, 192, 384, 1100])
def test_grouped_cluster_design_reads_once_per_cluster(cuda_device, m):
    """The cluster design against the split-K design it replaced at M > 16
    (bf16, both through the wrapper's private launch path): the same
    products within the bf16 bound, and the host bytes counted once per
    cluster of M tiles against once per 64-row tile."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    e, k, n = 4, 512, 128
    x = torch.randn((e, m, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    w = _pinned((torch.randn((e, k, n), generator=gen, device=cuda_device) * 0.05)
                .to(torch.bfloat16))
    counts = torch.tensor([1, 0, 3, 1], dtype=torch.int32, device=cuda_device)
    hb = splitk_gemm_grouped.host_bytes
    got = {}
    for design in ("cluster", "split-K"):
        hb.reset()
        got[design] = _launch_grouped(x, w, counts, 1, design)
        torch.cuda.synchronize()
        assert int(hb) == 3 * k * n * 2 * grouped_tiling(m, torch.bfloat16, design=design).reads
    assert rel_err(got["cluster"], got["split-K"]) < TOL[torch.bfloat16]
    assert grouped_tiling(m, torch.bfloat16).reads < grouped_tiling(
        m, torch.bfloat16, design="split-K").reads or m <= 64


def test_k_only_pinned_paged_cache(cuda_device):
    """A K-only cache (MLA latent pages) on the card: the remote pool is
    pinned host memory, prompts write into both tiers, a full local pool
    spills its coldest page to the host, and every page reads back."""
    ps, width = 4, 576
    cache = PagedTieredCache(2, 1, width, page_size=ps, local_pages=3, remote_pages=6,
                             max_slots=2, max_pages_per_slot=4, dtype=torch.bfloat16,
                             store_v=False, device=cuda_device)
    assert set(cache.pools) == {"k_local", "k_remote"}
    assert cache.pools["k_remote"].is_pinned() and cache.pools["k_local"].is_cuda
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    prompts = [torch.randn((2, n, 1, width), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for n in (10, 7)]
    for slot, k in enumerate(prompts):
        cache.write_prompt(slot, k)
    assert cache.spills >= 1 and cache.remote_in_use >= 1
    for slot, k in enumerate(prompts):
        got_k, got_v = cache.gather(slot, k.shape[1])
        assert torch.equal(got_k, k) and torch.equal(got_v, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_loc,b_rem,h,kh,hd,s,kv_len,alias_v", [
    (2, 2, 8, 2, 32, 64, 64, False),       # GQA, whole cache
    (2, 3, 4, 4, 64, 200, 150, False),     # kv_len < S, several chunks, ragged last chunk
    (0, 3, 4, 2, 32, 40, 40, False),       # every request remote
    (3, 0, 4, 2, 32, 40, 1, False),        # every request local, one position
    (1, 2, 4, 2, 30, 150, 130, False),     # hd not a multiple of 16 B, several chunks
    (2, 2, 32, 32, 128, 512, 288, False),  # full width, the served run's late step
    (2, 2, 32, 32, 128, 2048, 2048, False),  # full width, a long cache
    (1, 1, 32, 32, 128, 64, 16, False),    # one chunk of 16 rows
    (1, 1, 32, 32, 128, 64, 17, False),    # a chunk and a row
    (0, 2, 32, 32, 128, 1000, 999, False),  # all remote, full width
    (2, 0, 32, 8, 128, 1000, 777, False),  # all local, GQA at full width
    (1, 2, 16, 1, 72, 300, 300, True),     # V read from K, 16 query heads per kv head
    (1, 1, 8, 1, 576, 100, 77, False),     # hd above 256: element loads
])
@pytest.mark.parametrize("window", [1, 2, 3, 4])
def test_splitk_flashattn_matches_plain(cuda_device, dtype, b_loc, b_rem, h, kh, hd, s,
                                        kv_len, alias_v, window):
    """Batch-split attention from one position to a long cache, each tier
    empty, GQA, V read from K, hd 30 and hd 576 (element loads); one launch
    per call, and the same bits on a second launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(b_loc * 7 + b_rem + s)
    q = torch.randn((b_loc + b_rem, h, hd), generator=gen, device=cuda_device).to(dtype)
    dev = {f"{kv}_{t}": torch.randn((n, s, kh, hd), generator=gen, device=cuda_device).to(dtype)
           for kv in ("k", "v") for t, n in (("local", b_loc), ("remote", b_rem))}
    if alias_v:
        dev["v_local"], dev["v_remote"] = dev["k_local"], dev["k_remote"]
    cache = {k: v for k, v in dev.items() if k.endswith("local")}
    cache["k_remote"] = _pinned(dev["k_remote"])
    cache["v_remote"] = cache["k_remote"] if alias_v else _pinned(dev["v_remote"])
    before = splitk_flashattn.launches
    got = ops.tiered_decode_attention(q, cache, kv_len=kv_len, window=window)
    again = ops.tiered_decode_attention(q, cache, kv_len=kv_len, window=window)
    torch.cuda.synchronize()
    assert splitk_flashattn.launches == before + 2
    want = tref.splitk_flashattn_ref(q, dev["k_local"], dev["v_local"], dev["k_remote"],
                                     dev["v_remote"], kv_len)
    assert rel_err(got, want) < TOL[dtype]
    assert torch.equal(got, again)
    if b_rem:
        # a serving mesh's remote tier, gathered on the card: the same bits
        on_card = splitk_flashattn(q, dev["k_local"], dev["v_local"], dev["k_remote"],
                                   dev["v_remote"], kv_len=kv_len, window=window)
        assert torch.equal(on_card, got)
        with pytest.raises(ValueError, match="pinned host memory"):
            splitk_flashattn(q, dev["k_local"], dev["v_local"], dev["k_remote"].cpu(),
                             dev["v_remote"].cpu(), kv_len=kv_len)   # unpinned host memory


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,kh,t,hd", [
    (2, 8, 2, 256, 64),                 # GQA: q head h reads kv head h % Kh
    (1, 4, 4, 100, 128),                # ragged T
    (2, 4, 1, 77, 30),                  # hd not a multiple of 16
])
def test_flash_prefill_matches_plain(cuda_device, dtype, causal, b, h, kh, t, hd):
    gen = torch.Generator(device=cuda_device).manual_seed(t)
    q = torch.randn((b, h, t, hd), generator=gen, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, kh, t, hd), generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    assert rel_err(got, tref.flash_prefill_ref(q, k, v, causal)) < TOL[dtype]


@pytest.mark.parametrize("dtype,k", [(torch.bfloat16, 4096), (torch.bfloat16, 11008),
                                     (torch.float32, 4096)])
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("n_loc,n_rem", [(1000, 520), (0, 776), (264, 0), (2048, 2056)])
def test_splitk_gemm_decode_design_matches_plain(cuda_device, dtype, m, k, n_loc, n_rem):
    """Decode (M <= 16) at llama2-7b's K, with N that is no multiple of the
    64-column tile, an empty tier each way, every case on the split-K design
    (4 to 32 splits of K); windows 1 and 3; the result is the same
    bits on a second launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(m + k + n_loc)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    wl = (torch.randn((k, n_loc), generator=gen, device=cuda_device) * 0.02).to(dtype)
    wr_dev = (torch.randn((k, n_rem), generator=gen, device=cuda_device) * 0.02).to(dtype)
    wr = _pinned(wr_dev)
    want = tref.splitk_gemm_ref(x, wl, wr_dev)
    for window in (1, 3):
        before = splitk_gemm.launches
        got = splitk_gemm(x, wl, wr, window=window)
        again = splitk_gemm(x, wl, wr, window=window)
        torch.cuda.synchronize()
        assert splitk_gemm.launches == before + 2
        assert rel_err(got, want) < TOL[dtype]
        assert torch.equal(got, again)


def _row_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max over query rows of |a - b| / max |b| of that row."""
    a, b = a.float(), b.float()
    return float(((a - b).abs().amax(-1) / (b.abs().amax(-1) + 1e-9)).max())


def _prefill_operands(device, b, h, kh, tq, tk, hd, seed, offset=0):
    """bf16 q [B, H, Tq, hd], k, v [B, Kh, Tk, hd]; ``offset`` > 0 views each
    one element into its storage, off 16-byte alignment."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def operand(heads, rows):
        flat = torch.randn(b * heads * rows * hd + offset, generator=gen, device=device)
        return flat.to(torch.bfloat16)[offset:].view(b, heads, rows, hd)

    return operand(h, tq), operand(kh, tk), operand(kh, tk)


def _prefill_twice(q, k, v, causal, design):
    """Two launches through the wrapper, which must take ``design``; returns
    the first output and whether the second is the same bits."""
    before = dict(flash_prefill.launches_by_design)
    got = flash_prefill(q, k, v, causal=causal)
    again = flash_prefill(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_prefill.launches_by_design[design] == before[design] + 2
    return got, torch.equal(got, again)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 128, 129, 1000, 2048])
@pytest.mark.parametrize("h,kh", [(8, 2), (4, 4)])
def test_flash_prefill_tensor_cores_match_plain(cuda_device, causal, hd, t, h, kh):
    """The bf16 wgmma design (hd 64 and 128, aligned operands) at ragged and
    whole-tile T, GQA (8 q heads over 2 kv heads) and H = Kh, checked row by
    row; a second launch is the same bits."""
    q, k, v = _prefill_operands(cuda_device, 2, h, kh, t, t, hd, seed=t * hd + kh)
    got, same = _prefill_twice(q, k, v, causal, "wgmma")
    assert same and torch.isfinite(got.float()).all()
    assert _row_rel_err(got, tref.flash_prefill_ref(q, k, v, causal)) < TOL[torch.bfloat16]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("tq,tk", [(300, 200), (100, 333), (77, 1), (129, 2048)])
def test_flash_prefill_wgmma_design_takes_tq_other_than_tk(cuda_device, causal, hd, tq, tk):
    """Tq != Tk on the wgmma design: query and key positions both counted
    from 0, as the reference counts them."""
    q, k, v = _prefill_operands(cuda_device, 2, 4, 2, tq, tk, hd, seed=tq + tk)
    got, same = _prefill_twice(q, k, v, causal, "wgmma")
    assert same
    assert _row_rel_err(got, tref.flash_prefill_ref(q, k, v, causal)) < TOL[torch.bfloat16]


@pytest.mark.parametrize("hd,offset", [(32, 0), (96, 0), (256, 0), (64, 1), (128, 1)])
def test_flash_prefill_other_head_dims_and_misaligned_views_take_mma(cuda_device, hd, offset):
    """Head dims the wgmma design does not take, and operands off 16-byte
    alignment (no tensor map takes them), run the mma.sync design; the
    kernel's entry refuses the wgmma design for them."""
    import importlib

    fp = importlib.import_module("repro_torch.kernels.flash_prefill")
    q, k, v = _prefill_operands(cuda_device, 2, 8, 2, 129, 129, hd, seed=hd + offset,
                                offset=offset)
    for causal in (True, False):
        got, same = _prefill_twice(q, k, v, causal, "mma")
        assert same
        assert _row_rel_err(got, tref.flash_prefill_ref(q, k, v, causal)) < TOL[torch.bfloat16]
    with pytest.raises(RuntimeError, match="wgmma design"):
        fp._launch(q, k, v, True, "wgmma")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_prefill_replaced_design_matches_the_wgmma_design(cuda_device, causal, hd):
    """The mma.sync design the wgmma design replaced at hd 64 and 128, still
    reachable through the private launch, agrees with it within the bf16
    bound, row by row."""
    import importlib

    fp = importlib.import_module("repro_torch.kernels.flash_prefill")
    q, k, v = _prefill_operands(cuda_device, 2, 8, 2, 1000, 1000, hd, seed=hd)
    new, old = (fp._launch(q, k, v, causal, which) for which in ("wgmma", "mma"))
    torch.cuda.synchronize()
    assert _row_rel_err(old, new) < TOL[torch.bfloat16]


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_batch_split_decode_matches_plain_decode_on_card(cuda_device, ratio):
    """Prefill, split_cache_batch (remote rows pinned) and 4 greedy
    tiered_decode_steps emit the tokens of the plain decode_step path
    (fp32, llama2-7b smoke), one attention launch per layer and step."""
    cfg = TC.get_smoke("llama2_7b")
    params = TM.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            device=cuda_device)
    plan = TE.plan(cfg, WorkloadSpec(batch=4, seq_len=32, phase="decode"), H100_SXM,
                   global_ratio=0.5)
    tparams = plan.partition(params, align=32, place_remote=True)
    prompts = torch.tensor(np.random.default_rng(1).integers(3, cfg.vocab, (4, 6)),
                           dtype=torch.int32, device=cuda_device)
    logits, cache = TM.prefill(cfg, tparams, {"tokens": prompts}, max_len=32,
                               mm=TD.kernel_mm(2))
    kv = TD.split_cache_batch(cache, ratio)
    assert kv["k_remote"].shape[1] == round(4 * ratio)
    assert kv["k_remote"].is_pinned()
    plogits, pcache = TM.prefill(cfg, params, {"tokens": prompts}, max_len=32)
    tok, ptok = torch.argmax(logits[:, -1], -1), torch.argmax(plogits[:, -1], -1)
    for i in range(4):
        assert torch.equal(tok, ptok), f"step {i}"
        before = splitk_flashattn.launches
        logits, kv = TD.tiered_decode_step(cfg, tparams, kv, tok[:, None], 6 + i)
        assert splitk_flashattn.launches == before + cfg.n_layers
        plogits, pcache = TM.decode_step(cfg, params, pcache, ptok[:, None], 6 + i)
        tok, ptok = torch.argmax(logits[:, 0], -1), torch.argmax(plogits[:, 0], -1)
    assert torch.equal(tok, ptok)


@pytest.mark.parametrize("m", [4, 128])
def test_splitk_gemm_at_opt30b_lm_head_split(cuda_device, m):
    """OPT-30B's lm_head at offload 0.5 (K 7168, N 25184 | 25088, bf16): the
    local tier is no multiple of the 64-column decode tile."""
    k, n_loc, n_rem = 7168, 25184, 25088
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    wl = (torch.randn((k, n_loc), generator=gen, device=cuda_device) * 0.02).to(torch.bfloat16)
    wr_dev = (torch.randn((k, n_rem), generator=gen, device=cuda_device) * 0.02
              ).to(torch.bfloat16)
    before = splitk_gemm.launches
    got = splitk_gemm(x, wl, _pinned(wr_dev), window=1)
    torch.cuda.synchronize()
    assert splitk_gemm.launches == before + 1
    assert rel_err(got, tref.splitk_gemm_ref(x, wl, wr_dev)) < TOL[torch.bfloat16]


def _tiered(tree):
    for leaf in tree.values():
        if isinstance(leaf, dict):
            yield from _tiered(leaf)
        elif isinstance(leaf, TieredTensor):
            yield leaf


@pytest.mark.parametrize("arch,n_layers", [("opt_30b", 2), ("llama2_7b", None),
                                           ("qwen3_moe_30b_a3b", None),
                                           ("deepseek_v2_236b", None),
                                           ("mamba2_370m", None), ("zamba2_2p7b", None)])
def test_layer_source_tree_equals_partition_of_the_whole(cuda_device, arch, n_layers):
    """On the card, the layer-by-layer build (remote stacks in one pinned
    allocation each) equals `partition(whole)` with remote tiers placed in
    pinned memory, bit for bit: a 2-layer OPT-30B at full width in bf16, and
    the smoke configs of the dense, MoE, MLA, SSM and hybrid families (the
    hybrid's shared block stack included)."""
    cfg = TC.get(arch) if n_layers else TC.get_smoke(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    align = 128 if n_layers else 32
    plan = TE.plan(cfg, WorkloadSpec(batch=4, seq_len=64, phase="decode"), H100_SXM,
                   global_ratio=0.5)
    dtype = torch.bfloat16 if n_layers else torch.float32
    whole = TM.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(3),
                           dtype=dtype, device=cuda_device)
    want = plan.partition(whole, align=align, place_remote=True)
    del whole
    src = TM.layer_source(cfg, torch.Generator(device=cuda_device).manual_seed(3),
                          dtype=dtype, device=cuda_device)
    pinned = _build.pinned_bytes()
    got = plan.partition_source(src, align=align)
    tiered = list(_tiered(got))
    assert tiered and all(t.remote.is_pinned() and t.local.is_cuda for t in tiered)
    assert _build.pinned_bytes() - pinned == sum(t.remote.nbytes for t in tiered)
    for key, w in want["layers"].items():
        g = got["layers"][key]
        if isinstance(w, TieredTensor):
            assert torch.equal(g.local, w.local) and torch.equal(g.remote, w.remote), key
        else:
            assert torch.equal(g, w), key
    tops = [(key, want[key], got[key]) for key in ("embed", "final_w", "final_b", "lm_head")
            if key in want]
    tops += [(f"shared/{key}", w, got["shared"][key]) for key, w in want.get("shared", {}).items()]
    for key, w, g in tops:
        pairs = [(g.local, w.local), (g.remote, w.remote)] if isinstance(w, TieredTensor) \
            else [(g, w)]
        assert all(torch.equal(a, b) for a, b in pairs), key


@pytest.mark.parametrize("arch", ["opt_6p7b", "opt_30b", "qwen2p5_14b", "qwen3_32b",
                                  "chatglm3_6b", "starcoder2_3b"])
def test_dense_variant_engine_from_a_source_matches_plain_reference(cuda_device, arch):
    """Each dense variant's smoke config, built layer by layer on the card
    at offload 0.5, emits exactly the plain per-request reference's tokens
    on the same weights unsplit in HBM."""
    _engine_matches_plain_reference(TC.get_smoke(arch), 0.5, cuda_device, from_source=True)


@pytest.mark.parametrize("ratio", [0.5, 1.0])
@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2p7b"])
def test_recurrent_engine_matches_plain_reference_on_card(cuda_device, arch, ratio):
    """The SSM and hybrid smoke configs, built layer by layer on the card:
    the engine's tokens equal the plain per-request reference's on the same
    weights unsplit in HBM; every remote tier, the hybrid's shared blocks'
    too, is pinned; the SSM engine keeps no page cache."""
    eng = _engine_matches_plain_reference(TC.get_smoke(arch), ratio, cuda_device,
                                          from_source=True)
    tiered = list(_tiered(eng.params))
    assert tiered and all(w.remote.is_pinned() and w.local.device.type == "cuda"
                          for w in tiered)
    assert (eng.pcache is None) == (arch == "mamba2_370m")
    if arch == "zamba2_2p7b":
        assert all(isinstance(w, TieredTensor) for k, w in eng.params["shared"].items()
                   if k in ("wq", "wkv", "wo", "wi", "wdown"))


@pytest.mark.parametrize("arch", ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
                                  "mamba2_370m", "zamba2_2p7b", "llava_next_34b"])
def test_chunked_prefill_engine_matches_plain_reference_on_card(cuda_device, arch):
    """The SLO scheduler with chunks of 4 tokens (`models.prefill_chunk`
    through the kernel into a private cache) on the card: every request's
    tokens equal the plain whole-prompt reference's (fp32, MoE dropless)."""
    from repro_torch.frontend.metrics import ModeledClock

    cfg = TC.get_smoke(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))
    eng = _engine_matches_plain_reference(cfg, 0.5, cuda_device, priorities=(0, 2, 1, 0, 2),
                                          scheduler="slo", prefill_chunk=4,
                                          clock=ModeledClock())
    assert eng.stats.prefill_chunks > 0


def test_priority_preemption_on_card(cuda_device):
    """Two low-priority prompts fill the local pool, then a high-priority
    arrival demotes their pages to the pinned pool: the victims decode on
    through the paged kernel reading the demoted pages, every request's
    tokens equal to the plain reference's."""
    from repro_torch.frontend.metrics import ModeledClock

    cfg, dev = TC.get_smoke("llama2_7b"), cuda_device
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.7,
                        page_size=4, scheduler="priority", clock=ModeledClock(), device=dev)
    rng = np.random.default_rng(41)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=10, priority=5 if i == 2 else 0)
            for i, n in enumerate((16, 14, 12))]
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    eng.step()
    eng.submit(reqs[2])
    stats = eng.run()
    assert stats.served == 3 and stats.preemptions >= 1 and stats.preempt_demoted_pages >= 1
    assert eng.pcache.pools["k_remote"].is_pinned()
    for r in reqs:
        logits, cache = TM.prefill(cfg, params, {"tokens": torch.tensor(r.prompt,
                                                                         device=dev)[None]},
                                   max_len=32)
        want, pos = [int(torch.argmax(logits.reshape(-1)))], len(r.prompt)
        while len(want) < 10:
            logits, cache = TM.decode_step(cfg, params, cache,
                                           torch.tensor([[want[-1]]], device=dev), pos)
            want.append(int(torch.argmax(logits.reshape(-1))))
            pos += 1
        assert r.out_tokens == want, f"request {r.rid}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_demote_slot_pages_moves_bytes_into_the_pinned_pool(cuda_device, dtype):
    """Preemption's demotion on the card: the slot's coldest local pages
    land in the pinned remote pool byte for byte, the sequence tail stays
    in HBM, and the slot reads back unchanged."""
    from repro_torch.serving.paged_cache import LOCAL, REMOTE

    cache = PagedTieredCache(2, 2, 64, page_size=4, local_pages=6, remote_pages=6,
                             max_slots=2, max_pages_per_slot=5, dtype=dtype,
                             device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    k, v = (torch.randn((2, 17, 2, 64), generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    cache.write_prompt(0, k, v)
    before = [cache.pools["k_local"][:, i].clone() for i in cache.slot_pages(0, LOCAL)]
    assert cache.demote_slot_pages(0, max_pages=3) == 3 and cache.demotions == 3
    assert cache.slot_residency(0) == {"pages": 5, "local_pages": 2, "remote_pages": 3,
                                       "local_tokens": 8}
    assert [int(t) for t in cache.tier[0, :5]] == [REMOTE] * 3 + [LOCAL] * 2
    remote = cache.pools["k_remote"]
    assert remote.is_pinned() and remote.device.type == "cpu"
    for p, old in zip(range(3), before):
        assert torch.equal(remote[:, int(cache.table[0, p])].to(cuda_device), old)
    got_k, got_v = cache.gather(0, 17)
    assert torch.equal(got_k, k) and torch.equal(got_v, v)


def test_encoder_forward_tiered_matches_untiered_on_card(cuda_device):
    """HuBERT-XLarge at full width, 2 layers, fp32: the prefill step of
    `launch.steps` over weights tiered at offload 0.5 (every projection
    through `splitk_gemm`, remote halves pinned) equals the forward over
    the same weights unsplit in HBM."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as TS

    dev = cuda_device
    cfg = dataclasses.replace(TC.get("hubert_xlarge"), n_layers=2)
    params = TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    plan = TE.plan(cfg, WorkloadSpec(batch=2, seq_len=100, phase="prefill"), H100_SXM,
                   global_ratio=0.5)
    tiered = plan.partition_source(
        TM.layer_source(cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        align=128)
    assert all(w.remote.is_pinned() for w in _tiered(tiered))
    batch = TS.input_specs(cfg, ShapeConfig("enc", 100, 2, "prefill"),
                           torch.Generator(device=dev).manual_seed(1), dtype=torch.float32,
                           device=dev)
    launches = splitk_gemm.launches
    got, cache = TS.make_prefill_step(cfg, mm=TD.kernel_mm(1))(tiered, batch)
    assert cache == {} and splitk_gemm.launches - launches == 2 * 5 + 1
    want = TM.forward(cfg, params, batch)
    assert got.shape == (2, 100, cfg.vocab)
    assert rel_err(got, want) < TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grow_remote_keeps_every_page_in_a_new_pinned_pool(cuda_device, dtype):
    """`grow_remote` on the card: each remote pool becomes a new pinned
    allocation of the grown size, every owned page keeps its bytes and
    index, the sink moves to the new last page, and the slots read back
    unchanged."""
    from repro_torch.serving.paged_cache import REMOTE

    cache = PagedTieredCache(2, 2, 64, page_size=4, local_pages=2, remote_pages=3,
                             max_slots=2, max_pages_per_slot=4, dtype=dtype, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    kv = [tuple(torch.randn((2, n, 2, 64), generator=gen, device=cuda_device).to(dtype)
                for _ in range(2)) for n in (9, 7)]
    for slot, (k, v) in enumerate(kv):
        cache.write_prompt(slot, k, v)          # 5 pages over 2 local: 3 in the host pool
    owned = {i: cache.pools["k_remote"][:, i].clone() for i in cache.owned_pages(REMOTE)}
    sink = cache.pools["v_remote"][:, cache.sink_remote].clone()
    old, pinned = cache.pools["k_remote"], _build.pinned_bytes()
    assert len(owned) == 3 and not cache.free[REMOTE]
    assert cache.grow_remote(4) == 7 and cache.sink_remote == 7
    new = cache.pools["k_remote"]
    assert new.is_pinned() and new.data_ptr() != old.data_ptr() and new.shape[1] == 8
    del old
    assert _build.pinned_bytes() - pinned == 2 * 4 * new[:, 0].nbytes
    for i, page in owned.items():
        assert torch.equal(new[:, i], page)
    assert torch.equal(cache.pools["v_remote"][:, 7], sink)
    assert sorted(cache.free[REMOTE]) == [3, 4, 5, 6]
    for slot, (k, v) in enumerate(kv):
        got_k, got_v = cache.gather(slot, k.shape[1])
        assert torch.equal(got_k, k) and torch.equal(got_v, v)


def test_repartition_on_card_equals_a_fresh_partition(cuda_device):
    """A forced re-plan's repartition on the card: the new tree equals
    `partition_source` at the new plan bit for bit, every new remote tier
    is pinned, and the pinned bytes grow by exactly the new remote tiers
    (the old ones are alive until the caller drops them)."""
    from repro_torch.runtime.replan import repartition

    cfg, dev = TC.get_smoke("llama2_7b"), cuda_device

    def source():
        return TM.layer_source(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)

    plans = [TE.plan(cfg, WorkloadSpec(batch=2, seq_len=32, phase="decode"), H100_SXM,
                     global_ratio=r) for r in (0.5, 0.9)]
    tree = plans[0].partition_source(source(), align=32)
    torch.cuda.synchronize()
    pinned = _build.pinned_bytes()
    new, changed = repartition(tree, plans[1], align=32)
    torch.cuda.synchronize()
    assert changed
    grown = sum(w.remote.nbytes for w in _tiered(new) if all(w is not o for o in _tiered(tree)))
    assert _build.pinned_bytes() - pinned == grown > 0
    assert all(w.remote.is_pinned() and w.local.is_cuda for w in _tiered(new))
    assert_trees_equal(new, plans[1].partition_source(source(), align=32))


def test_cuda_event_source_measures_a_decode_step(cuda_device):
    """The runtime closed over the measured source: after one decode step
    the CUDA events report a positive bandwidth for each tier, which the
    AIMD loop then reads; before it, the analytical prior answered."""
    from repro_torch.core import congestion
    from repro_torch.runtime.controller import RuntimeController
    from repro_torch.runtime.telemetry import CudaEventSource

    cfg, dev = TC.get_smoke("llama2_7b"), cuda_device
    plan = TE.plan(cfg, WorkloadSpec(batch=2, seq_len=32, phase="decode"), H100_SXM,
                   global_ratio=0.5, kv_page_size=4)
    prior = congestion.ModelSource(congestion.CongestionModel(H100_SXM), plan.window.n_streams,
                                   plan.window.chunk_bytes)
    src = CudaEventSource(prior, dev)
    rt = RuntimeController(cfg, plan, H100_SXM, source=src, align=32)
    eng = ServingEngine(cfg, TM.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                            device=dev),
                        max_batch=2, max_len=32, global_offload_ratio=0.5, page_size=4,
                        runtime=rt, device=dev)
    eng.submit(Request(rid=0, prompt=np.arange(3, 12, dtype=np.int32), max_new_tokens=4))
    eng.step()
    assert src.timed_steps == 1 and src.prior_answers == 0
    assert src.last_seconds > 0 and src.last.host_bw > 0 and src.last.hbm_bw > 0
    assert src.last_bytes[1] == pytest.approx(src.last.host_bw * src.last_seconds)
    assert src.measure(7) is src.last
    assert eng.run().served == 1 and src.timed_steps == eng.stats.decode_steps


# ---------------------------------------------------------------------------
# The compiled decode step: one CUDA graph per (window bucket, pool shape)
# ---------------------------------------------------------------------------
def _launch_counts() -> dict:
    from repro_torch.serving.compiled_step import LAUNCH_COUNTERS

    return {c.__name__: c.launches for c in LAUNCH_COUNTERS}


def _graph_engine_run(cfg, params, dev, jit_step, *, shrink=None, runtime=None):
    """Serve 5 prompts that force spills (3 slots, page 4, offload 0.5) one
    engine step at a time; returns (engine, tokens, launches per step)."""
    eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.5,
                        page_size=4, jit_step=jit_step, runtime=runtime, device=dev)
    if shrink is not None:
        eng.schedule_hbm_shrink(*shrink)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=8) for i, n in enumerate(SERVE_PROMPT_LENS)]
    for r in reqs:
        eng.submit(r)
    per_step = []
    while eng.scheduler.waiting or eng.prefilling or any(r is not None for r in eng.active):
        before = _launch_counts()
        eng.step()
        per_step.append({k: v - before[k] for k, v in _launch_counts().items()})
    assert eng.stats.served == len(reqs)
    return eng, [r.out_tokens for r in reqs], per_step


def _full_width(arch: str, dev):
    cfg = dataclasses.replace(TC.get(arch), n_layers=2)
    return cfg, TM.init_params(cfg, torch.Generator(device=dev).manual_seed(7), device=dev)


@pytest.mark.parametrize("arch", ["llama2_7b", "mamba2_370m", "qwen3_moe_30b_a3b"])
def test_graphed_step_matches_eager_on_card(cuda_device, arch):
    """A 2-layer full-width fp32 model: the graphed engine's tokens equal
    the eager engine's bit for bit, and every engine step launches each
    kernel exactly as often (a replay adds the launches its capture
    recorded); one bucket, every later decode step a hit."""
    cfg, params = _full_width(arch, cuda_device)
    TL.tiered_expert_ffn.remote_experts.reset()
    eager_eng, eager, eager_steps = _graph_engine_run(cfg, params, cuda_device, False)
    eager_experts = int(TL.tiered_expert_ffn.remote_experts)
    assert eager_eng.compile_count == 0 and not eager_eng.graphed
    del eager_eng
    TL.tiered_expert_ffn.remote_experts.reset()
    eng, graphed, steps = _graph_engine_run(cfg, params, cuda_device, True)
    assert graphed == eager
    assert steps == eager_steps and sum(s["splitk_gemm"] for s in steps) > 0
    assert int(TL.tiered_expert_ffn.remote_experts) == eager_experts
    if cfg.family == "moe":
        assert eager_experts > 0 and sum(s["splitk_gemm_grouped"] for s in steps) > 0
    assert eng.compile_count == 1 and eng.recaptures == 0
    assert eng.compile_count + eng.compile_cache_hits == eng.stats.decode_steps
    assert all(g.graph is not None for g in eng._compiled.values())


def test_graphed_step_recaptures_after_grow_and_replan_on_card(cuda_device):
    """The zero-budget runtime with a shrink to 20% of the local pages at
    decode step 2 grows the remote pool (a new pool shape: a new bucket,
    the old graph dropped) and forces re-plans that move weight columns
    (their graphs dropped and captured again): the tokens stay those of
    the same run eager."""
    from repro_torch.runtime.controller import RuntimeController

    cfg, params = _full_width("llama2_7b", cuda_device)
    budgets = dict(window_budget=0, migration_budget=0, drift_threshold=float("inf"))

    def runtime():
        plan = TE.plan(cfg, WorkloadSpec(batch=3, seq_len=32, phase="decode"), H100_SXM,
                       global_ratio=0.5, kv_page_size=4)
        return RuntimeController(cfg, plan, H100_SXM, align=128, **budgets)

    eager_eng, eager, eager_steps = _graph_engine_run(cfg, params, cuda_device, False,
                                                      shrink=(2, 0.2), runtime=runtime())
    del eager_eng
    eng, graphed, steps = _graph_engine_run(cfg, params, cuda_device, True, shrink=(2, 0.2),
                                            runtime=runtime())
    assert graphed == eager and steps == eager_steps
    assert eng.stats.remote_grown_pages > 0 and eng.stats.elastic_replans > 0
    assert eng.recaptures >= 1
    shapes = {key[5] for key in eng._compiled}
    assert len(shapes) >= 2, "the grown remote pool gave a new bucket"
    current = tuple(eng.pcache.pools["k_remote"].shape)
    assert all(g.graph is None for key, g in eng._compiled.items() if key[5] != current)


def test_graphed_step_tables_match_host_under_shrink_with_audit_on_card(cuda_device):
    """llama2-7b (2 layers, fp32) graphed with ``check_invariants=True``
    under the shrink to 20% of the local pages at decode step 2, which
    demotes pages and grows the remote pool: every step passes the audit,
    and after each decode step the fixed device buffers the graph read (the
    page table and its tiers) hold the host table's entries for every slot
    still decoding; the tokens are those of the same run eager."""
    cfg, params = _full_width("llama2_7b", cuda_device)
    runs = {}
    for jit in (False, True):
        eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.5,
                            page_size=4, jit_step=jit, check_invariants=True,
                            device=cuda_device)
        eng.schedule_hbm_shrink(2, 0.2)
        rng = np.random.default_rng(7)
        reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                        max_new_tokens=8) for i, n in enumerate(SERVE_PROMPT_LENS)]
        for r in reqs:
            eng.submit(r)
        checked = 0
        while eng.scheduler.waiting or eng.prefilling or any(r is not None for r in eng.active):
            steps = eng.stats.decode_steps
            eng.step()
            if eng.stats.decode_steps == steps:
                continue
            pc, buffers = eng.pcache, eng._inputs.buffers
            table, tier = buffers["table"].cpu().numpy(), buffers["tier"].cpu().numpy()
            for slot, req in enumerate(eng.active):
                if req is not None:
                    n = int(pc.n_pages[slot])
                    assert (table[slot, :n] == pc.table[slot, :n]).all()
                    assert (tier[slot, :n] == pc.tier[slot, :n]).all()
                    checked += 1
        assert eng.stats.served == len(reqs) and checked > 0
        assert eng.stats.elastic_demoted_pages > 0 or eng.stats.remote_grown_pages > 0
        runs[jit] = [r.out_tokens for r in reqs]
        del eng
    assert runs[True] == runs[False]


def test_engines_share_one_capture_stream_and_leave_no_memory_on_card(cuda_device):
    """Graphed engines built and dropped in turn capture on one side stream
    per device: the second leaves the card's allocated memory where the
    first left it (a stream per engine kept a cuBLAS workspace each)."""
    cfg = TC.get_smoke("llama2_7b")
    params = TM.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            device=cuda_device)
    after, streams = [], []
    for _ in range(2):
        eng, _, _ = _graph_engine_run(cfg, params, cuda_device, True)
        streams.append(eng._capture_stream)
        del eng
        gc.collect()
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated(cuda_device))
    assert streams[0] is streams[1]
    assert after[1] <= after[0]


def test_failed_capture_raises_and_never_falls_back(cuda_device, monkeypatch):
    """A step that syncs with the host cannot be captured: the engine
    raises with the capture's error attached, stays graphed, and raises
    again on the next step instead of running eagerly."""
    cfg, params = _full_width("llama2_7b", cuda_device)
    eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.5,
                        page_size=4, device=cuda_device)
    real = TD.paged_tiered_decode_step

    def syncing_step(*args, **kw):
        logits, pools = real(*args, **kw)
        float(logits.sum())                 # a host read: illegal while capturing
        return logits, pools

    monkeypatch.setattr(TD, "paged_tiered_decode_step", syncing_step)
    eng.submit(Request(rid=0, prompt=np.arange(3, 12, dtype=np.int32), max_new_tokens=4))
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        eng.step()
    assert eng.graphed and not any(g.captured for g in eng._compiled.values())
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        eng.step()


# ---------------------------------------------------------------------------
# The autotuner's knobs and the kernel lints' footprints on the card
# ---------------------------------------------------------------------------
def _tuned_gemm_cases():
    """(m, k, n_loc, n_rem, k_split, window): every design candidate the
    tuner sweeps at llama2-7b-like decode shapes cut narrow, and whole K at
    a prefill M."""
    from repro_torch.kernels.autotune import Autotuner

    tuner, out = Autotuner(), []
    for m, k, n_loc, n_rem in ((4, 4096, 256, 256), (1, 1024, 128, 640), (16, 2048, 0, 512),
                               (33, 512, 128, 128)):
        for ks in tuner.gemm_k_splits(m, k, n_loc, n_rem, 2):
            out.extend((m, k, n_loc, n_rem, ks, w) for w in (1, 2, 8))
    out.extend((33, 512, 128, 128, 0, w) for w in (1, 3, 8))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n_loc,n_rem,k_split,window", _tuned_gemm_cases())
def test_splitk_gemm_tuned_knobs_match_plain(cuda_device, dtype, m, k, n_loc, n_rem, k_split,
                                             window):
    gen = torch.Generator(device=cuda_device).manual_seed(k + n_rem + k_split)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    wl = torch.randn((k, n_loc), generator=gen, device=cuda_device).to(dtype)
    wr_dev = torch.randn((k, n_rem), generator=gen, device=cuda_device).to(dtype)
    if k_split and m > 16 and dtype == torch.float32:
        with pytest.raises(ValueError, match="cluster design"):   # bfloat16 only
            splitk_gemm(x, wl, _pinned(wr_dev), window=window, k_split=k_split)
        return
    got = splitk_gemm(x, wl, _pinned(wr_dev), window=window, k_split=k_split)
    torch.cuda.synchronize()
    assert rel_err(got, tref.splitk_gemm_ref(x, wl, wr_dev)) < TOL[dtype]


def test_splitk_gemm_refuses_a_split_the_decode_design_cannot_take(cuda_device):
    x = torch.ones((17, 64), device=cuda_device)
    wl, wr = torch.ones((64, 64), device=cuda_device), _pinned(torch.ones((64, 64)))
    with pytest.raises(ValueError, match="split-K decode design"):
        splitk_gemm(x, wl, wr, k_split=32)                # M = 17 > 16
    with pytest.raises(ValueError, match="multiple of 32"):
        splitk_gemm(x[:4], wl, wr, k_split=48)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_smem_footprint_equals_the_kernels_count(cuda_device, dtype):
    from repro_torch.kernels import splitk_gemm as G

    checked = 0
    for m in (1, 3, 4, 16, 33, 128, 700, 2000):
        for k in (40, 4096, 11008):
            for k_split in (0, 32, 64, 800, 832, 4096):
                if k_split and m > G.DECODE_MAX_M and (dtype == torch.float32 or k_split % 64):
                    continue
                for window in (1, 2, 8, 9, 64):
                    want = G.smem_query(m, k, window=window, k_split=k_split, dtype=dtype)
                    stages, _ = G.ring_stages(m, k, window=window, k_split=k_split, dtype=dtype)
                    assert (G.smem_footprint_bytes(m, k, 128, 128, window=window,
                                                   k_split=k_split, dtype=dtype),
                            stages) == want, (m, k, k_split, window)
                    checked += 1
    assert checked > 200


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_smem_footprints_equal_the_kernels_counts(cuda_device, dtype):
    from repro_torch.kernels import splitk_flashattn as A

    for case, (b, h, kh, hd, ps, mp, *_rest, alias_v) in PAGED_CASES.items():
        for window in (1, 2, 4, 8, 16):
            d = A.paged_design(b, h, kh, hd, ps, mp, window=window, dtype=dtype, alias_v=alias_v)
            want = A.paged_smem_query(b, h, kh, hd, ps, mp, window=window, dtype=dtype,
                                      alias_v=alias_v)
            assert (A.paged_smem_footprint_bytes(b, h, kh, hd, ps, mp, window=window,
                                                 dtype=dtype, alias_v=alias_v),
                    d.stages) == want, (case, window)
    for h, kh, hd, kv_len in ((32, 32, 128, 288), (32, 8, 128, 2000), (8, 1, 576, 70),
                              (4, 2, 30, 5), (2, 2, 1024, 100)):
        for window in (1, 2, 8, 12):
            stages, _ = A.ring_stages(window, 2 * A._box_bytes(A.CHUNK, hd, ELEM_BYTES[dtype]),
                                      -(-kv_len // A.CHUNK))
            want = A.smem_query(h, kh, hd, kv_len, window=window, dtype=dtype)
            assert (A.smem_footprint_bytes(h, kh, hd, kv_len, window=window, dtype=dtype),
                    stages) == want, (h, kh, hd, kv_len, window)


@pytest.mark.parametrize("dtype,which", [(torch.float32, None), (torch.bfloat16, "wgmma"),
                                         (torch.bfloat16, "mma")])
def test_flash_prefill_smem_footprint_equals_the_kernels_count(cuda_device, dtype, which):
    """Every design's shared memory by the wrapper's arithmetic equals the
    kernel's own count, at each head dim the design takes."""
    import importlib

    fp = importlib.import_module("repro_torch.kernels.flash_prefill")
    hds = fp.WGMMA_HEAD_DIMS if which == "wgmma" else (30, 64, 80, 128, 192, 256)
    for hd in hds:
        assert fp.smem_footprint_bytes(hd, dtype=dtype, which=which) == \
            fp.smem_query(hd, dtype=dtype, which=which), hd


def test_smem_limit_of_the_lints_is_the_cards_opt_in_limit(cuda_device):
    from repro_torch.analysis.kernel_lints import SMEM_OPTIN_BYTES

    props = torch.cuda.get_device_properties(cuda_device)
    assert SMEM_OPTIN_BYTES == props.shared_memory_per_block_optin == 227 * 1024


@pytest.mark.parametrize("jit", [True, False])
def test_tuned_engine_matches_untuned_on_card(cuda_device, jit):
    from repro_torch.kernels.autotune import Autotuner

    cfg = dataclasses.replace(TC.get("llama2_7b"), n_layers=2)
    params = TM.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(3),
                            device=cuda_device)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, cfg.vocab, n).astype(np.int32) for n in SERVE_PROMPT_LENS]
    runs = []
    for tuner in (None, Autotuner()):
        eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.5,
                            page_size=4, jit_step=jit, tuner=tuner, device=cuda_device)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append([r.out_tokens for r in reqs])
        if tuner is not None:
            assert tuner.table and tuner.validate() == []
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# The materialization lint on the card
# ---------------------------------------------------------------------------
def _lint_served(cfg, dev, *, jit_step: bool, lint_from: int | None):
    """Serve SERVE_PROMPT_LENS one engine step at a time (smoke weights,
    offload 0.5, remote tiers pinned), each step from ``lint_from`` on under
    the materialization lint; returns (tokens, findings, ops walked)."""
    from repro_torch.analysis import materialization as MZ

    eng = ServingEngine(cfg, TM.layer_source(cfg, torch.Generator(device=dev).manual_seed(0),
                                             device=dev),
                        max_batch=3, max_len=32, global_offload_ratio=0.5, page_size=4,
                        jit_step=jit_step, device=dev)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=6) for i, n in enumerate(SERVE_PROMPT_LENS)]
    for r in reqs:
        eng.submit(r)
    findings, ops_walked, step = [], 0, 0
    while eng.scheduler.waiting or eng.prefilling or any(r is not None for r in eng.active):
        if lint_from is None or step < lint_from:
            eng.step()
        else:
            seeds = MZ.engine_remote_tensors(eng)
            assert any(t.is_pinned() for t in seeds)
            with MZ.MaterializationLint(rule="DAK001", where=f"step {step}") as lint:
                lint.seed(seeds)
                eng.step()
            findings += lint.findings
            ops_walked += lint.ops
        step += 1
    torch.cuda.synchronize()
    return [r.out_tokens for r in reqs], findings, ops_walked


def test_lint_is_green_over_an_eager_engine_with_pinned_tiers(cuda_device):
    cfg = TC.get_smoke("llama2_7b")
    plain, _, _ = _lint_served(cfg, cuda_device, jit_step=False, lint_from=None)
    tokens, findings, walked = _lint_served(cfg, cuda_device, jit_step=False, lint_from=0)
    assert findings == [] and walked > 0
    assert tokens == plain


def test_lint_around_graphed_replays_keeps_them_and_their_tokens(cuda_device):
    """Steps after the first (the capture) replay the graph under the lint."""
    cfg = TC.get_smoke("llama2_7b")
    plain, _, _ = _lint_served(cfg, cuda_device, jit_step=True, lint_from=None)
    tokens, findings, _ = _lint_served(cfg, cuda_device, jit_step=True, lint_from=2)
    assert findings == []
    assert tokens == plain


def test_lint_fires_on_a_remote_tier_moved_to_the_card(cuda_device):
    from repro_torch.analysis import materialization as MZ
    from repro_torch.core import tiering

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    w = tiering.place(tiering.partition(
        torch.randn((64, 96), generator=gen, device=cuda_device), 0.5, axis=-1, align=16))
    x = torch.randn((4, 64), generator=gen, device=cuda_device)
    assert w.remote.is_pinned()
    staged = torch.empty(w.remote.shape, device=cuda_device)

    def prefetch(x, w):                  # the prefetch yardstick: stage, then cuBLAS
        staged.copy_(w.remote, non_blocking=True)
        return torch.cat([x @ w.local, x @ staged], dim=1)

    for fn in (lambda x, w: x @ w.remote.to("cuda"), prefetch):
        fs = MZ.lint_traced(fn, (x, w), rule="DAK001", where="card")
        assert [(f.rule, f.context["kind"]) for f in fs] == [("DAK001", "device-move")]
        assert "onto cuda" in fs[0].detail
    y = MZ.lint_traced(lambda x, w: ops.tiered_matmul(x, w), (x, w), rule="DAK001",
                       where="card")
    assert y == []


# ---------------------------------------------------------------------------
# The training stack on the card
# ---------------------------------------------------------------------------
def _tree_rel_err(got, want) -> float:
    from repro_torch.tree import flatten

    return max(rel_err(a, b) for (_, a), (_, b) in zip(flatten(got), flatten(want), strict=True))


def test_train_step_on_card_matches_the_cpu(cuda_device):
    """One loss-and-gradient pass and one train step of the smoke dense model,
    the card against the CPU on the same weights and batch (fp32)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    cfg = TC.get_smoke("starcoder2_3b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticPipeline(cfg, ShapeConfig("t", 32, 4, "train")).batch_at(0).items()}
    on_card = tree_map(lambda t: t.to(cuda_device), params)
    card_batch = {k: v.to(cuda_device) for k, v in batch.items()}
    for n_mb in (1, 2):
        loss, grads = S.make_loss_and_grads(cfg, n_mb)(params, batch)
        card_loss, card_grads = S.make_loss_and_grads(cfg, n_mb)(on_card, card_batch)
        assert float(card_loss) == pytest.approx(float(loss), rel=TOL[torch.float32])
        assert _tree_rel_err(card_grads, grads) < TOL[torch.float32]
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    step = S.make_train_step(cfg, opt_cfg)
    loss, _, state, _ = step(params, adamw.init(params), batch)
    card_loss, _, card_state, _ = step(on_card, adamw.init(on_card), card_batch)
    assert float(card_loss) == pytest.approx(float(loss), rel=TOL[torch.float32])
    assert card_state["step"].device.type == "cuda" and int(card_state["step"]) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_on_card_matches_the_cpu(cuda_device, dtype, monkeypatch):
    """`adamw.update` on CUDA tensors, leaves walked in slices, against the
    same update on the CPU from the same gradients: params and moments."""
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    monkeypatch.setattr(adamw, "CHUNK", 1000)
    g = torch.Generator().manual_seed(5)
    params = {"w": torch.randn((7, 300), generator=g).to(dtype),
              "layers": {"wi": torch.randn((3, 40, 50), generator=g).to(dtype)}}
    grads = tree_map(lambda p: (3 * torch.randn(p.shape, generator=g)).to(dtype), params)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    cpu_p, cpu_s = tree_map(torch.clone, params), adamw.init(params)
    card_p = tree_map(lambda t: t.to(cuda_device), params)
    card_s = adamw.init(card_p)
    card_g = tree_map(lambda t: t.to(cuda_device), grads)
    for _ in range(2):
        cpu_p, cpu_s, norm = adamw.update(cpu_p, grads, cpu_s, cfg)
        card_p, card_s, card_norm = adamw.update(card_p, card_g, card_s, cfg)
        assert float(card_norm) == pytest.approx(float(norm), rel=1e-5)
    assert card_s["step"].device.type == "cuda" and card_s["step"].dtype == torch.int32
    for got, want in ((card_p, cpu_p), (card_s["m"], cpu_s["m"]), (card_s["v"], cpu_s["v"])):
        assert _tree_rel_err(got, want) < TOL[dtype]


def test_checkpoint_roundtrip_of_card_bf16_leaves(cuda_device, tmp_path):
    """bf16 leaves on the card saved (raw words) and restored onto the card
    bit for bit; an async save snapshots at the call."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.tree import flatten, tree_map

    g = torch.Generator(device=cuda_device).manual_seed(1)
    tree = {"params": {"w": torch.randn((64, 33), generator=g, device=cuda_device)
                       .to(torch.bfloat16)},
            "opt": {"m": torch.randn((64, 33), generator=g, device=cuda_device),
                    "step": torch.ones((), dtype=torch.int32, device=cuda_device)}}
    want = tree_map(torch.clone, tree)
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(3, tree)
    tree["params"]["w"].add_(1)
    mgr.wait()
    out, _ = mgr.restore(3, like=want)
    for (key, a), (_, b) in zip(flatten(out), flatten(want)):
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b), key
