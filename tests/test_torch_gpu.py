"""The port's CUDA kernels and engine on the card, against their plain
PyTorch versions on the same inputs.  Every test here is marked `gpu` and
skips without a card; run them on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX: the machine with the card has none.  Bounds are
the reference's kernel tolerances: 2e-4 relative in fp32, 5e-2 in bf16."""
from __future__ import annotations


import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels import _build, flash_prefill, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.splitk_flashattn import (
    paged_splitk_flashattn,
    scatter_rows,
    scatter_rows_ref,
    splitk_flashattn,
)
from repro_torch.kernels.splitk_gemm import splitk_gemm
from repro_torch.models import model as TM
from repro_torch.serving import tiered_decode as TD
from repro_torch.serving.engine import Request, ServingEngine
from torch_helpers import cuda_device, rel_err  # noqa: F401  (fixture)

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}


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
                                             (5, 100, 0, 30), (7, 64, 64, 0)])
@pytest.mark.parametrize("window", [1, 2, 4])
def test_splitk_gemm_matches_plain(cuda_device, dtype, m, k, n_loc, n_rem, window):
    gen = torch.Generator(device=cuda_device).manual_seed(m * k)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    wl = torch.randn((k, n_loc), generator=gen, device=cuda_device).to(dtype)
    wr_dev = torch.randn((k, n_rem), generator=gen, device=cuda_device).to(dtype)
    before = splitk_gemm.launches
    got = splitk_gemm(x, wl, _pinned(wr_dev), window=window)
    torch.cuda.synchronize()
    assert splitk_gemm.launches == before + 1
    assert rel_err(got, tref.splitk_gemm_ref(x, wl, wr_dev)) < TOL[dtype]
    if n_rem:
        with pytest.raises(ValueError, match="pinned host memory"):
            splitk_gemm(x, wl, wr_dev, window=window)     # remote tier on the card


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [1, 2, 4])
@pytest.mark.parametrize("scale", [None, 0.11])
def test_paged_attention_matches_plain(cuda_device, dtype, window, scale):
    rng = np.random.default_rng(window)
    b, h, kh, hd, ps, mp = 4, 8, 2, 32, 8, 4
    dev = cuda_device
    q = torch.from_numpy(rng.normal(size=(b, h, hd))).to(dev, dtype)
    pools_dev = {n: torch.from_numpy(rng.normal(size=(p + 1, ps, kh, hd))).to(dev, dtype)
                 for n, p in (("k_local", 6), ("v_local", 6), ("k_remote", 5), ("v_remote", 5))}
    pools = {k: (_pinned(v) if k.endswith("remote") else v) for k, v in pools_dev.items()}
    table = torch.from_numpy(rng.integers(0, 5, size=(b, mp)).astype(np.int32)).to(dev)
    tier = torch.from_numpy(rng.integers(0, 2, size=(b, mp)).astype(np.int32)).to(dev)
    lens = torch.tensor([5, 0, 17, 32], dtype=torch.int32, device=dev)
    before = paged_splitk_flashattn.launches
    got = ops.paged_decode_attention(q, pools, table, tier, lens, window=window, scale=scale)
    torch.cuda.synchronize()
    assert paged_splitk_flashattn.launches == before + 1
    want = tref.paged_flashattn_ref(q, pools_dev["k_local"], pools_dev["v_local"],
                                    pools_dev["k_remote"], pools_dev["v_remote"],
                                    table, tier, lens, scale=scale)
    assert rel_err(got, want) < TOL[dtype]
    assert torch.all(got[1] == 0)


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


@pytest.mark.parametrize("ratio", [0.5, 1.0])
def test_engine_matches_plain_reference_on_card(cuda_device, ratio):
    """The engine on the card (kernels, pinned remote tiers) emits exactly
    the tokens of the plain per-request reference on the card (fp32,
    llama2-7b smoke, page 4, prompts that force spills)."""
    cfg = TC.get_smoke("llama2_7b")
    params = TM.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            device=cuda_device)
    eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=ratio,
                        page_size=4, device=cuda_device)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=8) for i, n in enumerate((10, 16, 7, 14, 9))]
    for r in reqs:
        eng.submit(r)
    assert eng.run().served == len(reqs)
    for r in reqs:
        logits, cache = TM.prefill(cfg, params, {"tokens": torch.tensor(r.prompt,
                                                                         device=cuda_device)[None]},
                                   max_len=32)
        want, pos = [int(torch.argmax(logits.reshape(-1)))], len(r.prompt)
        while len(want) < 8:
            logits, cache = TM.decode_step(
                cfg, params, cache, torch.tensor([[want[-1]]], device=cuda_device), pos)
            want.append(int(torch.argmax(logits.reshape(-1))))
            pos += 1
        assert r.out_tokens == want, f"request {r.rid}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_loc,b_rem,h,kh,hd,s,kv_len", [
    (2, 2, 8, 2, 32, 64, 64),           # GQA, whole cache
    (2, 3, 4, 4, 64, 200, 150),         # kv_len < S, several chunks, ragged last chunk
    (0, 3, 4, 2, 32, 40, 40),           # every request remote
    (3, 0, 4, 2, 32, 40, 1),            # every request local, one position
    (1, 2, 4, 2, 30, 150, 130),         # hd not a multiple of 16 B, several chunks
])
@pytest.mark.parametrize("window", [1, 3])
def test_splitk_flashattn_matches_plain(cuda_device, dtype, b_loc, b_rem, h, kh, hd, s,
                                        kv_len, window):
    gen = torch.Generator(device=cuda_device).manual_seed(b_loc * 7 + b_rem)
    q = torch.randn((b_loc + b_rem, h, hd), generator=gen, device=cuda_device).to(dtype)
    dev = {f"{kv}_{t}": torch.randn((n, s, kh, hd), generator=gen, device=cuda_device).to(dtype)
           for kv in ("k", "v") for t, n in (("local", b_loc), ("remote", b_rem))}
    cache = {k: (_pinned(v) if k.endswith("remote") else v) for k, v in dev.items()}
    before = splitk_flashattn.launches
    got = ops.tiered_decode_attention(q, cache, kv_len=kv_len, window=window)
    torch.cuda.synchronize()
    assert splitk_flashattn.launches == before + 1
    want = tref.splitk_flashattn_ref(q, dev["k_local"], dev["v_local"], dev["k_remote"],
                                     dev["v_remote"], kv_len)
    assert rel_err(got, want) < TOL[dtype]
    if b_rem:
        with pytest.raises(ValueError, match="pinned host memory"):
            splitk_flashattn(q, dev["k_local"], dev["v_local"], dev["k_remote"],
                             dev["v_remote"], kv_len=kv_len)      # remote tier on the card


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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t", [1, 63, 65, 1000, 2048])
def test_flash_prefill_tensor_cores_match_plain(cuda_device, causal, hd, t):
    """The bf16 tensor-core path at ragged and full-tile T, GQA (8 q heads
    over 2 kv heads), checked row by row."""
    gen = torch.Generator(device=cuda_device).manual_seed(t * hd)
    q = torch.randn((2, 8, t, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((2, 2, t, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    assert torch.isfinite(got.float()).all()
    assert _row_rel_err(got, tref.flash_prefill_ref(q, k, v, causal)) < TOL[torch.bfloat16]


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
                               mm=lambda a, w: TD._mm(a, w, 2))
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
