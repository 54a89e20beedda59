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
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.splitk_flashattn import (
    paged_splitk_flashattn,
    scatter_rows,
    scatter_rows_ref,
)
from repro_torch.kernels.splitk_gemm import splitk_gemm
from repro_torch.models import model as TM
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
