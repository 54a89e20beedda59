#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py              # every phase, needs one CUDA card

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
runs, printing each result on its own line:

1. the card (name, power limit, PCIe link) and what ptxas reports for each
   kernel (registers, shared memory, spills);
2. every kernel against its plain PyTorch version on the card, with the
   remote operand in pinned host memory, at the main path's decode and
   prefill shapes and windows {1, 2, 4}, plus edge cases; bound: 2e-4
   relative error in fp32, 5e-2 in bf16 (the reference's own tolerances);
3. token parity: a 2-layer full-width llama2-7b in fp32 served by the
   engine must emit exactly the tokens of the plain per-request reference;
4. the served run: full llama2-7b (32 layers, bf16) at offload 0.5 through
   `ServingEngine` — requests, tokens/s, TPOT, TTFT, kernel launches, page
   high-water marks, pinned host bytes and peak device memory;
5. each kernel's time on the card (CUDA events, L2 flushed), its plain
   version's time, its bound and the prefetch-then-cuBLAS yardstick;
6. one JSON line listing the kernels, then the card's name and power
   limit, then the final JSON status line.

Any failed check exits non-zero; without a CUDA card, or without the port
beside this file, it exits non-zero and prints no result.  ``--phases``
runs a subset (for quick checks while developing).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
HBM_BW = 3.35e12            # H100 SXM data sheet, bytes/s
BF16_PEAK = 989e12          # H100 SXM dense bf16 FLOP/s
PCIE_LANE_GBPS = {1: 0.25, 2: 0.5, 3: 0.985, 4: 1.969, 5: 3.938, 6: 7.563}
DECODE_BATCH = 4
PREFILL_LEN = 128

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.float(), b.float()
    diff = (a - b).abs().max().item() if a.numel() else 0.0
    scale = b.abs().max().item() if b.numel() else 0.0
    return diff / (scale + 1e-9), diff


# ---------------------------------------------------------------------------
# Phase 1: the card
# ---------------------------------------------------------------------------
def phase_card(libs) -> dict:
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,pcie.link.gen.max,"
         "pcie.link.width.max", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name, power, gen, width = (s.strip() for s in q.split(","))
    if gen.isdigit() and width.isdigit() and int(gen) in PCIE_LANE_GBPS:
        link = PCIE_LANE_GBPS[int(gen)] * int(width) * 1e9
        how = "from the link nvidia-smi reports"
    else:
        link = 64e9
        how = "nvidia-smi reports no link; taking Gen5 x16 nominal"
    print(f"card: {name} | power limit {power} | PCIe gen {gen} x{width} "
          f"-> host-link peak {link / 1e9:.1f} GB/s per direction ({how})")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    for src, log in libs.ptxas.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas[{src}]: {line.strip()}")
    return {"name": name, "power": power, "link_bw": link}


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions on the card
# ---------------------------------------------------------------------------
GEMM_SHAPES = {          # name: (K, N_loc, N_rem) at offload 0.5, llama2-7b
    "wq": (4096, 2048, 2048),
    "wkv": (4096, 4096, 4096),
    "wo": (4096, 2048, 2048),
    "wi": (4096, 11008, 11008),
    "wdown": (11008, 2048, 2048),
    "lm_head": (4096, 16000, 16000),
}


def make_tier_pair(k, n_loc, n_rem, dtype, gen):
    from repro_torch.kernels import _build

    wl = (torch.randn((k, n_loc), generator=gen, device="cuda") * 0.02).to(dtype)
    wr_dev = (torch.randn((k, n_rem), generator=gen, device="cuda") * 0.02).to(dtype)
    wr = _build.pinned_empty((k, n_rem), dtype)
    wr.copy_(wr_dev)
    return wl, wr, wr_dev


def gemm_case(label, m, k, n_loc, n_rem, dtype, windows, gen, stats=None, tiers=None):
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_gemm import splitk_gemm

    wl, wr, wr_dev = tiers if tiers is not None else make_tier_pair(k, n_loc, n_rem, dtype, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    want = ref.splitk_gemm_ref(x, wl, wr_dev)
    for w in windows:
        got = splitk_gemm(x, wl, wr, window=w)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        check(rel < TOL[dtype] and torch.isfinite(got.float()).all().item(),
              f"splitk_gemm {label} M={m} K={k} N={n_loc}|{n_rem} {str(dtype)[6:]} "
              f"window={w}: max rel err {rel:.2e} (abs {ab:.2e}, bound {TOL[dtype]:.0e})")
        if stats is not None:
            stats["max_abs_err"] = max(stats["max_abs_err"], ab)
            stats["max_rel_err"] = max(stats["max_rel_err"], rel)


def paged_inputs(b, h, kh, hd, ps, mp, p_loc, p_rem, lens, dtype, gen, alias_v=False):
    from repro_torch.kernels import _build

    def pool(p):
        return torch.randn((p + 1, ps, kh, hd), generator=gen, device="cuda").to(dtype)

    pools_dev = {"k_local": pool(p_loc), "k_remote": pool(p_rem)}
    pools_dev["v_local"] = pools_dev["k_local"] if alias_v else pool(p_loc)
    pools_dev["v_remote"] = pools_dev["k_remote"] if alias_v else pool(p_rem)
    pools = {}
    for key, t in pools_dev.items():
        if key.endswith("remote"):
            if alias_v and key == "v_remote":
                pools[key] = pools["k_remote"]
                continue
            host = _build.pinned_empty(t.shape, dtype)
            host.copy_(t)
            pools[key] = host
        else:
            pools[key] = t
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(dtype)
    rng = np.random.default_rng(b * 1000 + mp)
    tier = rng.integers(0, 2, size=(b, mp))
    table = np.where(tier > 0, rng.integers(0, p_rem, size=(b, mp)),
                     rng.integers(0, p_loc, size=(b, mp)))
    as_dev = lambda a: torch.tensor(np.asarray(a, np.int32), device="cuda")  # noqa: E731
    return q, pools, pools_dev, as_dev(table), as_dev(tier), as_dev(lens)


def attn_case(label, b, h, kh, hd, ps, mp, p_loc, p_rem, lens, dtype, windows, gen,
              scale=None, alias_v=False, stats=None):
    from repro_torch.kernels import ops, ref

    q, pools, pools_dev, table, tier, lens_t = paged_inputs(
        b, h, kh, hd, ps, mp, p_loc, p_rem, lens, dtype, gen, alias_v)
    want = ref.paged_flashattn_ref(q, pools_dev["k_local"], pools_dev["v_local"],
                                   pools_dev["k_remote"], pools_dev["v_remote"],
                                   table, tier, lens_t, scale=scale)
    for w in windows:
        got = ops.paged_decode_attention(q, pools, table, tier, lens_t, window=w, scale=scale)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        zeros_ok = all(bool((got[i] == 0).all()) for i, n in enumerate(lens) if n == 0)
        check(rel < TOL[dtype] and zeros_ok,
              f"paged_attention {label} B={b} H={h} Kh={kh} hd={hd} page={ps} "
              f"lens={list(lens)} {str(dtype)[6:]} window={w}"
              f"{' scale=' + str(scale) if scale else ''}{' V=K' if alias_v else ''}: "
              f"max rel err {rel:.2e} (abs {ab:.2e}, bound {TOL[dtype]:.0e}), "
              f"zero rows for lens 0: {zeros_ok}")
        if stats is not None:
            stats["max_abs_err"] = max(stats["max_abs_err"], ab)
            stats["max_rel_err"] = max(stats["max_rel_err"], rel)


def scatter_case(gen):
    from repro_torch.kernels import _build
    from repro_torch.kernels.splitk_flashattn import scatter_rows, scatter_rows_ref

    p, ps, kh, hd, b = 6, 16, 32, 128, 4
    rows = torch.randn((b, kh, hd), generator=gen, device="cuda").to(torch.bfloat16)
    wr_tier = torch.tensor([0, 1, 1, 0], dtype=torch.int32, device="cuda")
    wr_idx = torch.tensor([2, 0, 3, 5], dtype=torch.int32, device="cuda")
    wr_off = torch.tensor([0, 15, 7, 3], dtype=torch.int32, device="cuda")
    ok = True
    for tier_sel, remote in ((0, False), (1, True)):
        dev_pool = torch.randn((p + 1, ps, kh, hd), generator=gen, device="cuda").to(torch.bfloat16)
        pool = dev_pool.clone()
        if remote:
            pool = _build.pinned_empty(dev_pool.shape, dev_pool.dtype)
            pool.copy_(dev_pool)
        scatter_rows(pool, rows, wr_tier, wr_idx, wr_off, tier_sel, p, remote=remote)
        torch.cuda.synchronize()
        sel = wr_tier == tier_sel
        scatter_rows_ref(dev_pool, rows[sel], wr_idx[sel], wr_off[sel])
        ok = ok and torch.equal(pool.cuda(), dev_pool)
    check(ok, "scatter_rows (decode K/V row writer helper): local and remote pools "
              "bit-identical to the plain index_put")


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    stats = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0}
             for n in ("splitk_gemm", "paged_attention")}
    bf = torch.bfloat16
    for name, (k, n_loc, n_rem) in GEMM_SHAPES.items():
        tiers = make_tier_pair(k, n_loc, n_rem, bf, gen)
        for m in (DECODE_BATCH, PREFILL_LEN):
            gemm_case(name, m, k, n_loc, n_rem, bf, (1, 2, 4), gen,
                      stats["splitk_gemm"], tiers)
        del tiers
    gemm_case("fp32", 64, 512, 256, 256, torch.float32, (1, 2, 4), gen)
    gemm_case("empty-local", DECODE_BATCH, 4096, 0, 2048, bf, (1, 2), gen)
    gemm_case("empty-remote", DECODE_BATCH, 4096, 2048, 0, bf, (1, 2), gen)
    gemm_case("ragged", 33, 200, 136, 72, bf, (1, 4), gen)
    gemm_case("ragged", 150, 200, 136, 72, bf, (1, 4), gen)
    gemm_case("unaligned", 5, 100, 50, 30, torch.float32, (1, 2), gen)
    full = dict(h=32, kh=32, hd=128, ps=16)
    attn_case("full-width", b=DECODE_BATCH, mp=10, p_loc=20, p_rem=20,
              lens=(150, 0, 37, 160), dtype=bf, windows=(1, 2, 4), gen=gen,
              stats=stats["paged_attention"], **full)
    attn_case("full-width", b=DECODE_BATCH, mp=10, p_loc=20, p_rem=20,
              lens=(1, 16, 17, 99), dtype=torch.float32, windows=(1, 2, 4), gen=gen, **full)
    attn_case("scale", b=3, mp=4, p_loc=5, p_rem=5, lens=(5, 0, 32), dtype=torch.float32,
              windows=(2,), gen=gen, scale=0.07, h=8, kh=2, hd=32, ps=8)
    attn_case("gqa", b=4, mp=4, p_loc=6, p_rem=5, lens=(5, 0, 17, 32),
              dtype=torch.float32, windows=(1, 4), gen=gen, h=8, kh=2, hd=32, ps=8)
    attn_case("k-only", b=3, mp=3, p_loc=4, p_rem=4, lens=(7, 12, 3), dtype=bf,
              windows=(2,), gen=gen, alias_v=True, h=16, kh=1, hd=72, ps=4)
    attn_case("unaligned", b=3, mp=3, p_loc=4, p_rem=4, lens=(9, 0, 12), dtype=bf,
              windows=(1, 2), gen=gen, h=4, kh=2, hd=30, ps=4)
    scatter_case(gen)
    return stats


# ---------------------------------------------------------------------------
# Phase 3: token parity on the card (fp32, full width, 2 layers)
# ---------------------------------------------------------------------------
def reference_tokens(cfg, params, prompt, new_tokens, max_len):
    from repro_torch.models import model as M

    logits, cache = M.prefill(cfg, params, {"tokens": prompt[None, :]}, max_len=max_len)
    toks, gaps = [int(torch.argmax(logits[0, -1]))], []
    gaps.append(float(torch.topk(logits[0, -1].float(), 2).values.diff().abs()))
    pos = prompt.shape[0]
    while len(toks) < new_tokens:
        logits, cache = M.decode_step(
            cfg, params, cache, torch.tensor([[toks[-1]]], device="cuda"), pos)
        toks.append(int(torch.argmax(logits[0, 0])))
        gaps.append(float(torch.topk(logits[0, 0].float(), 2).values.diff().abs()))
        pos += 1
    return toks, gaps


def phase_parity() -> None:
    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(C.get("llama2_7b"), n_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = M.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    eng = ServingEngine(cfg, params, max_batch=3, max_len=32,
                        global_offload_ratio=0.5, page_size=4, device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab, n).astype(np.int32) for n in (10, 16, 7, 14, 9)]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    check(stats.served == len(reqs), f"parity run served {stats.served}/{len(reqs)}")
    for r in reqs:
        want, gaps = reference_tokens(
            cfg, params, torch.tensor(r.prompt, device="cuda"), 8, 32)
        check(r.out_tokens == want,
              f"request {r.rid}: engine {r.out_tokens} vs reference {want} "
              f"(smallest top-2 logit gap {min(gaps):.3e})")
    check(stats.local_pages_hwm >= 1 and stats.remote_pages_hwm >= 1,
          f"parity run pages in both tiers: local hwm {stats.local_pages_hwm}, "
          f"remote hwm {stats.remote_pages_hwm}, spills {stats.spills}")


# ---------------------------------------------------------------------------
# Phase 4: the served run (full llama2-7b, bf16, offload 0.5)
# ---------------------------------------------------------------------------
def remote_leaves(tree):
    from repro_torch.core.tiering import TieredTensor

    if isinstance(tree, dict):
        for v in tree.values():
            yield from remote_leaves(v)
    elif isinstance(tree, TieredTensor):
        yield tree


def phase_serve() -> dict:
    import repro_torch.configs as C
    from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn, scatter_rows
    from repro_torch.kernels.splitk_gemm import splitk_gemm
    from repro_torch.models import model as M
    from repro_torch.runtime.telemetry import weight_tier_bytes
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = C.get("llama2_7b")
    n_req, prompt_len, new_tokens = 8, PREFILL_LEN, 32
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    eng = ServingEngine(cfg, params, max_batch=DECODE_BATCH,
                        max_len=prompt_len + new_tokens, global_offload_ratio=0.5,
                        page_size=16, device="cuda")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"served run set-up (weights drawn, partitioned, remote tier pinned): "
          f"{time.time() - t0:.1f} s")
    leaves = list(remote_leaves(eng.params))
    w_local, w_remote = weight_tier_bytes(eng.params)
    pinned = sum(leaf.remote.nbytes for leaf in leaves) + sum(
        p.nbytes for k, p in eng.pcache.pools.items() if k.endswith("remote"))
    check(all(leaf.remote.is_pinned() and leaf.remote.device.type == "cpu"
              for leaf in leaves) and len(leaves) == 6,
          f"all {len(leaves)} remote weight tiers are pinned host memory, none on the card")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens) for i in range(n_req)]
    torch.cuda.reset_peak_memory_stats()
    splitk_gemm.launches = paged_splitk_flashattn.launches = scatter_rows.launches = 0
    t0 = time.time()
    for r in reqs:
        eng.submit(r)
    stats = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"splitk_gemm": splitk_gemm.launches,
                "paged_attention": paged_splitk_flashattn.launches,
                "scatter_rows": scatter_rows.launches}
    peak = torch.cuda.max_memory_allocated()
    total_w = w_local + w_remote
    print(f"served {stats.served}/{n_req} requests ({prompt_len} prompt + {new_tokens} new "
          f"tokens each) in {wall:.2f} s | {stats.generated_tokens / wall:.2f} tokens/s | "
          f"TPOT {stats.tpot * 1e3:.1f} ms over {stats.decode_steps} decode steps | "
          f"TTFT p50 {stats.ttft_p50 * 1e3:.1f} ms | prefill total {stats.prefill_time:.2f} s")
    print(f"launches during the served run: {launches}")
    print(f"kv pages: local hwm {stats.local_pages_hwm}/{eng.pcache.n_local}, remote hwm "
          f"{stats.remote_pages_hwm}/{eng.pcache.n_remote}, spills {stats.spills}")
    print(f"weights: {w_local / 1e9:.3f} GB local + {w_remote / 1e9:.3f} GB remote | "
          f"pinned host bytes {pinned} ({pinned / 1e9:.3f} GB) | peak device memory "
          f"during serving {peak} ({peak / 1e9:.3f} GB) vs total weights {total_w / 1e9:.3f} GB")
    check(stats.served == n_req, f"served every request ({stats.served}/{n_req})")
    check(all(len(r.out_tokens) == new_tokens and all(0 <= t < cfg.vocab for t in r.out_tokens)
              for r in reqs), f"every request emitted {new_tokens} tokens in [0, vocab)")
    check(launches["splitk_gemm"] > 0 and launches["paged_attention"] > 0,
          "both kernels launched on the main path")
    check(stats.local_pages_hwm >= 1 and stats.remote_pages_hwm >= 1,
          "KV pages resident in both tiers")
    check(peak < total_w, "peak device memory below the model's total weight bytes "
                          "(the remote tier never came into HBM)")
    return {"launches": launches, "tpot_ms": stats.tpot * 1e3,
            "steps": stats.decode_steps}


# ---------------------------------------------------------------------------
# Phase 5: timing at the main-path shapes
# ---------------------------------------------------------------------------
def time_ms(fn, iters=10, flush=None) -> float:
    """Median ms of `fn` over `iters` launches, each timed alone with CUDA
    events after `flush()` evicts L2 (50 MB) so weights come from memory."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(local_bytes, remote_bytes, flops, link_bw, peak):
    t_bytes = max(local_bytes / HBM_BW, remote_bytes / link_bw)
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_timing(card: dict, window: int) -> dict:
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.splitk_gemm import splitk_gemm

    link = card["link_bw"]
    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    step = {"splitk_gemm": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                                t_bytes=0.0, t_ops=0.0),
            "paged_attention": dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                                    t_bytes=0.0, t_ops=0.0)}
    print(f"timing on {card['name']} (power limit {card['power']}), CUDA events, "
          f"L2 flushed before each launch, median of 10; window {window} unless noted")
    for name, (k, n_loc, n_rem) in GEMM_SHAPES.items():
        wl, wr, wr_dev = make_tier_pair(k, n_loc, n_rem, bf, gen)
        count = 1 if name == "lm_head" else 32
        for m in (DECODE_BATCH, PREFILL_LEN):
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf)
            t = {w: time_ms(lambda w=w: splitk_gemm(x, wl, wr, window=w), flush=flush)
                 for w in (1, 2, 4)}
            t_plain = time_ms(lambda: ref.splitk_gemm_ref(x, wl, wr_dev), flush=flush)

            def prefetch(x=x, wl=wl, wr=wr, wr_dev=wr_dev):
                wr_dev.copy_(wr, non_blocking=True)
                return torch.cat([x @ wl, x @ wr_dev], dim=1)

            t_lib = time_ms(prefetch, flush=flush)
            loc_b = (x.numel() + wl.numel() + m * (n_loc + n_rem)) * 2
            rem_b = wr.numel() * 2
            flops = 2 * m * k * (n_loc + n_rem)
            b_ms, b_by = bound(loc_b, rem_b, flops, link, BF16_PEAK)
            tk = t[window]
            print(f"  splitk_gemm {name} M={m} K={k} N={n_loc}|{n_rem} bf16: kernel "
                  f"{tk:.4f} ms (windows 1/2/4: {t[1]:.4f}/{t[2]:.4f}/{t[4]:.4f}) | plain "
                  f"{t_plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | prefetch+cuBLAS "
                  f"{t_lib:.4f} ms | remote {rem_b / (tk * 1e-3) / 1e9:.2f} GB/s")
            if m == DECODE_BATCH:
                s = step["splitk_gemm"]
                s["ms"] += count * tk
                s["plain_ms"] += count * t_plain
                s["bound_ms"] += count * b_ms
                s["library_ms"] += count * t_lib
                s["t_bytes"] += count * max(loc_b / HBM_BW, rem_b / link)
                s["t_ops"] += count * flops / BF16_PEAK
        del wl, wr, wr_dev
    # decode attention at the served run's late-step shape: 4 slots, ~150
    # tokens each, pages split across the tiers
    from repro_torch.kernels.ref import paged_flashattn_ref

    lens = (150, 144, 139, 158)
    q, pools, pools_dev, table, tier, lens_t = paged_inputs(
        DECODE_BATCH, 32, 32, 128, 16, 10, 20, 20, lens, bf, gen)
    t = {w: time_ms(lambda w=w: ops.paged_decode_attention(q, pools, table, tier, lens_t,
                                                           window=w), flush=flush)
         for w in (1, 2, 4)}
    t_plain = time_ms(lambda: paged_flashattn_ref(
        q, pools_dev["k_local"], pools_dev["v_local"], pools_dev["k_remote"],
        pools_dev["v_remote"], table, tier, lens_t), flush=flush)
    tier_np, page_bytes = tier.cpu().numpy(), 16 * 128 * 2 * 2   # K+V, one kv head
    loc_b = q.numel() * 2 * 2
    rem_b = 0
    for b, n in enumerate(lens):
        for p in range(-(-n // 16)):
            if tier_np[b, p]:
                rem_b += 32 * page_bytes
            else:
                loc_b += 32 * page_bytes
    flops = 4 * sum(lens) * 32 * 128
    b_ms, b_by = bound(loc_b, rem_b, flops, link, BF16_PEAK)
    tk = t[window]
    print(f"  paged_attention B=4 H=Kh=32 hd=128 page=16 lens={list(lens)} bf16: kernel "
          f"{tk:.4f} ms (windows 1/2/4: {t[1]:.4f}/{t[2]:.4f}/{t[4]:.4f}) | plain "
          f"{t_plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | library call: none | "
          f"remote {rem_b / (tk * 1e-3) / 1e9:.2f} GB/s")
    s = step["paged_attention"]
    s.update(ms=32 * tk, plain_ms=32 * t_plain, bound_ms=32 * b_ms,
             t_bytes=32 * max(loc_b / HBM_BW, rem_b / link), t_ops=32 * flops / BF16_PEAK)
    print(f"  per decode step at batch 4 (32 layers + lm_head): splitk_gemm "
          f"{step['splitk_gemm']['ms']:.3f} ms vs bound {step['splitk_gemm']['bound_ms']:.3f} ms;"
          f" paged_attention {s['ms']:.3f} ms vs bound {s['bound_ms']:.3f} ms")
    return step


# ---------------------------------------------------------------------------
def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5",
                    help="comma-separated subset of phases 1-5 (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port (src/repro_torch) is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.time()
    libs = _build.load()
    print(f"kernels built from {_build.CSRC.relative_to(REPO)} in {time.time() - t0:.1f} s "
          f"into {_build.build_dir().relative_to(REPO)}")
    card = phase_card(libs)
    stats = {n: {"max_abs_err": None, "max_rel_err": None}
             for n in ("splitk_gemm", "paged_attention")}
    served = {"launches": {}}
    step = {}
    if 2 in phases:
        print("phase 2: kernels against their plain versions on the card")
        stats = phase_kernels()
    if 3 in phases:
        print("phase 3: token parity, 2-layer full-width llama2-7b, fp32, offload 0.5, page 4")
        phase_parity()
    if 4 in phases:
        print("phase 4: served run, llama2-7b (32 layers, bf16), offload 0.5, page 16")
        served = phase_serve()
    if 5 in phases:
        print("phase 5: timing")
        step = phase_timing(card, window=1)
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    replaces = {
        "splitk_gemm": ("src/repro_torch/kernels/csrc/splitk_gemm.cu",
                        "src/repro/kernels/splitk_gemm.py:37"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_flashattn.cu",
                            "src/repro/kernels/splitk_flashattn.py:236"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        s = step.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": served["launches"].get(name),
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": s.get("ms"), "plain_ms": s.get("plain_ms"), "bound_ms": s.get("bound_ms"),
            "bound_by": (None if not s else
                         "bytes" if s["t_bytes"] >= s["t_ops"] else "operations"),
            "library_ms": s.get("library_ms"),
        })
    print("kernel times are per decode step at batch 4 (32 layers + lm_head); "
          "max_abs_err is over the bf16 main-path shape checks")
    print(json.dumps({"kernels": kernels}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
