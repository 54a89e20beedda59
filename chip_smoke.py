#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py              # phases 1-8 and 11-33, needs one CUDA card
    python3 chip_smoke.py --phases 1,9 # the host-link read probe
    python3 chip_smoke.py --phases 1,34   # a traced full-size train step
    python3 chip_smoke.py --phases 1,35   # the dry run on the card's machine
    python3 chip_smoke.py --phases 1,5,9  # kernel timings and the probe

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
runs, printing each result on its own line:

1. the card (name, power limit, PCIe link), the host's RAM (MemTotal and
   MemAvailable) and what ptxas reports for each kernel (registers, shared
   memory, spills);
2. every kernel against its plain PyTorch version on the card, with the
   remote operand in pinned host memory, at the main paths' decode and
   prefill shapes and windows {1, 2, 4}, plus edge cases; bound: 2e-4
   relative error in fp32, 5e-2 in bf16 (the reference's own tolerances),
   taken per query row for flash_prefill (its wgmma design at hd 64 and
   128, T 1 to 2048, causal and full, GQA and H = Kh, Tq != Tk; hd 32, 96,
   256 and a misaligned view on the mma.sync design; every case launched
   twice, bitwise equal); also the expert FFN at
   Qwen3-30B-A3B's and DeepSeek-V2's widths (the remote block through two
   `splitk_gemm_grouped` launches, experts without a valid slot skipped on
   the device, also held against the per-expert `splitk_gemm` loop it
   replaced), `splitk_gemm_grouped` alone (K splits, M tiles past 64 rows,
   ragged N, one and no active expert; first of all a weight box multicast
   from pinned host memory to a cluster of 3; the cluster design at M 17,
   64, 65, 192, 384 and 1100: clusters of 1, 1, 2, 3, 6 and two of 5; every
   case launched twice, bitwise equal, its counted host bytes equal to the
   tiling's; the launch geometry's shared memory against the kernel's own
   count), paged attention
   at MLA's shape (128 heads over one kv head of 576, V read from K), at
   the dense variants' and LLaVA-NeXT-34B's (112 heads over 56, 48 over 8,
   32 over 2, 64 over 8) and at Zamba2's shared attention (32 heads over
   32 of hd 80), the GEMM at OPT-30B's lm_head split (N 25184 | 25088), at
   the SSM and hybrid projections' splits (Mamba2's bc_proj 128 | 128 and
   ssm_out, Zamba2's z/x_proj and shared wi and wdown; bf16 and fp32, M 4
   and 128) and at HuBERT-XLarge's and LLaVA-NeXT-34B's (bf16 and fp32, M
   4, 128, 704 and 2000), and the
   layer-by-layer build of a 2-layer OPT-30B and of a 12-layer Zamba2 (its
   shared block stack tiered) against the partition of the whole tree, bit
   for bit;
3. token parity: a 2-layer full-width llama2-7b in fp32 served by the
   engine must emit exactly the tokens of the plain per-request reference;
4. the served run: full llama2-7b (32 layers, bf16) at offload 0.5 through
   `ServingEngine` — requests, tokens/s, TPOT, TTFT, kernel launches (32
   paged-attention launches per decode step), page high-water marks, pinned
   host bytes and peak device memory; then one torch.profiler trace of
   three more decode steps: the device's busy share and the top kernels;
5. each kernel's time on the card (CUDA events, L2 flushed), its plain
   version's time, its bound and a library yardstick; the decode GEMM
   (split-K, the wrapper's design at M <= 16) beside the whole-K design it
   replaced and prefetch + cuBLAS, in alternating rounds, at offload 0.5
   and at the planner's split for launch/serve.py's default offload 0.4;
   both decode-attention kernels as the device time of their launch alone
   (the wrapper call and its host time beside it), at the served runs'
   shapes and at a long cache; `flash_prefill` in bf16 at five shapes (hd
   128 T 128 and 2048, GQA, hd 64, full): the wgmma design beside the
   mma.sync design it replaced, plain and SDPA in alternating rounds; each
   with its remote GB/s or TFLOP/s; one Qwen3 layer's
   remote experts at decode (M 1, 15 active) and at prefill (M 64, 192,
   384, all 64 active): the cluster design beside the split-K design it
   replaced, copy + bmm, plain and bound, the GB/s of unique bytes and
   both designs' counted host bytes beside the tiling model;
6. batch-split token parity: the same 2-layer fp32 model through prefill,
   `split_cache_batch` and greedy `tiered_decode_step`s (the paper's §5
   layout) must emit exactly the tokens of the plain `decode_step` path;
7. the batch-split served run: full llama2-7b (32 layers, bf16) at offload
   0.5, 4 requests (2 local + 2 remote cache rows) of 256 prompt + 32 new
   tokens — launches per step, pinned remote rows, peak device memory, TPOT;
8. `flash_prefill` (off the serving path, as in the reference) through its
   entry point at llama2-7b prefill shape, once per layer, every launch
   the wgmma design;
9. only when asked (``--phases 1,9``), the host-link read probe: a
   read-only measurement kernel (``csrc/host_probe.cu``, on no path) over
   64 MiB of pinned host memory, swept over copy form (16-byte cp.async,
   1-D bulk copy, 2-D TMA), CTAs, bytes in flight per CTA and row width,
   beside the copy engine; with phase 5, each attention kernel's remote
   rate against the probe's best read;
11. MoE token parity: phase 3's check on a 2-layer full-width Qwen3-30B-A3B
   in fp32 with dropless expert capacity;
12. the MoE served run: Qwen3-30B-A3B at its published widths and depth
   (48 layers), bf16, as phase 4, graphed (plus remote experts run and
   remote bytes per decode step, and a check of 2 `splitk_gemm_grouped`
   launches per MoE layer in every decode step); then the same traffic
   eager on the same engine: tokens and remote experts run in every step
   equal, TPOT and the profiler's step beside the graphed run's; then one
   request of 2048 prompt + 4 new tokens on an engine of one slot (48
   layers): its prefill pass under the cluster and the split-K design
   (time, counted expert bytes against the tiling model, logits within
   5e-2), then served (TTFT, TPOT, tokens);
13. MLA token parity: phase 3's check on a 1-layer full-width DeepSeek-V2
   in fp32 with dropless expert capacity;
14. the MLA served run: DeepSeek-V2 at its published widths, 2 of 60
   layers, bf16, as phase 12, graphed then eager (60 layers would pin
   about 236 GB);
15. OPT token parity: phase 3's check on a 2-layer full-width OPT-30B in
   fp32 (LayerNorm and GELU with biases, 56 kv heads, padded query heads,
   the ragged lm_head split);
16. the served run of OPT-6.7B at its published widths and depth (32
   layers, bf16), as phase 4;
17. the served run of OPT-30B, the paper's primary model, at its published
   widths and depth (48 layers, bf16, 70.5 GB of weights, 34.9 GB of them
   pinned), 4 requests of 128 prompt + 16 new tokens, as phase 4, with the
   peak device memory of set-up and of serving each below 40 GB;
18. SSM token parity: phase 3's check on a 2-layer full-width Mamba2-370M
   in fp32 (no KV pages; the conv window and SSD state per slot in HBM);
19. the SSM served run: Mamba2-370M at its published widths and depth (48
   layers, bf16), as phase 4, with no paged attention (193 splitk_gemm
   launches a decode step under today's plan: z, x, bc and ssm_out a
   layer, and lm_head; dt_proj's 32 columns stay whole);
20. hybrid token parity: phase 3's check on a 12-layer full-width
   Zamba2-2.7B in fp32, two groups, so both shared blocks run;
21. the hybrid served run: Zamba2-2.7B at its published widths and depth
   (54 layers, 9 groups, bf16), as phase 4: 208 splitk_gemm launches a
   decode step (z, x and ssm_out a layer, the 5 shared projections a
   group, lm_head) and 9 paged-attention launches;
22. frontend token parity: phase 3's check for every decoder family (2
   layers of llama2-7b, Qwen3-30B-A3B dropless and Mamba2-370M, 1 of
   DeepSeek-V2 dropless, 12 of Zamba2) with the SLO scheduler, chunks of 4
   prompt tokens (`models.prefill_chunk` through `splitk_gemm`) and mixed
   priorities on a modeled clock; then the priority-preemption case (2
   layers of llama2-7b, offload 0.7): a high-priority arrival demotes the
   active requests' pages into the pinned pool, every token exact;
23. a burst served under the frontend: llama2-7b (32 layers, bf16, offload
   0.5, page 16, 4 slots), 8 batch requests (384-512 prompt tokens) and 4
   interactive ones (64-128), all at t=0, 16 new tokens each, on the wall
   clock, FCFS with whole prompts and then SLO with chunks of 128: TPOT,
   TTFT per class, chunks, preemptions, remote weight bytes per prefill
   token (modeled from the passes' rows), and the share of requests whose
   bf16 tokens agree between the runs;
24. the encoder, HuBERT-XLarge, on 4 clips of 500 frames: a 2-layer
   full-width fp32 forward tiered at offload 0.5 against the same weights
   unsplit in HBM (2e-4), then all 48 layers in bf16 through
   `launch.steps.make_prefill_step`: ms a forward, launches, remote bytes
   once and as the whole-K design reads them (modeled from its tiling),
   peak device memory, pinned bytes, and the logits against the same 48
   layers unsplit in HBM (bf16 bound);
25. VLM parity: phase 3's check on a 2-layer full-width LLaVA-NeXT-34B in
   fp32, and a prefill of 576 patches + 16 tokens tiered at offload 0.5
   against the untiered prefill (2e-4);
26. the VLM served run: LLaVA-NeXT-34B at its published widths and depth
   (60 layers, bf16, 70.6 GB of weights, 34.9 GB pinned), 4 requests of
   128 + 16 tokens as phase 17, then one prefill of 576 patches + 128
   tokens through `launch.steps.make_prefill_step`;
27. elastic parity: a 2-layer full-width llama2-7b in fp32 (offload 0.5,
   page 4, 3 slots, phase 3's prompts) served static, with the adaptive
   runtime, with a shrink of the local page budget to 20% at decode step 2,
   and with the zero-budget runtime and the same shrink, each on the card
   and on the CPU: on the card every run's tokens equal the static run's,
   and every run's counters, health ladder and final ratio equal the CPU
   run's;
28. the adaptive runtime at full width: phase 4's llama2-7b traffic (a)
   static, (b) with the AIMD loop closed over each decode step's bandwidth,
   timed by CUDA events (window trajectory, the kernels' ring stages at each
   window, remote GB/s by window, TPOT, migration), (c) the same with the
   shrink at step 2, whose forced re-plan moves weight columns from HBM into
   new pinned tiers: 8/8 served, healthy at the end, device memory falls and
   pinned bytes rise, the re-plan's transient below one operand layer, its
   pause and TPOT and remote bytes a step before and after;
29. the compiled decode step (one CUDA graph per window bucket and pool
   shape, the default of every family): fp32 at full width and cut
   depth (2 layers of llama2-7b, Mamba2-370M and LLaVA-NeXT-34B, 12 of
   Zamba2-2.7B), graphed tokens equal to the eager engine's and the plain
   reference's, launches per engine step equal to eager's; then llama2-7b
   (16 of 32 layers; 32 before phase 33 joined the default run) and
   Mamba2-370M (48 layers) in bf16 with phase 4's traffic,
   served eagerly and then graphed on the same weights: tokens exactly
   equal, TPOT, device-busy share and host time a step of each, capture
   time per bucket and the graph pool's bytes;
30. the measurement surface and the autotuner, through `launch/serve.main`
   with phase 4's llama2-7b traffic (32 layers, bf16, offload 0.5, page 16,
   4 slots, 8 requests of 128 + 32 tokens), report and tables under
   ``build/phase30``: (a) ``--bench-json``: the report is the one `main`
   returns, schema 2 with a ``torch`` provenance stamp, its tokens/s
   consistent with its TPOT; (b) ``--autotune --autotune-cache``: every
   tuned GEMM and paged-attention configuration against its plain version
   at the served shape (bf16 and fp32), the table reloaded lookup-only
   reproducing every winner of a fresh sweep, `check_autotune_table`
   clean, TPOT tuned beside default, and the share of served GEMM shapes
   where the model's pick among {split-K, whole K} x {window 1, 2} is the
   fastest of the four on the card (printed, not gated); (c)
   ``--no-kernels`` (the reference oracle): the untiered engine's tokens
   equal the tiered engine's at 2 layers in fp32 with no kernel launched,
   then its TPOT at 32 layers in bf16 beside the all-HBM TPOT of the
   tiered engine at ``--offload-ratio 0``; (d) `smem_footprint_bytes` equal to each
   kernel's own count (``*_smem`` query entries) for every launch
   configuration of the phase, the lints' 227 KiB equal to the card's
   opt-in limit, and `check_kernels` clean at every served plan of the
   chip phases;
31. the serving mesh (`launch.mesh`, one process per rank, spawned so this
   process joins no process group), llama2-7b bf16, offload 0.5, page 16,
   4 requests of 32 + 8 tokens, graphed: (a) P = 1 over NCCL at all 32
   layers against the engine without a mesh on the same traffic in the
   same process: equal tokens, equal kernel launches in every engine step
   and equal modeled remote bytes in every step (the trace's per-link
   counters), TPOT of both; (b) P = 2 over gloo, two ranks sharing the
   card, at 8 of 32 layers (a gloo gather passes through host memory):
   both ranks emit the tokens of the engine without a mesh at that depth,
   each rank's counted host-link bytes for the weights are half the
   single-link figure and its `mesh_traffic_report` link's within 1%,
   the plan carries the mesh and ``mesh_shape`` is [2]; TPOT and peak
   device memory of each rank;
32. the materialization lint (`repro_torch.analysis.materialization`, a
   dispatch-mode taint walk over every aten op run) on the card: llama2-7b
   at full width and 2 layers, bf16, offload 0.5, page 16, its remote
   tiers pinned, (a) one engine step that admits 4 requests (their
   prefills) and decodes, and one more eager decode step: no finding, the
   kernels launched inside it; (b) phase 5's prefetch yardstick (the remote
   tier copied into HBM, then cuBLAS) at wq's split: exactly one DAK001,
   from the device-move rule, and `splitk_gemm` on the same operands: none;
   (c) the same steps on a P = 1 mesh over NCCL (this process joins a
   one-rank group and leaves it): no finding, the fetch-once gathers run;
   ops walked, findings and seconds of each part;
33. the training stack (`launch.steps.make_train_step`, `optim.adamw`,
   `launch.train`) at StarCoder2-3B's published widths, fp32 bound 2e-4
   relative to each leaf's max: (a) at 2 layers in fp32, batch 2 x 256
   from the synthetic pipeline, one loss-and-gradient pass on the card
   against the same pass on the CPU, remat on against off on the card, and
   `adamw.update` on both devices from the same gradients (gradients are
   compared, not parameters after a step: AdamW's first step moves every
   weight by about lr whatever its gradient's size); (b) 8 steps on one
   batch (lr 1e-3, no warmup), the loss falling; (c) all 30 layers in bf16
   with remat, batch 2 x 4096 (train_4k's sequence, so attention's
   q-chunk checkpoint runs), 4 steps on pipeline batches: finite losses
   and gradient norms, peak device memory below the card's, step ms,
   tokens/s and the 6ND share of the bf16 peak, with the 2-layer peaks
   with and without remat before it; (d) `launch.train` at 2 layers in
   bf16, 6 steps, a checkpoint every 2 and a failure at 3 (under
   ``build/phase33``, deleted after): final step 6, 1 restart, each save's
   and restore's seconds and bytes, the last checkpoint restored and
   verified equal to the final state bit for bit; (e)
   `make_dp_train_step_compressed` at P = 1 over NCCL (this process joins
   a one-rank group and leaves it), 2 layers in bf16, 4 steps, losses
   within 3% of the plain step's;
34. only when asked (``--phases 1,34``), one torch.profiler trace of phase
   33 (c)'s full-size train step: device-busy share and the kernels that
   take most device time;
35. only when asked (``--phases 1,35``), the dry run on the card's
   machine: ``python -m repro_torch.launch.dryrun --mesh single`` in a
   subprocess for a decode, a prefill and a train cell, each ending ok,
   the card's allocated memory unchanged, and no JAX module imported
   (``-X importtime``); each cell's summary line and figures printed;
every served run (4, 12, 14, 16, 17, 19, 21, 26) builds its engine one layer at
a time, checks that set-up held no more device memory beyond the weights it
keeps than building one layer holds (`setup_transient_bound`), that the
pinned host bytes are its remote weights and remote KV pool and nothing
else, that every operand the plan rates is tiered unless its remote extent
rounds to nothing, and that splitk_gemm runs once per column-split weight a
layer (a shared one a group) plus lm_head in each decode step, and
splitk_gemm_grouped twice per MoE layer; the decode steps run graphed, the
launch counts of a replay added by the graph as its capture recorded them;
each phase starts with what earlier ones held freed and prints the pinned
host bytes still held; then one JSON line listing the kernels, the card's name and power limit,
and the final JSON status line.

Any failed check exits non-zero; without a CUDA card, or without the port
beside this file, it exits non-zero and prints no result.  ``--phases``
runs a subset (for quick checks while developing).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import math
import os
import shutil
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
ROUNDS = 10                 # alternating rounds of the decode GEMM comparison (phase 5)
SERVE_OFFLOAD = 0.4         # launch/serve.py's default --offload-ratio
PREFILL_LEN = 128           # prompt length of the paged served run (phase 4)
# rows of phase 2's dense cluster-design checks: one tile (17, 64), clusters
# of 2 and 3 tiles of 64, then of 128-row tiles, one cluster to three
CLUSTER_GEMM_M = (17, 64, 65, 128, 129, 704, 1100, 2000, 2052)
# phase 5's prefill rows (a chunk's tail of one M tile, then 128, 512 and 2048)
# and their alternating rounds
PREFILL_GEMM_M = {64: 3, 128: 3, 512: 3, 2048: 1}
SPLIT_PROMPT_LEN = 256      # prompt length of the batch-split served run (phase 7)
PAGED_LENS = (150, 144, 139, 158)        # the paged served run's late-step lengths (phase 5)
PAGED_LONG_LENS = (2000, 1937, 2048, 1985)   # a long cache: 122-128 pages per slot
SPLIT_KV_LEN = 288          # the batch-split served run's late-step length (phase 5)
KERNELS = ("splitk_gemm", "splitk_gemm_grouped", "paged_attention", "splitk_flashattn",
           "flash_prefill")
OPT30B_PEAK_LIMIT = 40e9    # device bytes OPT-30B may peak at (70.5 GB of bf16 weights)
ZAMBA2_PARITY_LAYERS = 12   # two groups of 6: both shared blocks run (phases 2 and 20)
# phase 5's flash_prefill shapes (B, H, Kh, T, hd, causal), all bf16; the
# kernels line reports PREFILL_REPORTED
PREFILL_TIMING = ((4, 32, 32, 128, 128, True), (4, 32, 32, 2048, 128, True),
                  (4, 32, 8, 2048, 128, True), (4, 16, 16, 2048, 64, True),
                  (4, 32, 32, 2048, 128, False))
PREFILL_REPORTED = (4, 32, 32, 2048, 128, True)
PREFILL_CHECK_T = (1, 63, 64, 65, 127, 128, 129, 1000, 2048)   # phase 2's wgmma-design rows

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)


def note_err(stats: dict | None, rel: float, ab: float) -> None:
    """Fold one check's errors into a kernel's running maxima."""
    if stats is not None:
        stats["max_abs_err"] = max(stats["max_abs_err"], ab)
        stats["max_rel_err"] = max(stats["max_rel_err"], rel)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    a, b = a.float(), b.float()
    diff = (a - b).abs().max().item() if a.numel() else 0.0
    scale = b.abs().max().item() if b.numel() else 0.0
    return diff / (scale + 1e-9), diff


def row_rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """Like `rel_err`, but each row (the last axis) is measured against its
    own largest reference value, so rows of small outputs count as much as
    rows of large ones."""
    a, b = a.float(), b.float()
    diff = (a - b).abs().amax(dim=-1)
    rel = diff / (b.abs().amax(dim=-1) + 1e-9)
    return rel.max().item(), diff.max().item()


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
    mem = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key, _, value = line.partition(":")
        if key in ("MemTotal", "MemAvailable"):
            mem[key] = int(value.split()[0]) * 1024
    print(f"host RAM: MemTotal {mem.get('MemTotal', 0) / 2**30:.2f} GiB, MemAvailable "
          f"{mem.get('MemAvailable', 0) / 2**30:.2f} GiB (/proc/meminfo); phases 17 and 26 "
          f"pin about 34.9 GB each, phase 12 about 30 GB")
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


# the SSM and hybrid families' new operand shapes at offload 0.5 (align 128)
RECURRENT_GEMM_SHAPES = {
    "mamba2-bc_proj": (1024, 128, 128),        # the narrowest split yet
    "mamba2-ssm_out": (2048, 512, 512),
    "zamba2-z/x_proj": (2560, 2560, 2560),
    "zamba2-shared-wi": (2560, 10240, 10240),
    "zamba2-shared-wdown": (10240, 1280, 1280),
}


# the encoder's and the VLM's operand splits at offload 0.5 (align 128):
# HuBERT-XLarge's wq and wo, wkv, wi, wdown and its 504-wide lm_head;
# LLaVA-NeXT-34B's (56 query heads padded to 64) wq, wkv, wo, wi, wdown, lm_head
ENCODER_VLM_GEMM_SHAPES = {
    "hubert-wq/wo": (1280, 640, 640),
    "hubert-wkv": (1280, 1280, 1280),
    "hubert-wi": (1280, 2560, 2560),
    "hubert-wdown": (5120, 640, 640),
    "hubert-lm_head": (1280, 248, 256),
    "llava-wq": (7168, 4096, 4096),
    "llava-wkv": (7168, 1024, 1024),
    "llava-wo": (8192, 3584, 3584),
    "llava-wi": (7168, 20480, 20480),
    "llava-wdown": (20480, 3584, 3584),
    "llava-lm_head": (7168, 32000, 32000),
}
# their M: decode batch, a 128-token prompt, LLaVA's 576 patches + 128
# tokens, HuBERT's 4 clips of 500 frames
ENCODER_VLM_M = (DECODE_BATCH, PREFILL_LEN, 704, 2000)


def pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` copied into exact-size pinned, device-mapped host memory."""
    from repro_torch.kernels import _build

    host = _build.pinned_empty(t.shape, t.dtype)
    host.copy_(t)
    return host


def sm_count() -> int:
    """SMs of the card, which the wrappers aim their K splits at."""
    return torch.cuda.get_device_properties(0).multi_processor_count


def make_tier_pair(k, n_loc, n_rem, dtype, gen):
    wl = (torch.randn((k, n_loc), generator=gen, device="cuda") * 0.02).to(dtype)
    wr_dev = (torch.randn((k, n_rem), generator=gen, device="cuda") * 0.02).to(dtype)
    return wl, pinned_copy(wr_dev), wr_dev


def gemm_case(label, m, k, n_loc, n_rem, dtype, windows, gen, stats=None, tiers=None):
    """`splitk_gemm` against its plain version on the card (the remote tier in
    HBM for the check only) at each window, in the design the wrapper picks
    (`gemm_tiling`): a second launch equal to the first bit for bit, the
    remote tier as a device buffer (a serving mesh's placement) giving the
    same bits, and the device counter of host bytes equal to the tiling
    model (the remote tier once per cluster of M tiles)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_gemm import gemm_tiling, splitk_gemm

    wl, wr, wr_dev = tiers if tiers is not None else make_tier_pair(k, n_loc, n_rem, dtype, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    want = ref.splitk_gemm_ref(x, wl, wr_dev)
    t = gemm_tiling(m, k, n_loc, n_rem, dtype, sm_count=sm_count())
    model = wr.numel() * x.element_size() * t.reads
    hb = splitk_gemm.host_bytes
    for w in windows:
        hb.reset()
        got = splitk_gemm(x, wl, wr, window=w)
        torch.cuda.synchronize()
        counted = int(hb)
        again = splitk_gemm(x, wl, wr, window=w)
        on_card = splitk_gemm(x, wl, wr_dev, window=w) if n_rem else again
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        same = torch.equal(got, again) and torch.equal(got, on_card)
        check(rel < TOL[dtype] and torch.isfinite(got.float()).all().item() and same
              and counted == model,
              f"splitk_gemm {label} M={m} K={k} N={n_loc}|{n_rem} {str(dtype)[6:]} "
              f"window={w}: {t.design} design (MB {t.mb}, clusters of {t.cluster}, {t.splits} "
              f"split(s)): max rel err {rel:.2e} (abs {ab:.2e}, bound {TOL[dtype]:.0e}), again "
              f"and remote tier on the card bitwise equal: {same}, host bytes counted "
              f"{counted} = tiling model {model} ({t.reads} read(s))")
        note_err(stats, rel, ab)


def paged_inputs(b, h, kh, hd, ps, mp, p_loc, p_rem, lens, dtype, gen, alias_v=False,
                 tiers="mixed"):
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
            pools[key] = pinned_copy(t)
        else:
            pools[key] = t
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(dtype)
    rng = np.random.default_rng(b * 1000 + mp)
    tier = {"mixed": rng.integers(0, 2, size=(b, mp)), "local": np.zeros((b, mp), np.int64),
            "remote": np.ones((b, mp), np.int64)}[tiers]
    table = np.where(tier > 0, rng.integers(0, p_rem, size=(b, mp)),
                     rng.integers(0, p_loc, size=(b, mp)))
    as_dev = lambda a: torch.tensor(np.asarray(a, np.int32), device="cuda")  # noqa: E731
    return q, pools, pools_dev, as_dev(table), as_dev(tier), as_dev(lens)


def paged_model_bytes(design, tier, lens, ps, h, kh, hd, elem) -> int:
    """`paged_reads` for a launch of `design` (a `PagedDesign`)."""
    from repro_torch.kernels.splitk_flashattn import paged_reads

    return paged_reads(np.asarray(tier), np.asarray(lens), ps, h, kh, hd, elem,
                       alias=design.alias, heads_per_cta=design.heads_per_cta,
                       cluster=design.cluster)


def attn_case(label, b, h, kh, hd, ps, mp, p_loc, p_rem, lens, dtype, windows, gen,
              scale=None, alias_v=False, stats=None, tiers="mixed"):
    """Paged attention through the wrapper against the plain version at
    each window: within the bound, zeros for lens 0, a second launch
    bitwise equal, and the remote bytes counted on the card
    (`paged_splitk_flashattn.host_bytes`) equal to `paged_reads` for the
    design the launch took."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.splitk_flashattn import launch_design, paged_splitk_flashattn

    q, pools, pools_dev, table, tier, lens_t = paged_inputs(
        b, h, kh, hd, ps, mp, p_loc, p_rem, lens, dtype, gen, alias_v, tiers)
    want = ref.paged_flashattn_ref(q, pools_dev["k_local"], pools_dev["v_local"],
                                   pools_dev["k_remote"], pools_dev["v_remote"],
                                   table, tier, lens_t, scale=scale)
    hb = paged_splitk_flashattn.host_bytes
    for w in windows:
        design = launch_design(q, pools["k_local"], pools["v_local"], pools["k_remote"],
                               pools["v_remote"], table, w)
        model = paged_model_bytes(design, tier.cpu(), lens, ps, h, kh, hd, q.element_size())
        hb.reset()
        got = ops.paged_decode_attention(q, pools, table, tier, lens_t, window=w, scale=scale)
        torch.cuda.synchronize()
        counted = int(hb)
        same = torch.equal(ops.paged_decode_attention(q, pools, table, tier, lens_t, window=w,
                                                      scale=scale), got)
        rel, ab = rel_err(got, want)
        zeros_ok = all(bool((got[i] == 0).all()) for i, n in enumerate(lens) if n == 0)
        check(rel < TOL[dtype] and zeros_ok and same and counted == model,
              f"paged_attention {label} B={b} H={h} Kh={kh} hd={hd} page={ps} MP={mp} "
              f"lens={list(lens)} {tiers} {str(dtype)[6:]} window={w}"
              f"{' scale=' + str(scale) if scale else ''}{' V=K' if alias_v else ''}, "
              f"{design.name} design ({design.stages} stages): max rel err {rel:.2e} (abs "
              f"{ab:.2e}, bound {TOL[dtype]:.0e}), zero rows for lens 0: {zeros_ok}, again "
              f"bitwise equal: {same}, host bytes counted {counted} = model {model}")
        note_err(stats, rel, ab)


def scatter_case(gen):
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
            pool = pinned_copy(dev_pool)
        scatter_rows(pool, rows, wr_tier, wr_idx, wr_off, tier_sel, p, remote=remote)
        torch.cuda.synchronize()
        sel = wr_tier == tier_sel
        scatter_rows_ref(dev_pool, rows[sel], wr_idx[sel], wr_off[sel])
        ok = ok and torch.equal(pool.cuda(), dev_pool)
    check(ok, "scatter_rows (decode K/V row writer helper): local and remote pools "
              "bit-identical to the plain index_put")


def per_expert_ffn(buf, valid, wi, wdown, e_loc):
    """The remote block as the port ran it before the grouped entry: one
    host read of the counts, then two `splitk_gemm` launches per remote
    expert with a valid slot (remote-only operands), the others left zero.
    Returns the remote block [G, E_rem, C, d]."""
    from repro_torch.kernels.splitk_gemm import splitk_gemm

    g, _, c, d = buf.shape
    out = torch.zeros_like(buf[:, e_loc:])
    empty = lambda w: buf.new_empty((w.shape[0], 0))  # noqa: E731
    for j, n in enumerate(valid[:, e_loc:].sum(dim=(0, 2)).tolist()):
        if n:
            x = buf[:, e_loc + j].reshape(g * c, d).contiguous()
            gate, up = torch.chunk(splitk_gemm(x, empty(wi[j]), wi[j]), 2, dim=-1)
            h = (torch.nn.functional.silu(gate) * up).contiguous()
            out[:, j] = splitk_gemm(h, empty(wdown[j]), wdown[j]).reshape(g, c, d)
    return out


def expert_case(label, d, ff, e_loc, e_rem, dtype, gen, stats=None):
    """The tiered expert FFN (`layers.tiered_expert_ffn`: local experts
    batched from HBM, the remote block through one `splitk_gemm_grouped`
    launch per matrix over the pinned stacks, experts without a valid slot
    skipped on the device) against `_expert_ffn` over both tiers on the
    card (the remote block in HBM for the check only) and against the
    per-expert `splitk_gemm` loop it replaced, at 1 and 12 rows per expert,
    each expert holding a random prefix of its slots (none for some):
    exactly 2 grouped launches, no `splitk_gemm` launch, and the device
    counter of remote experts run equal to the experts holding a slot."""
    from repro_torch.core.tiering import TieredTensor
    from repro_torch.kernels.splitk_gemm import splitk_gemm, splitk_gemm_grouped
    from repro_torch.models import layers as L
    from repro_torch.serving import tiered_decode as TD

    e = e_loc + e_rem
    full, split = {}, {}
    for name, shape in (("wi", (e, d, 2 * ff)), ("wdown", (e, ff, d))):
        full[name] = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dtype)
        split[name] = TieredTensor(local=full[name][:e_loc].contiguous(),
                                   remote=pinned_copy(full[name][e_loc:]), axis=-3)
    for rows in (1, 12):
        buf = torch.randn((1, e, rows, d), generator=gen, device="cuda").to(dtype)
        n_valid = torch.randint(0, rows + 1, (1, e, 1), generator=gen, device="cuda")
        valid = torch.arange(rows, device="cuda")[None, None, :] < n_valid
        buf = buf.masked_fill(~valid[..., None], 0)
        active = int(valid[0, e_loc:].any(dim=-1).sum())
        before = (splitk_gemm.launches, splitk_gemm_grouped.launches,
                  int(L.tiered_expert_ffn.remote_experts))
        got = L.tiered_expert_ffn(buf, valid, split["wi"], split["wdown"],
                                  mm=TD.kernel_mm(1))
        torch.cuda.synchronize()
        gemm, grouped, ran = (splitk_gemm.launches - before[0],
                              splitk_gemm_grouped.launches - before[1],
                              int(L.tiered_expert_ffn.remote_experts) - before[2])
        want = L._expert_ffn(buf, full["wi"], full["wdown"])
        loop = per_expert_ffn(buf, valid, split["wi"].remote, split["wdown"].remote, e_loc)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        rel_loop, ab_loop = rel_err(got[:, e_loc:], loop)
        check(rel < TOL[dtype] and rel_loop < TOL[dtype]
              and torch.isfinite(got.float()).all().item()
              and grouped == 2 and gemm == 0 and ran == active,
              f"expert FFN {label} d={d} ff={ff} experts {e_loc}|{e_rem} rows={rows} "
              f"{str(dtype)[6:]}: max rel err {rel:.2e} (abs {ab:.2e}) against the plain "
              f"version, {rel_loop:.2e} (abs {ab_loop:.2e}) against the per-expert splitk_gemm "
              f"loop (bound {TOL[dtype]:.0e}); {active} remote experts hold a valid slot, "
              f"{ran} ran; {grouped} splitk_gemm_grouped and {gemm} splitk_gemm launches")
        note_err(stats, rel, ab)
    del full, split


def grouped_case(label, e, m, k, n, dtype, windows, gen, stats=None, active=None):
    """`splitk_gemm_grouped` alone against its plain version on the card
    (the stack in HBM for the check only): experts `active` (default every
    other one) hold a count, the rest must come out zero; a second launch
    equal to the first bit for bit; and the device counter of host bytes
    equal to what the tiling reads: each active expert's K x N weights once
    per cluster of M tiles (`grouped_tiling(M).reads`)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_gemm import grouped_tiling, splitk_gemm_grouped

    w_dev = (torch.randn((e, k, n), generator=gen, device="cuda") * 0.02).to(dtype)
    w = pinned_copy(w_dev)
    x = torch.randn((e, m, k), generator=gen, device="cuda").to(dtype)
    counts = torch.zeros(e, dtype=torch.int32, device="cuda")
    counts[list(range(0, e, 2)) if active is None else list(active)] = 1
    want = ref.splitk_gemm_grouped_ref(x, w_dev, counts)
    tiling = grouped_tiling(m, dtype)
    model = int((counts > 0).sum()) * k * n * x.element_size() * tiling.reads
    hb = splitk_gemm_grouped.host_bytes
    for win in windows:
        hb.reset()
        got = splitk_gemm_grouped(x, w, counts, window=win)
        torch.cuda.synchronize()
        counted = int(hb)
        again = splitk_gemm_grouped(x, w, counts, window=win)
        torch.cuda.synchronize()
        rel, ab = rel_err(got, want)
        zeros = bool((got[counts == 0] == 0).all())
        check(rel < TOL[dtype] and zeros and torch.isfinite(got.float()).all().item()
              and torch.equal(got, again) and counted == model,
              f"splitk_gemm_grouped {label} E={e} M={m} K={k} N={n} {str(dtype)[6:]} "
              f"window={win}: {tiling.design} design (MB {tiling.mb}, clusters of "
              f"{tiling.cluster}, M axis {tiling.grid_z}): max rel err {rel:.2e} (abs {ab:.2e}, "
              f"bound {TOL[dtype]:.0e}), {int((counts > 0).sum())} active, skipped experts "
              f"zero: {zeros}, second launch bitwise equal: {torch.equal(got, again)}, host "
              f"bytes counted {counted} = tiling model {model} ({tiling.reads} read(s))")
        note_err(stats, rel, ab)


def grouped_smem_case() -> None:
    """`splitk_gemm.grouped_launch`'s ring stages and shared memory against
    the kernel's own count (``dak_splitk_gemm_grouped_smem``), both designs,
    at the grouped shapes the phases launch."""
    from repro_torch.kernels.splitk_gemm import grouped_launch, grouped_smem_query

    bad = []
    cases = [(64, m, k, n, dt, w) for m in (1, 4, 16, 17, 64, 65, 192, 384, 513, 1100)
             for k, n in ((2048, 1536), (768, 2048), (512, 64)) for w in (1, 2, 8)
             for dt in (torch.bfloat16, torch.float32)]
    for e, m, k, n, dt, w in cases:
        for design in (None, "split-K"):
            launch = grouped_launch(e, m, k, n, dt, window=w, sm_count=132, design=design)
            own = grouped_smem_query(m, k, window=w, k_split=launch.k_split,
                                     design=launch.tiling.design, dtype=dt)
            if own != (launch.smem_bytes, launch.stages):
                bad.append((m, k, n, str(dt)[6:], w, launch.tiling.design, own,
                            (launch.smem_bytes, launch.stages)))
    check(not bad, f"grouped_launch's shared memory and ring stages equal the kernel's own "
                   f"count in {len(cases) * 2 - len(bad)} of {len(cases) * 2} launch "
                   f"configurations {bad[:3]}")


def tree_leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested params tree, in its order."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from tree_leaves(leaf, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", leaf


def layer_source_case(arch: str, n_layers: int) -> None:
    """The layer-by-layer build (`TieringPlan.partition_source` over
    `models.layer_source`) of `arch` at full width cut to `n_layers`, in bf16
    at offload 0.5, remote stacks in pinned host memory, against `partition`
    of the whole tree with its remote tiers placed in pinned memory: bit for
    bit, a hybrid's tiered ``shared`` block stack included."""
    import repro_torch.configs as C
    from repro_torch.core import engine as offload_engine
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.tiering import TieredTensor
    from repro_torch.kernels import _build
    from repro_torch.models import model as M

    cfg = dataclasses.replace(C.get(arch), n_layers=n_layers)
    plan = offload_engine.plan(cfg, WorkloadSpec(batch=4, seq_len=144, phase="decode"),
                               H100_SXM, global_ratio=0.5, kv_page_size=16)
    bf = torch.bfloat16
    whole = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(3), dtype=bf,
                          device="cuda")
    want = plan.partition(whole, align=128, place_remote=True)
    del whole
    before = _build.pinned_bytes()
    got = plan.partition_source(
        M.layer_source(cfg, torch.Generator(device="cuda").manual_seed(3), dtype=bf,
                       device="cuda"),
        align=128)
    pinned = _build.pinned_bytes() - before
    flat_want, flat_got = list(tree_leaves(want)), list(tree_leaves(got))
    same, tiered = len(flat_got) == len(flat_want), []
    for (key, w), (key2, g) in zip(flat_want, flat_got):
        same = same and key == key2
        if isinstance(w, TieredTensor):
            tiered.append(key)
            same = same and isinstance(g, TieredTensor) and torch.equal(
                g.local, w.local) and torch.equal(g.remote, w.remote)
        else:
            same = same and torch.equal(g, w)
    shared = sum(k.startswith("shared/") for k in tiered)
    check(same, f"layer-source build of a {n_layers}-layer {cfg.name} (bf16, offload 0.5) "
                f"equals partition of the whole tree bit for bit ({len(tiered)} tiered leaves, "
                f"{shared} of them in the shared block stack)")
    leaves = [g for _, g in flat_got if isinstance(g, TieredTensor)]
    check(all(t.remote.is_pinned() and t.local.is_cuda for t in leaves)
          and pinned == sum(t.remote.nbytes for t in leaves),
          f"its {len(leaves)} remote tiers are pinned host memory, one exact-size allocation "
          f"each ({pinned} bytes)")
    del want, got


def batch_split_inputs(b_loc, b_rem, h, kh, hd, s, dtype, gen):
    """q [B, H, hd] and a batch-split cache: the device copy of every tier
    (for the plain version) and the kernel's operands, remote tier pinned."""
    q = torch.randn((b_loc + b_rem, h, hd), generator=gen, device="cuda").to(dtype)
    dev = {f"{kv}_{tier}": torch.randn((n, s, kh, hd), generator=gen, device="cuda").to(dtype)
           for kv in ("k", "v") for tier, n in (("local", b_loc), ("remote", b_rem))}
    cache = {k: (pinned_copy(t) if k.endswith("remote") else t) for k, t in dev.items()}
    return q, cache, dev


def splitk_attn_case(label, b_loc, b_rem, h, kh, hd, s, kv_lens, dtype, windows, gen,
                     stats=None):
    from repro_torch.kernels import ops, ref

    q, cache, dev = batch_split_inputs(b_loc, b_rem, h, kh, hd, s, dtype, gen)
    for kv_len in kv_lens:
        want = ref.splitk_flashattn_ref(q, dev["k_local"], dev["v_local"], dev["k_remote"],
                                        dev["v_remote"], kv_len)
        for w in windows:
            got = ops.tiered_decode_attention(q, cache, kv_len=kv_len, window=w)
            torch.cuda.synchronize()
            rel, ab = rel_err(got, want)
            check(rel < TOL[dtype] and torch.isfinite(got.float()).all().item(),
                  f"splitk_flashattn {label} B={b_loc}|{b_rem} H={h} Kh={kh} hd={hd} S={s} "
                  f"kv_len={kv_len} {str(dtype)[6:]} window={w}: max rel err "
                  f"{rel:.2e} (abs {ab:.2e}, bound {TOL[dtype]:.0e})")
            note_err(stats, rel, ab)


def prefill_case(label, b, h, kh, t, hd, dtype, gen, stats=None, tk=None, offset=0):
    """flash_prefill causal and full against plain, per query row, with a
    second launch bitwise equal; the design the wrapper took is printed.
    ``offset`` > 0 views every operand one element into its storage (off
    16-byte alignment)."""
    from repro_torch.kernels import flash_prefill, ref

    FP = importlib.import_module("repro_torch.kernels.flash_prefill")
    tk = t if tk is None else tk

    def operand(heads, rows):
        n = b * heads * rows * hd
        flat = torch.randn(n + offset, generator=gen, device="cuda").to(dtype)
        return flat[offset:].view(b, heads, rows, hd)

    q, k, v = operand(h, t), operand(kh, tk), operand(kh, tk)
    which = FP.design(hd, dtype, FP._aligned(q, k, v))
    for causal in (True, False):
        want = ref.flash_prefill_ref(q, k, v, causal)
        got = flash_prefill(q, k, v, causal=causal)
        again = flash_prefill(q, k, v, causal=causal)
        torch.cuda.synchronize()
        # per query row: causal row 0 is v[0] (values near 4) while late rows
        # average thousands of keys (near 0.05), so one global scale would
        # hide wrong late rows
        rel, ab = row_rel_err(got, want)
        same = torch.equal(got, again)
        check(rel < TOL[dtype] and torch.isfinite(got.float()).all().item() and same,
              f"flash_prefill {label} ({which} design) B={b} H={h} Kh={kh} Tq={t} Tk={tk} "
              f"hd={hd} {'causal' if causal else 'full'} {str(dtype)[6:]}: max rel err per "
              f"query row {rel:.2e} (abs {ab:.2e}, bound {TOL[dtype]:.0e}), again "
              f"{'bitwise equal' if same else 'DIFFERENT'}")
        note_err(stats, rel, ab)
    del q, k, v, want


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    stats = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0} for n in KERNELS}
    bf = torch.bfloat16
    # first: a weight box multicast from mapped host memory to a cluster of 3
    grouped_case("multicast", 2, 130, 128, 64, bf, (1,), gen)
    # then the dense cluster design (bf16, M > 16) at its smallest: one M
    # tile and no multicast (17, 64), clusters of 2, 3, 6 (704), 6 x 2
    # (1100: 9 tiles of 128 in two clusters of 5), 8 x 2 (2000) and 6 x 3
    # (2052); ragged tiers of 136 | 200 columns and K 320 (a 64-row box
    # past K); either tier empty; K splits with tickets (a narrow tier)
    for m in CLUSTER_GEMM_M:
        gemm_case("cluster", m, 320, 136, 200, bf, (1, 2), gen, stats["splitk_gemm"])
    for m in (17, 129, 2000):
        gemm_case("cluster empty-local", m, 512, 0, 256, bf, (1, 2), gen)
        gemm_case("cluster empty-remote", m, 512, 256, 0, bf, (1, 2), gen)
        gemm_case("cluster split-K", m, 4096, 64, 128, bf, (1, 2), gen)
    for name, (k, n_loc, n_rem) in GEMM_SHAPES.items():
        tiers = make_tier_pair(k, n_loc, n_rem, bf, gen)
        # M: decode batch, paged prefill (phase 4), batch-split prefill (phase 7)
        for m in (DECODE_BATCH, PREFILL_LEN, DECODE_BATCH * SPLIT_PROMPT_LEN):
            gemm_case(name, m, k, n_loc, n_rem, bf, (1, 2, 4), gen,
                      stats["splitk_gemm"], tiers)
        del tiers
    # OPT-30B's lm_head at offload 0.5: N_loc 25184 is no multiple of the
    # 64-column decode tile
    tiers = make_tier_pair(7168, 25184, 25088, bf, gen)
    for m in (DECODE_BATCH, PREFILL_LEN):
        gemm_case("opt30b-lm_head", m, 7168, 25184, 25088, bf, (1, 2), gen,
                  stats["splitk_gemm"], tiers)
    del tiers
    # the SSM and hybrid projections (phases 18-21), decode and prefill M
    for name, (k, n_loc, n_rem) in RECURRENT_GEMM_SHAPES.items():
        for dtype in (bf, torch.float32):
            tiers = make_tier_pair(k, n_loc, n_rem, dtype, gen)
            for m in (DECODE_BATCH, PREFILL_LEN):
                gemm_case(name, m, k, n_loc, n_rem, dtype, (1, 2), gen,
                          stats["splitk_gemm"] if dtype == bf else None, tiers)
            del tiers
    # the encoder's and the VLM's projections (phases 24-26)
    for name, (k, n_loc, n_rem) in ENCODER_VLM_GEMM_SHAPES.items():
        for dtype in (bf, torch.float32):
            tiers = make_tier_pair(k, n_loc, n_rem, dtype, gen)
            for m in ENCODER_VLM_M:
                gemm_case(name, m, k, n_loc, n_rem, dtype, (1, 2), gen,
                          stats["splitk_gemm"] if dtype == bf else None, tiers)
            del tiers
            gc.collect()
            torch.cuda.empty_cache()
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
    attn_case("long cache", b=DECODE_BATCH, mp=128, p_loc=300, p_rem=300, lens=PAGED_LONG_LENS,
              dtype=bf, windows=(1, 2, 4), gen=gen, stats=stats["paged_attention"], **full)
    # DeepSeek-V2's MLA decode: 128 heads over one latent kv head of 576, V
    # read from the K pool, scale (nd + rd)**-0.5; bf16 takes the cluster
    # design (one cluster of 8 blocks of 16 heads a slot), fp32 the
    # head-group design (element loads)
    mla = dict(kh=1, hd=576, ps=16, scale=192 ** -0.5, gen=gen)
    for dtype in (bf, torch.float32):
        attn_case("mla", b=DECODE_BATCH, h=128, mp=10, p_loc=20, p_rem=20,
                  lens=(150, 0, 37, 160), dtype=dtype, windows=(1, 2, 4), alias_v=True,
                  stats=stats["paged_attention"] if dtype == bf else None, **mla)
    # the cluster design's other cases: one block (G 8, V its own pool; G
    # 16), two clusters of 5 a slot (G 144), every page local or remote,
    # lengths 0, 1, 16 and 17, a long cache of up to 128 pages a slot
    attn_case("mla G=8", b=2, h=8, mp=12, p_loc=20, p_rem=20, lens=(180, 33), dtype=bf,
              windows=(1, 2, 4), **mla)
    attn_case("mla G=16", b=3, h=16, mp=10, p_loc=20, p_rem=20, lens=(150, 0, 37), dtype=bf,
              windows=(1, 2, 4), alias_v=True, **mla)
    attn_case("mla G=144", b=2, h=144, mp=10, p_loc=20, p_rem=20, lens=(150, 17), dtype=bf,
              windows=(1, 2, 4), alias_v=True, **mla)
    for tiers, pools, lens in (("local", (40, 4), (160, 1, 16)),
                               ("remote", (4, 40), (17, 0, 150))):
        attn_case(f"mla all-{tiers}", b=3, h=128, mp=10, p_loc=pools[0], p_rem=pools[1],
                  lens=lens, dtype=bf, windows=(1, 2, 4), alias_v=True, tiers=tiers, **mla)
    attn_case("mla edge lens", b=DECODE_BATCH, h=128, mp=10, p_loc=20, p_rem=20,
              lens=(0, 1, 16, 17), dtype=bf, windows=(1, 2, 4), alias_v=True, **mla)
    attn_case("mla long cache", b=DECODE_BATCH, h=128, mp=128, p_loc=300, p_rem=300,
              lens=PAGED_LONG_LENS, dtype=bf, windows=(1, 2, 4), alias_v=True,
              stats=stats["paged_attention"], **mla)
    # the dense variants' decode shapes: OPT-30B (56 heads padded to 112 over
    # 56 kv heads), Qwen2.5-14B (48 over 8), ChatGLM3-6B and StarCoder2-3B
    # (32 over 2, a group of 16 split across CTAs); LLaVA-NeXT-34B (56 heads
    # padded to 64 over 8 kv heads)
    for label, (h, kh) in (("opt30b", (112, 56)), ("qwen2p5-14b", (48, 8)),
                           ("chatglm3", (32, 2)), ("llava", (64, 8))):
        for dtype in (bf, torch.float32):
            attn_case(label, b=DECODE_BATCH, h=h, kh=kh, hd=128, ps=16, mp=10, p_loc=20,
                      p_rem=20, lens=(150, 0, 37, 160), dtype=dtype, windows=(1, 2), gen=gen,
                      stats=stats["paged_attention"] if dtype == bf else None)
    # Zamba2's shared attention: 32 heads over 32 kv heads of 80 (a TMA box
    # row of 160 B in bf16, 320 B in fp32)
    for dtype in (bf, torch.float32):
        attn_case("zamba2-hd80", b=DECODE_BATCH, h=32, kh=32, hd=80, ps=16, mp=10, p_loc=20,
                  p_rem=20, lens=(150, 0, 37, 160), dtype=dtype, windows=(1, 2), gen=gen,
                  stats=stats["paged_attention"] if dtype == bf else None)
    scatter_case(gen)
    layer_source_case("opt_30b", 2)
    layer_source_case("zamba2_2p7b", ZAMBA2_PARITY_LAYERS)
    # the expert FFN at Qwen3-30B-A3B's and DeepSeek-V2's widths, offload 0.5
    for dtype in (bf, torch.float32):
        for label, (d, ff, e_half) in (("qwen3-moe", (2048, 768, 64)),
                                       ("deepseek-v2", (5120, 1536, 80))):
            expert_case(label, d, ff, e_half, e_half, dtype, gen,
                        stats["splitk_gemm_grouped"] if dtype == bf else None)
    # the grouped entry alone: K splits with tickets (few tiles), M tiles
    # beyond 64 rows (dropless prefill), ragged N, one active expert, none
    for dtype in (bf, torch.float32):
        grouped_case("split-K", 3, 4, 512, 64, dtype, (1, 2), gen)
        grouped_case("M tiles", 4, 150, 256, 192, dtype, (1, 2), gen)
        grouped_case("ragged N", 5, 24, 96, 72, dtype, (2,), gen)
        grouped_case("one active", 64, 1, 2048, 1536, dtype, (1,), gen, active=(63,))
        grouped_case("none active", 8, 3, 256, 128, dtype, (1,), gen, active=())
    # the cluster design (bf16, M > 16) at prefill rows: clusters of 1, 1, 2,
    # 3, 6, and two clusters of 5 tiles of 128; K splits with tickets, ragged
    # N, one expert active, none
    for m in (17, 64, 65, 192, 384, 1100):
        grouped_case(f"cluster M={m}", 4, m, 768, 256, bf, (1, 2), gen, stats["splitk_gemm_grouped"])
    grouped_case("cluster split-K", 2, 200, 1024, 64, bf, (1, 2), gen)
    grouped_case("cluster ragged N", 5, 300, 96, 200, bf, (1, 2), gen)
    grouped_case("cluster one active", 64, 192, 2048, 1536, bf, (1,), gen, active=(17,))
    grouped_case("cluster none active", 8, 100, 256, 128, bf, (1,), gen, active=())
    grouped_smem_case()
    f32 = torch.float32
    for dtype in (bf, f32):
        splitk_attn_case("full-width", 2, 2, 32, 32, 128, 512, (1, 255, 257, 512), dtype,
                         (1, 2, 4), gen, stats=stats["splitk_flashattn"] if dtype == bf else None)
    splitk_attn_case("empty-local", 0, 3, 32, 32, 128, 512, (288,), bf, (1, 2), gen)
    splitk_attn_case("empty-remote", 3, 0, 32, 32, 128, 512, (288,), bf, (1, 2), gen)
    # S = 300 is no multiple of any chunk the kernel takes (64 or 32 rows)
    splitk_attn_case("ragged", 2, 2, 32, 32, 128, 300, (300, 37), bf, (1, 2), gen)
    splitk_attn_case("gqa", 2, 3, 8, 2, 64, 200, (1, 150, 200), f32, (1, 2, 4), gen)
    splitk_attn_case("unaligned", 1, 2, 8, 2, 30, 40, (17, 40), bf, (1, 3), gen)
    splitk_attn_case("long cache", 2, 2, 32, 32, 128, 2048, (2048, 1999), bf, (1, 2, 4), gen,
                     stats=stats["splitk_flashattn"])
    for t in (128, 256, 2048):
        for dtype in (bf, f32):
            prefill_case("full-width", DECODE_BATCH, 32, 32, t, 128, dtype, gen,
                         stats=stats["flash_prefill"] if dtype == bf else None)
    prefill_case("gqa", 2, 8, 2, 512, 64, f32, gen)
    prefill_case("ragged", 2, 4, 2, 100, 64, bf, gen)
    prefill_case("unaligned", 1, 4, 1, 77, 30, f32, gen)
    # the wgmma design at its head dims: ragged and whole tiles, GQA 8 over 2
    # and H = Kh, Tq != Tk; then what keeps the mma.sync design
    for hd in (64, 128):
        for t in PREFILL_CHECK_T:
            prefill_case("gqa", 2, 8, 2, t, hd, bf, gen)
        for t in (65, 1000):
            prefill_case("mha", 2, 4, 4, t, hd, bf, gen)
        prefill_case("tq > tk", 2, 4, 4, 300, hd, bf, gen, tk=200)
        prefill_case("tq < tk", 1, 4, 1, 100, hd, bf, gen, tk=333)
    for hd in (32, 96, 256):
        prefill_case("other hd", 2, 8, 2, 129, hd, bf, gen)
    prefill_case("misaligned", 2, 8, 2, 129, 128, bf, gen, offset=1)
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


def phase_parity(arch: str = "llama2_7b", n_layers: int = 2, dropless: bool = False,
                 frontend: bool = False) -> None:
    """The engine on the card (fp32, full width, `n_layers` layers, offload
    0.5, page 4, 3 slots, prompts that force spills) must emit exactly the
    tokens of the plain per-request reference on the same weights unsplit in
    HBM.  MoE runs dropless: a finite capacity couples the batched requests'
    drops, which per-request decoding cannot see.  A pure SSM has no pages
    to check; its idle slots step with the batch, as in the reference.  With
    `frontend` the engine runs the SLO scheduler on a modeled clock with
    chunks of 4 prompt tokens (`models.prefill_chunk` into a private cache)
    and mixed priorities, and must have split prompts."""
    import repro_torch.configs as C
    from repro_torch.frontend.metrics import ModeledClock
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(C.get(arch), n_layers=n_layers)
    if dropless:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.n_experts))
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = M.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    kw = dict(scheduler="slo", prefill_chunk=4, clock=ModeledClock()) if frontend else {}
    eng = ServingEngine(cfg, params, max_batch=3, max_len=32,
                        global_offload_ratio=0.5, page_size=4, device="cuda", **kw)
    leaves = list(remote_leaves(eng.params))
    check(bool(leaves) and all(leaf.remote.is_pinned() for leaf in leaves),
          f"{len(leaves)} remote weight tiers, all pinned host memory")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab, n).astype(np.int32) for n in (10, 16, 7, 14, 9)]
    priorities = (0, 2, 1, 0, 2) if frontend else (0,) * len(prompts)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8, priority=priorities[i])
            for i, p in enumerate(prompts)]
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
    if eng.pcache is not None:                 # a pure SSM has no KV pages
        check(stats.local_pages_hwm >= 1 and stats.remote_pages_hwm >= 1,
              f"parity run pages in both tiers: local hwm {stats.local_pages_hwm}, "
              f"remote hwm {stats.remote_pages_hwm}, spills {stats.spills}")
    if frontend:
        check(stats.prefill_chunks > 0,
              f"SLO scheduler split prompts: {stats.prefill_chunks} continuation chunks, "
              f"{stats.preemptions} preemptions")


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


def remote_kv_pages(eng) -> int:
    """Remote pages the next decode step attends: each active slot's pages
    up to its length + 1, in the remote tier (per layer); 0 without pages."""
    pc, n = eng.pcache, 0
    if pc is None:
        return 0
    for slot, req in enumerate(eng.active):
        if req is not None:
            used = min(-(-(int(eng.lens[slot]) + 1) // pc.page_size), int(pc.n_pages[slot]))
            n += int((pc.tier[slot, :used] > 0).sum())
    return n


def phase_serve(arch: str = "llama2_7b", n_layers: int | None = None, n_req: int = 8,
                new_tokens: int = 32, peak_limit: float | None = None) -> dict:
    """The served run: `arch` at its published widths (depth cut to
    `n_layers` where given), bf16, offload 0.5, page 16, 4 slots, `n_req`
    requests of 128 prompt + `new_tokens` new tokens, stepped one engine step
    at a time so the decode steps that admitted nothing are counted on their
    own.  The engine is built layer by layer (`models.layer_source`), as
    `launch/serve.py` builds it, so the unsplit model is never whole on the
    card; `peak_limit` bounds the peak device memory of set-up and of
    serving.  Launch and byte counts come from the partitioned tree: each
    column-split layer leaf once a layer, a hybrid's column-split shared
    leaves once a group (its block re-read by every group that runs it),
    lm_head once, paged attention once per KV layer (none for a pure SSM).
    Returns the launches, TPOT and steps, and the served engine."""
    import repro_torch.configs as C
    from repro_torch.core.tiering import TieredTensor, split_sizes
    from repro_torch.kernels import _build
    from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn, scatter_rows
    from repro_torch.kernels.splitk_gemm import splitk_gemm, splitk_gemm_grouped
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.registry import resolve
    from repro_torch.runtime.telemetry import weight_tier_bytes
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = C.get(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    prompt_len = PREFILL_LEN
    t0 = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    eng = ServingEngine(cfg, M.layer_source(cfg, gen, dtype=torch.bfloat16, device="cuda"),
                        max_batch=DECODE_BATCH, max_len=prompt_len + new_tokens,
                        global_offload_ratio=0.5, page_size=16, device="cuda")
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    print(f"served run set-up ({cfg.n_layers} layers built one at a time: each drawn on the "
          f"card, split, its remote half written into pinned host memory): "
          f"{time.time() - t0:.1f} s | peak device memory during set-up {setup_peak} "
          f"({setup_peak / 1e9:.3f} GB)")
    leaves = list(remote_leaves(eng.params))
    # the operands the plan gives a ratio, and those whose remote extent
    # rounds to zero at the engine's alignment (they stay whole)
    rated = [od for od in eng.plan.registry if eng.plan.op_ratios.get(od.op, 0.0) > 0]
    whole_ops = [od.path_str for od in rated if split_sizes(
        resolve(eng.params, od.path).shape[od.axis], eng.plan.op_ratios[od.op],
        od.align if od.align is not None else eng._align)[1] == 0]
    w_local, w_remote = weight_tier_bytes(eng.params)
    pinned = _build.pinned_bytes()
    check(all(leaf.remote.is_pinned() and leaf.remote.device.type == "cpu"
              for leaf in leaves) and len(leaves) == len(rated) - len(whole_ops),
          f"all {len(leaves)} remote weight tiers (of {len(rated)} tierable operands; "
          f"{', '.join(whole_ops) or 'none'} round to no remote columns and stay whole) are "
          f"pinned host memory, none on the card")
    # What one decode step reads from the host, weights by operand type: each
    # column-split layer leaf once a layer, a hybrid's shared leaves once a
    # group, lm_head once, each remote expert that runs its two matrices once
    # (one grouped launch per expert matrix a layer).
    layer_cols = [w for w in eng.params["layers"].values()
                  if isinstance(w, TieredTensor) and w.axis != -3]
    shared_cols = [w for w in eng.params.get("shared", {}).values()
                   if isinstance(w, TieredTensor)]
    top_cols = [w for w in eng.params.values() if isinstance(w, TieredTensor)]
    # the shared block each group runs (group g runs block g mod blocks)
    groups = ([g % max(1, cfg.hybrid_shared_blocks)
               for g in range(cfg.n_layers // cfg.hybrid_attn_every)] if shared_cols else [])
    static_launches = (cfg.n_layers * len(layer_cols) + len(groups) * len(shared_cols)
                       + len(top_cols))
    shared_step = sum(w.remote[b].nbytes for w in shared_cols for b in groups)
    static_remote = sum(w.remote.nbytes for w in layer_cols + top_cols) + shared_step
    experts = [eng.params["layers"][k] for k in ("experts_wi", "experts_wdown")
               if isinstance(eng.params["layers"].get(k), TieredTensor)]
    expert_bytes = sum(w.remote[0, 0].nbytes for w in experts)
    e_rem = experts[0].remote.shape[1] if experts else 0
    pc = eng.pcache
    kv_layers = pc.pools["k_remote"].shape[0] if pc is not None else 0
    page_bytes = sum(pc.pools[f"{n}_remote"][0, 0].nbytes for n in pc.kv_names) if pc else 0
    kv_pinned = sum(pc.pools[f"{n}_remote"].nbytes for n in pc.kv_names) if pc else 0
    check(pinned == int(w_remote) + kv_pinned,
          f"pinned host bytes {pinned} = remote weight tiers {int(w_remote)} + remote KV pool "
          f"{kv_pinned}: nothing else was pinned")
    if cfg.family == "moe":
        check(len(experts) == 2 and all(w.local.is_cuda for w in experts),
              f"both expert stacks split {experts[0].local.shape[1]}|{e_rem} experts per layer "
              f"(local tier on the card)" if experts else "expert stacks tiered")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    passes = count_prefill_passes(eng)
    reqs, decode, wall = serve_stepping(eng, cfg, n_req, prompt_len, new_tokens)
    prefill_counted = sum(c for _, c in passes)
    prefill_model = sum(dense_prefill_model(eng.params, n)[0] for n, _ in passes)
    stats = eng.stats
    launches = {"splitk_gemm": splitk_gemm.launches,
                "splitk_gemm_grouped": splitk_gemm_grouped.launches,
                "paged_attention": paged_splitk_flashattn.launches,
                "scatter_rows": scatter_rows.launches}
    peak = torch.cuda.max_memory_allocated()
    total_w = w_local + w_remote
    n_dec = len(decode)
    mean = lambda key: sum(s[key] for s in decode) / max(1, n_dec)  # noqa: E731
    kv_step = mean("kv_pages") * page_bytes * kv_layers
    remote_step = static_remote + mean("experts") * expert_bytes + kv_step
    print(f"served {stats.served}/{n_req} requests ({prompt_len} prompt + {new_tokens} new "
          f"tokens each) in {wall:.2f} s | {stats.generated_tokens / wall:.2f} tokens/s | "
          f"TPOT {stats.tpot * 1e3:.1f} ms over {stats.decode_steps} decode steps | "
          f"TTFT p50 {stats.ttft_p50 * 1e3:.1f} ms | prefill total {stats.prefill_time:.2f} s")
    print(f"launches during the served run: {launches}")
    print(f"decode step: graphed={eng.graphed} | compile_count {eng.compile_count} | cache hits "
          f"{eng.compile_cache_hits} | recaptures {eng.recaptures}")
    gemm_part, bytes_part = ")", ""
    if experts:
        gemm_part = (f"); splitk_gemm_grouped {mean('grouped'):.2f} (2 x {cfg.n_layers} MoE "
                     f"layers); remote experts run {mean('experts'):.2f} of "
                     f"{e_rem * cfg.n_layers}")
        no_skip = remote_step + (e_rem * cfg.n_layers - mean("experts")) * expert_bytes
        bytes_part = f"; {no_skip / 1e9:.3f} GB if every remote expert were read"
    cols = (f"{cfg.n_layers} layers x {len(layer_cols)} + {len(groups)} groups x "
            f"{len(shared_cols)} shared + {len(top_cols)}" if shared_cols else
            f"{cfg.n_layers} layers x {len(layer_cols)} + {len(top_cols)}")
    print(f"per decode step that admitted nothing ({n_dec} steps, means): splitk_gemm "
          f"{mean('gemm'):.2f} ({static_launches} for the column-split weights, {cols}"
          f"{gemm_part}; paged attention {mean('attn'):.2f} ({kv_layers} KV layers); remote KV "
          f"pages attended {mean('kv_pages'):.2f} a layer")
    print(f"remote bytes read per decode step (each byte once per use): "
          f"{remote_step / 1e9:.3f} GB = {static_remote / 1e9:.3f} column-split weights (of "
          f"them {shared_step / 1e9:.3f} the shared blocks, re-read by each of "
          f"{len(groups)} groups) + {mean('experts') * expert_bytes / 1e9:.3f} remote experts + "
          f"{kv_step / 1e9:.4f} KV{bytes_part}")
    rows = sorted({n for n, _ in passes})
    print(f"remote weight bytes of the {len(passes)} prefill passes ({rows} rows), counted "
          f"on the device (`splitk_gemm.host_bytes`): {prefill_counted} B "
          f"({prefill_counted / 1e9:.3f} GB) | tiling model of the column-split layer weights "
          f"and lm_head {prefill_model} B")
    if cfg.family in ("dense", "vlm"):
        check(prefill_counted == prefill_model,
              f"prefill's remote weight bytes counted {prefill_counted} = tiling model "
              f"{prefill_model}")
    if pc is not None:
        print(f"kv pages: local hwm {stats.local_pages_hwm}/{pc.n_local}, remote hwm "
              f"{stats.remote_pages_hwm}/{pc.n_remote}, spills {stats.spills}")
        design = kv_read_check(eng, cfg, decode, kv_layers, page_bytes)
    print(f"weights: {w_local / 1e9:.3f} GB local + {w_remote / 1e9:.3f} GB remote | "
          f"pinned host bytes {pinned} ({pinned / 1e9:.3f} GB) | peak device memory "
          f"during serving {peak} ({peak / 1e9:.3f} GB) vs total weights {total_w / 1e9:.3f} GB")
    check(stats.served == n_req, f"served every request ({stats.served}/{n_req})")
    check(all(len(r.out_tokens) == new_tokens and all(0 <= t < cfg.vocab for t in r.out_tokens)
              for r in reqs), f"every request emitted {new_tokens} tokens in [0, vocab)")
    check(launches["splitk_gemm"] > 0 and (launches["paged_attention"] > 0) == (kv_layers > 0),
          "splitk_gemm launched on the main path" + (", and paged attention" if kv_layers
                                                      else "; paged attention never (no KV)"))
    check(launches["paged_attention"] == kv_layers * stats.decode_steps
          and all(s["attn"] == kv_layers for s in decode),
          f"paged attention launched exactly {kv_layers} times per decode step")
    if experts:
        bad = [s for s in decode if s["grouped"] != 2 * cfg.n_layers]
        check(n_dec > 0 and not bad and sum(s["experts"] for s in decode) > 0,
              f"splitk_gemm_grouped launched exactly 2 x {cfg.n_layers} MoE layers times in "
              f"each of {n_dec} decode steps ({len(bad)} steps differ), remote experts ran")
    if pc is not None:
        check(stats.local_pages_hwm >= 1 and stats.remote_pages_hwm >= 1,
              "KV pages resident in both tiers")
    check(peak < total_w, "peak device memory during serving below the model's total weight "
                          "bytes (the remote tier never came into HBM)")
    transient = setup_peak - base - w_local
    bound, terms = setup_transient_bound(eng.params)
    whole = ("never the whole model" if bound < total_w else
             f"at {cfg.n_layers} layers that bound reaches the model's {total_w / 1e9:.3f} GB, "
             f"so this does not show the model was never whole")
    check(transient < bound,
          f"set-up held beyond the weights the engine keeps {transient / 1e9:.3f} GB (peak "
          f"{setup_peak / 1e9:.3f} - before {base / 1e9:.3f} - device weights "
          f"{w_local / 1e9:.3f}), below what building one layer at a time holds, "
          f"{bound / 1e9:.3f} GB ({terms}): {whole}")
    check(n_dec > 0 and all(s["gemm"] == static_launches for s in decode),
          f"splitk_gemm launched exactly {static_launches} times per decode step ({cols}"
          f" column-split weights)")
    if peak_limit is not None:
        check(setup_peak < peak_limit and peak < peak_limit,
              f"peak device memory during set-up {setup_peak / 1e9:.3f} GB and during serving "
              f"{peak / 1e9:.3f} GB, each below {peak_limit / 1e9:.0f} GB against "
              f"{total_w / 1e9:.3f} GB of weights")
    check(eng.graphed and eng.compile_count > 0,
          f"decode steps graphed by default ({eng.compile_count} buckets)")
    traced = profile_decode_steps(eng, cfg, np.random.default_rng(1), prompt_len)
    if pc is not None:
        traced_attention(traced, kv_layers, design)
    if experts:
        eager_beside(eng, cfg, reqs, decode, n_req, prompt_len, new_tokens,
                     static_remote + kv_step, expert_bytes)
    return {"launches": launches, "tpot_ms": stats.tpot * 1e3,
            "steps": stats.decode_steps, "engine": eng}


def kv_read_check(eng, cfg, decode, kv_layers, page_bytes):
    """The remote KV bytes paged attention loaded in each served decode step
    that admitted nothing, counted on the device, against `paged_reads` over
    the page tiers and lengths each step attended, for the design the
    engine's launches take; printed beside the bytes if each remote page in
    use were read once.  Returns that design."""
    from repro_torch.analysis.kernel_lints import _attention_shape
    from repro_torch.kernels.splitk_flashattn import paged_design

    pc = eng.pcache
    h, kh, hd = _attention_shape(cfg)
    design = paged_design(DECODE_BATCH, h, kh, hd, pc.page_size, pc.table.shape[1],
                          window=eng.window, dtype=torch.bfloat16, alias_v=pc.kv_names == ("k",))
    model = [kv_layers * paged_model_bytes(design, *s["attended"], pc.page_size, h, kh, hd, 2)
             for s in decode]
    counted = [s["kv_bytes"] for s in decode]
    n = max(1, len(decode))
    once = sum(s["kv_pages"] for s in decode) * page_bytes * kv_layers / n
    print(f"remote KV bytes paged attention loaded per decode step that admitted nothing, "
          f"counted on the device (`paged_splitk_flashattn.host_bytes`): {sum(counted) / n:.1f} "
          f"B (model {sum(model) / n:.1f} B; {design.name} design, clusters of "
          f"{design.cluster}, {design.heads_per_cta} heads a CTA) | each remote page in use "
          f"read once: {once:.1f} B")
    check(counted == model,
          f"remote KV bytes counted in each of {len(decode)} decode steps equal the model of the "
          f"{design.name} design ({sum(counted)} B in all)")
    return design


def traced_attention(traced: dict, kv_layers: int, design) -> None:
    """Paged attention's device time a step in the profiler trace of the
    served decode steps, by kernel; the cluster design's kernel where the
    engine's launches take it."""
    attn = {k: v for k, v in traced.get("kernel_ms", {}).items() if "paged_attn" in k}
    if not traced:
        print("  paged attention a step: not measured (the profiler recorded no device time)")
        return
    print(f"  paged attention in the traced decode steps: {sum(attn.values()):.3f} ms a step "
          f"({kv_layers} launches a step): " + "; ".join(f"{k[:70]} {v:.3f} ms"
                                                     for k, v in attn.items()))
    want = "paged_attn_cluster_kernel" if design.name == "cluster" else "paged_attn_kernel<"
    check(bool(attn) and all(want in k for k in attn),
          f"the traced paged attention ran the {design.name} design's kernel only")


LONG_PROMPT = 2048          # prompt tokens of phase 12's long request (M = 192 an expert)


def long_prompt_request() -> None:
    """One Qwen3-30B-A3B request of `LONG_PROMPT` prompt + 4 new tokens at
    its published widths and depth (48 layers, bf16, offload 0.5, page 16)
    on an engine of one slot: the prefill pass alone under the wrapper's
    grouped design (the cluster design at M = 192) and under the split-K
    design it replaced, each with the host bytes the grouped launches
    counted beside the tiling model (remote experts run x the bytes an
    expert x the reads per expert), the logits of the two within the bf16
    bound; then under the whole-K design that the dense cluster design
    replaced (the attention projections; the wrapper's private launch path),
    its logits within the same bound; each pass with the dense remote bytes
    `splitk_gemm` counted beside their tiling model; then the request
    served, its TTFT and tokens."""
    import repro_torch.configs as C
    from repro_torch.core.tiering import TieredTensor
    from repro_torch.kernels.splitk_gemm import (
        _launch,
        _launch_grouped,
        grouped_tiling,
        splitk_gemm,
        splitk_gemm_grouped,
    )
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serving import tiered_decode as TD
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = C.get("qwen3_moe_30b_a3b")
    new_tokens = 4
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(0)
    eng = ServingEngine(cfg, M.layer_source(cfg, gen, dtype=torch.bfloat16, device="cuda"),
                        max_batch=1, max_len=LONG_PROMPT + 16,
                        global_offload_ratio=0.5, page_size=16, device="cuda")
    torch.cuda.synchronize()
    build_s = time.time() - t0
    wi = eng.params["layers"]["experts_wi"]
    per_expert = wi.remote[0, 0].nbytes + eng.params["layers"]["experts_wdown"].remote[0, 0].nbytes
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, LONG_PROMPT).astype(np.int32)
    tokens = torch.as_tensor(prompt, device="cuda")[None]
    m = L.expert_capacity(cfg, LONG_PROMPT)
    hb, ran = splitk_gemm_grouped.host_bytes, L.tiered_expert_ffn.remote_experts
    old_mm = TD.kernel_mm(eng.window)
    old_mm.grouped = lambda x, w, counts: _launch_grouped(x, w, counts, eng.window, "split-K")
    new_mm = TD.kernel_mm(eng.window)

    def whole_k_mm(a, w):        # the dense whole-K design; experts as the wrapper runs them
        if not isinstance(w, TieredTensor):
            return new_mm(a, w)
        y = _launch(a.reshape(-1, a.shape[-1]).contiguous(), w.local, w.remote, eng.window, 0)
        return y.reshape(*a.shape[:-1], y.shape[-1])

    whole_k_mm.grouped = new_mm.grouped
    dense_hb = splitk_gemm.host_bytes
    logits, line = {}, []
    for label, mm, design, dense_ks in (("cluster", new_mm, "cluster", None),
                                        ("split-K", old_mm, "split-K", None),
                                        ("dense whole-K", whole_k_mm, "cluster", 0)):
        hb.reset()
        dense_hb.reset()
        ran.reset()
        torch.cuda.synchronize()
        t1 = time.time()
        logits[label], _ = M.prefill(cfg, eng.params, {"tokens": tokens}, max_len=eng.max_len,
                                     mm=mm)
        torch.cuda.synchronize()
        sec = time.time() - t1
        counted, experts, dense = int(hb), int(ran), int(dense_hb)
        model = experts * per_expert * grouped_tiling(m, torch.bfloat16, design=design).reads
        dense_model, dense_reads = dense_prefill_model(eng.params, LONG_PROMPT, k_split=dense_ks)
        check(counted == model and dense == dense_model,
              f"long prompt, {label}: expert bytes counted {counted} = tiling model "
              f"{experts} remote experts run x {per_expert} B x "
              f"{grouped_tiling(m, torch.bfloat16, design=design).reads} read(s) = {model}; "
              f"dense bytes counted {dense} = tiling model {dense_model} (attention projections "
              f"read {dense_reads} time(s), lm_head once)")
        line.append(f"{label} {sec * 1e3:.1f} ms, expert bytes counted {counted} "
                    f"({counted / 1e9:.3f} GB), dense bytes counted {dense} "
                    f"({dense / 1e9:.3f} GB)")
    for old in ("split-K", "dense whole-K"):
        rel, ab = rel_err(logits["cluster"], logits[old])
        check(rel < TOL[torch.bfloat16] and torch.isfinite(logits["cluster"].float()).all().item(),
              f"long prompt: prefill logits of the cluster designs within "
              f"{TOL[torch.bfloat16]:.0e} of the {old} design's (max rel err {rel:.2e}, abs "
              f"{ab:.2e})")
    del logits
    hb.reset()
    req = Request(rid=0, prompt=prompt, max_new_tokens=new_tokens)
    eng.submit(req)
    stats = eng.run()
    check(stats.served == 1 and len(req.out_tokens) == new_tokens
          and all(0 <= t < cfg.vocab for t in req.out_tokens),
          f"long prompt served: {len(req.out_tokens)} tokens {req.out_tokens}")
    print(f"long prompt ({LONG_PROMPT} + {new_tokens} tokens, 48 layers, built in {build_s:.1f} "
          f"s, M = {m} rows an expert, {wi.remote.shape[1]} remote experts a layer): prefill "
          f"pass under the {' | '.join(line)} | served: TTFT {stats.ttfts[0] * 1e3:.1f} ms, TPOT "
          f"{stats.tpot * 1e3:.1f} ms, expert bytes counted over the request {int(hb)} "
          f"({int(hb) / 1e9:.3f} GB)")


def serve_stepping(eng, cfg, n_req, prompt_len, new_tokens):
    """Serve `n_req` requests of `prompt_len` random tokens (seed 0) one
    engine step at a time, the wrapper counts reset first; returns the
    requests, each decode step that admitted nothing (launches, remote
    experts run, remote KV pages attended, the remote KV bytes paged
    attention counted on the device and the page tiers and lengths the step
    attended) and the wall time."""
    from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn, scatter_rows
    from repro_torch.kernels.splitk_gemm import splitk_gemm, splitk_gemm_grouped
    from repro_torch.models import layers as L
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, prompt_len).astype(np.int32),
                    max_new_tokens=new_tokens) for i in range(n_req)]
    for r in reqs:
        eng.submit(r)
    splitk_gemm.launches = splitk_gemm_grouped.launches = 0
    paged_splitk_flashattn.launches = scatter_rows.launches = 0
    L.tiered_expert_ffn.remote_experts.reset()
    kv_bytes = paged_splitk_flashattn.host_bytes
    kv_bytes.reset()
    kv_total = kv_bytes.total(torch.device("cuda", torch.cuda.current_device()))
    decode = []                                # the steps that admitted nothing
    t0 = time.time()
    while eng.scheduler.waiting or any(r is not None for r in eng.active):
        before = (splitk_gemm.launches, splitk_gemm_grouped.launches,
                  paged_splitk_flashattn.launches, int(L.tiered_expert_ffn.remote_experts),
                  len(eng.stats.ttfts), eng.stats.decode_steps)
        kv_pages = remote_kv_pages(eng)
        kv_before = kv_total.clone()           # on the device: no sync inside the run
        eng.step()
        if eng.stats.decode_steps > before[5] and len(eng.stats.ttfts) == before[4]:
            staged = eng._inputs._staging if eng.pcache is not None else None
            decode.append({"gemm": splitk_gemm.launches - before[0],
                           "grouped": splitk_gemm_grouped.launches - before[1],
                           "attn": paged_splitk_flashattn.launches - before[2],
                           "experts": int(L.tiered_expert_ffn.remote_experts) - before[3],
                           "kv_pages": kv_pages, "kv_bytes": kv_total - kv_before,
                           "attended": None if staged is None else
                           (staged["tier"].copy(), staged["attn_lens"].copy())})
    torch.cuda.synchronize()
    for s in decode:
        s["kv_bytes"] = int(s["kv_bytes"])
    return reqs, decode, time.time() - t0


def eager_beside(eng, cfg, graphed_reqs, graphed, n_req, prompt_len, new_tokens,
                 fixed_step_bytes, expert_bytes) -> None:
    """The MoE served run again on the same engine (its cache state reset),
    decode steps eager: tokens, remote experts run and remote bytes a step
    equal to the graphed run's; TPOT and the profiler's traced step, device
    busy and host time a step beside the graphed run's (printed above)."""
    fresh_serving_state(eng)
    eng._jit = False
    reqs, decode, wall = serve_stepping(eng, cfg, n_req, prompt_len, new_tokens)
    st = eng.stats
    mean = lambda steps, key: sum(s[key] for s in steps) / max(1, len(steps))  # noqa: E731
    step_gb = {name: (fixed_step_bytes + mean(steps, "experts") * expert_bytes) / 1e9
               for name, steps in (("graphed", graphed), ("eager", decode))}
    print(f"eager beside (same engine, cache state reset): served {st.served}/{n_req} in "
          f"{wall:.2f} s | TPOT {st.tpot * 1e3:.1f} ms over {st.decode_steps} decode steps | "
          f"remote experts run {mean(decode, 'experts'):.2f} a step (graphed "
          f"{mean(graphed, 'experts'):.2f}) | remote bytes a step {step_gb['eager']:.3f} GB "
          f"(graphed {step_gb['graphed']:.3f}) | splitk_gemm_grouped "
          f"{mean(decode, 'grouped'):.2f} a step")
    check([r.out_tokens for r in reqs] == [r.out_tokens for r in graphed_reqs]
          and [s["experts"] for s in decode] == [s["experts"] for s in graphed],
          f"{cfg.name}: eager tokens and remote experts run in each of {len(decode)} decode "
          f"steps equal the graphed run's ({sum(s['experts'] for s in decode)} in all), so "
          f"remote bytes a step too ({step_gb['eager']:.3f} GB)")
    profile_decode_steps(eng, cfg, np.random.default_rng(1), prompt_len)


def setup_transient_bound(params) -> tuple[float, str]:
    """The most device memory that building `params` one layer at a time
    (`models.layer_source` + `TieringPlan.partition_source`) holds beyond
    the weights it keeps, and its terms.  The source holds each tiered
    leaf outside the layer stack (lm_head, a hybrid's shared block stacks,
    walked as leaves of the nested ``shared`` dict) whole until the engine
    is built, and splitting one holds its remote half on the device until
    that is pinned.  Each
    layer is then drawn whole on the device, each leaf through fp32 draws of
    at most `_DRAW_CHUNK` elements (one alive at a time), and written into
    its slots, a column-split remote half through a contiguous device copy.
    The caching allocator may hand a live tensor up to 1 MiB more than it
    asked for."""
    from repro_torch.core.tiering import TieredTensor
    from repro_torch.models import model as M

    def size(w) -> int:
        return w.local.nbytes + w.remote.nbytes if isinstance(w, TieredTensor) else w.nbytes

    def draw(shape) -> int:               # fp32 bytes of a leaf's largest draw chunk
        row = math.prod(shape[1:])
        return 4 * min(math.prod(shape), max(1, M._DRAW_CHUNK // max(1, row)) * row)

    layers = params["layers"]
    top = [w for path, w in tree_leaves(params) if not path.startswith("layers/")]
    top_whole = sum(size(w) for w in top if isinstance(w, TieredTensor))
    top_remote = sum(w.remote.nbytes for w in top if isinstance(w, TieredTensor))
    layer = sum(size(w) // w.shape[0] for w in layers.values())
    chunk = max([draw(w.shape[1:]) for w in layers.values()] + [draw(w.shape) for w in top])
    copy = max([w.remote[0].nbytes for w in layers.values()
                if isinstance(w, TieredTensor) and w.axis == -1] + [0])
    slack = (len(layers) + len(top) + 2) << 20
    bound = top_whole + max(top_remote, layer + max(chunk, copy)) + slack
    return bound, (f"whole tiered top-level leaves {top_whole / 1e9:.3f} + max(their remote "
                   f"halves {top_remote / 1e9:.3f}, one layer {layer / 1e9:.3f} + max(fp32 draw "
                   f"chunk {chunk / 1e9:.3f}, remote-half copy {copy / 1e9:.3f})) + allocator "
                   f"rounding {slack / 1e9:.3f}")


def profile_decode_steps(eng, cfg, rng, prompt_len, steps=3) -> dict:
    """One torch.profiler trace of `steps` decode steps of the served engine
    at batch 4 (after the served run, on fresh requests, prefill outside the
    trace): see `trace_device`."""
    from repro_torch.serving.engine import Request

    for i in range(DECODE_BATCH):
        eng.submit(Request(rid=1000 + i, max_new_tokens=steps + 3,
                           prompt=rng.integers(3, cfg.vocab, prompt_len).astype(np.int32)))
    eng.step()                                  # admissions, prefills and one decode step
    out = trace_device(eng.step, steps, f"decode steps at batch 4 "
                                        f"({'graphed' if eng.graphed else 'eager'})")
    eng.run()
    return out


def trace_device(step, steps: int, what: str) -> dict:
    """One torch.profiler trace of `steps` calls of `step`: the device's busy
    share of their wall time and the kernels that take most device time.
    Returns the traced and device-busy ms per step (empty when the profiler
    saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    busy, end = 0.0, -1.0
    for a, b in spans:                          # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    if busy == 0.0:
        print(f"  profiler: {steps} {what} traced, but torch.profiler recorded "
              f"no device time on this machine; no breakdown")
        return {}
    self_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                getattr(e, "self_cuda_time_total", 0.0))
    rows = sorted((e for e in prof.key_averages() if self_us(e) > 0
                   and getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
                  key=self_us, reverse=True) or sorted(
        (e for e in prof.key_averages() if self_us(e) > 0), key=self_us, reverse=True)
    print(f"  profiler: {steps} {what} in {wall_us / 1e3:.2f} ms of host wall time "
          f"({wall_us / steps / 1e3:.2f} ms per step); device busy {busy / 1e3:.2f} ms "
          f"({busy / wall_us:.1%}), idle {(wall_us - busy) / 1e3:.2f} ms "
          f"({(wall_us - busy) / steps / 1e3:.2f} ms per step)")
    for e in rows[:12]:
        print(f"    {self_us(e) / 1e3 / steps:9.3f} ms per step  {e.count // steps:5d} calls per "
              f"step  {e.key[:100]}")
    return {"traced_ms": wall_us / steps / 1e3, "busy_ms": busy / steps / 1e3,
            "busy_share": busy / wall_us,
            "kernel_ms": {e.key: self_us(e) / 1e3 / steps for e in rows}}


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


def whole_k(x, wl, wr):
    """splitk_gemm's kernel on its whole-K design (the decode design that
    split-K replaced, still the prefill design) at any M, through the
    wrapper's own launch; uncounted.  Returns the call, taking the window."""
    from repro_torch.kernels.splitk_gemm import _launch

    return lambda window: _launch(x, wl, wr, window, 0)


def planner_shapes(ratio: float) -> dict:
    """(K, N_loc, N_rem) of each llama2-7b projection as the serving
    engine's planner splits it at global offload `ratio`, with
    launch/serve.py's other defaults (batch 4, max_len 64, page 8; align
    128)."""
    import repro_torch.configs as C
    from repro_torch.core import engine as E
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.tiering import split_sizes

    plan = E.plan(C.get("llama2_7b"), WorkloadSpec(batch=4, seq_len=64, phase="decode"),
                  H100_SXM, global_ratio=ratio, kv_page_size=8)
    ratios = {od.path[-1]: plan.op_ratios.get(od.op, 0.0) for od in plan.registry}
    return {name: (k, *split_sizes(n_loc + n_rem, ratios[name], 128))
            for name, (k, n_loc, n_rem) in GEMM_SHAPES.items()}


def alternate(fns, flush, n_rounds: int = ROUNDS, iters: int = 10) -> list[list[float]]:
    """`n_rounds` timings (each the median of `iters` launches) of each call
    in `fns`, in alternating order (forward on even rounds, backward on
    odd), so the machine's drift falls on each alike."""
    rounds = [[] for _ in fns]
    for r in range(n_rounds):
        for i in (range(len(fns)) if r % 2 == 0 else range(len(fns) - 1, -1, -1)):
            rounds[i].append(time_ms(fns[i], iters=iters, flush=flush))
    return rounds


def bound(local_bytes, remote_bytes, flops, link_bw, peak):
    t_bytes = max(local_bytes / HBM_BW, remote_bytes / link_bw)
    t_ops = flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def prefetch_cublas(x, wl, wr, wr_dev):
    """The prefetching yardstick of the tiered GEMM: the pinned remote tier
    `wr` copied into its HBM buffer `wr_dev`, then cuBLAS on each tier (the
    design direct access replaces; phase 32 holds the lint to catching it)."""
    wr_dev.copy_(wr, non_blocking=True)
    return torch.cat([x @ wl, x @ wr_dev], dim=1)


def time_decode_gemm(shapes, window, gen, flush, link, label) -> dict:
    """The wrapper's decode GEMM (split-K), the whole-K design and prefetch
    + cuBLAS at M = DECODE_BATCH over `shapes`, in alternating rounds; one
    line per projection with each one's remote GB/s, then the sums per
    decode step (32 layers + lm_head)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_gemm import splitk_gemm

    bf, m = torch.bfloat16, DECODE_BATCH
    step = dict(ms=0.0, whole_k_ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                t_bytes=0.0, t_ops=0.0, rounds=[[0.0, 0.0] for _ in range(ROUNDS)])
    for name, (k, n_loc, n_rem) in shapes.items():
        wl, wr, wr_dev = make_tier_pair(k, n_loc, n_rem, bf, gen)
        count = 1 if name == "lm_head" else 32
        x = torch.randn((m, k), generator=gen, device="cuda").to(bf)
        old = whole_k(x, wl, wr)
        want = ref.splitk_gemm_ref(x, wl, wr_dev)
        for design, y in (("split-K", splitk_gemm(x, wl, wr, window=window)),
                          ("whole-K", old(window))):
            rel, _ = rel_err(y, want)
            check(rel < TOL[bf], f"splitk_gemm {design} design {label} {name} M={m}: max rel "
                                 f"err {rel:.2e}")
        t = {w: time_ms(lambda w=w: splitk_gemm(x, wl, wr, window=w), flush=flush)
             for w in (1, 2, 4)}
        t_old = {w: time_ms(lambda w=w: old(w), flush=flush) for w in (1, 2, 4)}
        t_plain = time_ms(lambda: ref.splitk_gemm_ref(x, wl, wr_dev), flush=flush)

        def prefetch(x=x, wl=wl, wr=wr, wr_dev=wr_dev):
            return prefetch_cublas(x, wl, wr, wr_dev)

        rounds = alternate([lambda: splitk_gemm(x, wl, wr, window=window),
                            lambda: old(window), prefetch], flush)
        t[window], t_old[window], t_lib = (statistics.median(v) for v in rounds)
        wins = sum(a < b for a, b in zip(rounds[0], rounds[1]))
        loc_b = (x.numel() + wl.numel() + m * (n_loc + n_rem)) * 2
        rem_b = wr.numel() * 2
        flops = 2 * m * k * (n_loc + n_rem)
        b_ms, b_by = bound(loc_b, rem_b, flops, link, BF16_PEAK)
        gbs = lambda ms: rem_b / (ms * 1e-3) / 1e9  # noqa: E731
        print(f"  splitk_gemm {label} {name} M={m} K={k} N={n_loc}|{n_rem} bf16: kernel "
              f"(split-K) {t[window]:.4f} ms (windows 1/2/4: {t[1]:.4f}/{t[2]:.4f}/{t[4]:.4f}), "
              f"remote {gbs(t[window]):.2f} GB/s | whole-K design {t_old[window]:.4f} ms "
              f"(windows 1/2/4: {t_old[1]:.4f}/{t_old[2]:.4f}/{t_old[4]:.4f}), remote "
              f"{gbs(t_old[window]):.2f} GB/s | window {window}: medians of {ROUNDS} "
              f"alternating rounds, split-K faster in {wins} | plain {t_plain:.4f} ms | bound "
              f"{b_ms:.4f} ms ({b_by}) | prefetch+cuBLAS {t_lib:.4f} ms ({gbs(t_lib):.2f} GB/s)")
        for r in range(ROUNDS):
            step["rounds"][r][0] += count * rounds[0][r]
            step["rounds"][r][1] += count * rounds[1][r]
        step["ms"] += count * t[window]
        step["whole_k_ms"] += count * t_old[window]
        step["plain_ms"] += count * t_plain
        step["bound_ms"] += count * b_ms
        step["library_ms"] += count * t_lib
        step["t_bytes"] += count * max(loc_b / HBM_BW, rem_b / link)
        step["t_ops"] += count * flops / BF16_PEAK
        del wl, wr, wr_dev
    step_wins = sum(a < b for a, b in step.pop("rounds"))
    print(f"  per decode step {label} at batch 4 (32 layers + lm_head): splitk_gemm "
          f"{step['ms']:.3f} ms (whole-K design {step['whole_k_ms']:.3f} ms, split-K faster in "
          f"{step_wins} of {ROUNDS} rounds; prefetch+cuBLAS {step['library_ms']:.3f} ms) vs "
          f"bound {step['bound_ms']:.3f} ms")
    return step


def phase_timing(card: dict, window: int) -> dict:
    link = card["link_bw"]
    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_
    gen = torch.Generator(device="cuda").manual_seed(3)
    n_layers = 32
    print(f"timing on {card['name']} (power limit {card['power']}), CUDA events, "
          f"L2 flushed before each launch, median of 10; window {window} unless noted")
    step = {"splitk_gemm": time_decode_gemm(GEMM_SHAPES, window, gen, flush, link,
                                            "offload 0.5")}
    # the planner's split at launch/serve.py's default offload (0.4), where
    # wq, wo and wdown have 26 remote tiles
    time_decode_gemm(planner_shapes(SERVE_OFFLOAD), window, gen, flush, link,
                     f"offload {SERVE_OFFLOAD} (planner)")
    # prefill: the cluster design beside the whole-K design it replaced
    time_prefill_gemm(link, flush, gen, window)
    # decode attention at the served runs' late-step shapes, then at a long
    # cache
    step["paged_attention"] = per_step(time_paged_attention(
        "served", PAGED_LENS, 10, link, flush, gen, window), n_layers)
    time_paged_attention("long cache", PAGED_LONG_LENS, 128, link, flush, gen, window)
    # DeepSeek-V2's MLA decode (phase 14) at the same lengths: 128 heads over
    # one latent kv head of 576 (kv_lora 512 + rope 64), V the K pool
    time_paged_attention("mla", PAGED_LENS, 10, link, flush, gen, window, h=128, kh=1,
                         hd=576, scale=192 ** -0.5, alias_v=True)
    step["splitk_flashattn"] = per_step(time_splitk_attention(
        "served", 512, SPLIT_KV_LEN, link, flush, gen, window), n_layers)
    time_splitk_attention("long cache", 2048, 2048, link, flush, gen, window)
    for name in ("paged_attention", "splitk_flashattn"):
        s = step[name]
        print(f"  per decode step ({n_layers} layers): {name} {s['ms']:.3f} ms (device; "
              f"wrapper calls {s['wrapper_ms']:.3f}, host {s['host_ms']:.3f}) | library "
              f"{s['library_ms']:.3f} ms | bound {s['bound_ms']:.3f} ms")
    step["flash_prefill"] = time_flash_prefill(flush, gen)
    step["splitk_gemm_grouped"] = time_grouped_experts(link, flush, gen, window)
    return step


def time_prefill_gemm(link, flush, gen, window) -> None:
    """llama2-7b's projections at offload 0.5 at the prefill rows of
    `PREFILL_GEMM_M`: `splitk_gemm` (the cluster design), the whole-K design
    it replaced (the wrapper's private launch path), prefetch + cuBLAS, the
    plain version with both tiers in HBM and the bound (the remote tier once
    over the link), in alternating rounds (fewer at 2048 rows); each line
    with the GB/s of unique remote bytes, both designs' counted host bytes
    (`splitk_gemm.host_bytes`) beside the tiling model, and the cluster
    design's workspace; then the sums per prefill (32 layers + lm_head)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_gemm import _launch, gemm_tiling, splitk_gemm

    bf, hb = torch.bfloat16, splitk_gemm.host_bytes
    for m, n_rounds in PREFILL_GEMM_M.items():
        total = dict(new=0.0, old=0.0, lib=0.0, plain=0.0, bound=0.0)
        for name, (k, n_loc, n_rem) in GEMM_SHAPES.items():
            wl, wr, wr_dev = make_tier_pair(k, n_loc, n_rem, bf, gen)
            x = torch.randn((m, k), generator=gen, device="cuda").to(bf)
            count = 1 if name == "lm_head" else 32
            want = ref.splitk_gemm_ref(x, wl, wr_dev)
            rem_b = wr.numel() * 2
            counted, model = {}, {}
            for design, fn, ks in (("cluster", lambda: splitk_gemm(x, wl, wr, window=window),
                                    None),
                                   ("whole-K", lambda: _launch(x, wl, wr, window, 0), 0)):
                hb.reset()
                got = fn()
                torch.cuda.synchronize()
                counted[design] = int(hb)
                tiling = gemm_tiling(m, k, n_loc, n_rem, bf, sm_count=sm_count(), k_split=ks)
                model[design] = rem_b * tiling.reads
                rel, _ = rel_err(got, want)
                check(rel < TOL[bf] and tiling.design == design,
                      f"splitk_gemm {design} design {name} M={m}: max rel err {rel:.2e}")
                if design == "cluster":
                    t = tiling
                del got
            check(counted == model,
                  f"host bytes counted {name} M={m}: cluster design {counted['cluster']} B, "
                  f"whole-K design {counted['whole-K']} B; tiling model {model}")

            def prefetch(x=x, wl=wl, wr=wr, wr_dev=wr_dev):
                return prefetch_cublas(x, wl, wr, wr_dev)

            rounds = alternate([lambda: splitk_gemm(x, wl, wr, window=window),
                                lambda: _launch(x, wl, wr, window, 0), prefetch], flush,
                               n_rounds=n_rounds, iters=3 if m >= 2048 else 5)
            t_new, t_old, t_lib = (statistics.median(v) for v in rounds)
            t_plain = time_ms(lambda: ref.splitk_gemm_ref(x, wl, wr_dev), iters=3, flush=flush)
            loc_b = (x.numel() + wl.numel() + m * (n_loc + n_rem)) * 2
            b_ms, b_by = bound(loc_b, rem_b, 2 * m * k * (n_loc + n_rem), link, BF16_PEAK)
            gbs = lambda ms: rem_b / (ms * 1e-3) / 1e9  # noqa: E731
            print(f"  splitk_gemm prefill {name} M={m} K={k} N={n_loc}|{n_rem} bf16, medians of "
                  f"{n_rounds} alternating rounds: cluster design {t_new:.4f} ms "
                  f"({gbs(t_new):.2f} GB/s unique; MB {t.mb}, clusters of {t.cluster}, "
                  f"{t.splits} split(s), workspace {t.workspace * 4} B) | whole-K design "
                  f"{t_old:.4f} ms ({gbs(t_old):.2f} GB/s unique) | prefetch+cuBLAS "
                  f"{t_lib:.4f} ms | plain {t_plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | "
                  f"host bytes counted: cluster {counted['cluster']} ({t.reads} read(s)), "
                  f"whole-K {counted['whole-K']} ({model['whole-K'] // rem_b} reads) = tiling "
                  f"model")
            for key, ms in (("new", t_new), ("old", t_old), ("lib", t_lib), ("plain", t_plain),
                            ("bound", b_ms)):
                total[key] += count * ms
            del wl, wr, wr_dev, x, want
        print(f"  per prefill of {m} rows (32 layers + lm_head at M={m}): cluster design "
              f"{total['new']:.1f} ms | whole-K design {total['old']:.1f} ms | prefetch+cuBLAS "
              f"{total['lib']:.1f} ms | plain {total['plain']:.1f} ms | bound "
              f"{total['bound']:.1f} ms")


QWEN3_EXPERTS = dict(d=2048, ff=768, e_rem=64, layers=48)   # offload 0.5
QWEN3_ACTIVE = 15           # remote experts with a slot a layer (about 14.7 in phase 12)


def time_grouped_experts(link, flush, gen, window) -> dict:
    """The remote expert block of one Qwen3-30B-A3B MoE layer at decode
    (batch 4, capacity 1: M = 1; 64 remote experts, `QWEN3_ACTIVE` of them
    with a slot): `splitk_gemm_grouped` on wi then wdown (the kernel),
    beside the per-expert `splitk_gemm` loop it replaced, the plain version
    with both stacks in HBM, and a library yardstick (the active experts
    copied from pinned memory into HBM, then `torch.bmm`); bound: the
    active experts' bytes over the host link.  Returned per decode step
    (48 layers)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_gemm import splitk_gemm_grouped

    bf = torch.bfloat16
    d, ff, e, n_layers = (QWEN3_EXPERTS[k] for k in ("d", "ff", "e_rem", "layers"))
    w_dev = {"wi": (torch.randn((e, d, 2 * ff), generator=gen, device="cuda") * 0.02).to(bf),
             "wdown": (torch.randn((e, ff, d), generator=gen, device="cuda") * 0.02).to(bf)}
    w = {k: pinned_copy(v) for k, v in w_dev.items()}
    act_host = sorted(torch.randperm(e, generator=torch.Generator().manual_seed(5))
                      [:QWEN3_ACTIVE].tolist())
    act = torch.tensor(act_host, device="cuda")
    counts = torch.zeros(e, dtype=torch.int32, device="cuda")
    counts[act] = 1
    valid = torch.zeros((1, e, 1), dtype=torch.bool, device="cuda")
    valid[0, act, 0] = True
    buf = torch.randn((1, e, 1, d), generator=gen, device="cuda").to(bf) * valid[..., None]
    x = buf.reshape(e, 1, d)

    def kernel():
        gate, up = torch.chunk(splitk_gemm_grouped(x, w["wi"], counts, window=window), 2, -1)
        return splitk_gemm_grouped(torch.nn.functional.silu(gate) * up, w["wdown"], counts,
                                   window=window)

    def plain():
        gate, up = torch.chunk(ref.splitk_gemm_grouped_ref(x, w_dev["wi"], counts), 2, -1)
        return ref.splitk_gemm_grouped_ref(torch.nn.functional.silu(gate) * up, w_dev["wdown"],
                                           counts)

    staged = {k: torch.empty((QWEN3_ACTIVE, *v.shape[1:]), dtype=bf, device="cuda")
              for k, v in w.items()}

    def library():
        for k in staged:
            for i, j in enumerate(act_host):
                staged[k][i].copy_(w[k][j], non_blocking=True)
        gate, up = torch.chunk(torch.bmm(x[act], staged["wi"]), 2, -1)
        return torch.bmm(torch.nn.functional.silu(gate) * up, staged["wdown"])

    def loop():
        return per_expert_ffn(buf, valid, w["wi"], w["wdown"], 0)

    want = plain()
    for label, got in (("kernel", kernel()), ("per-expert loop", loop()[0].reshape(e, 1, d)),
                       ("library", None)):
        if got is None:
            got = torch.zeros_like(want)
            got[act] = library()
        torch.cuda.synchronize()
        rel, _ = rel_err(got, want)
        check(rel < TOL[bf], f"grouped remote experts ({label}) at Qwen3 widths: max rel err "
                             f"{rel:.2e}")
    rounds = alternate([kernel, loop, library], flush)
    t_kernel, t_loop, t_lib = (statistics.median(v) for v in rounds)
    t_plain = time_ms(plain, flush=flush)
    rem_b = QWEN3_ACTIVE * (d * 2 * ff + ff * d) * 2
    loc_b = (x.numel() + e * 2 * ff + e * ff + e * d) * 2
    flops = QWEN3_ACTIVE * 2 * (d * 2 * ff + ff * d)
    b_ms, b_by = bound(loc_b, rem_b, flops, link, BF16_PEAK)
    gbs = lambda ms: rem_b / (ms * 1e-3) / 1e9  # noqa: E731
    print(f"  remote experts of one Qwen3-30B-A3B layer at decode ({QWEN3_ACTIVE} of {e} active, "
          f"M=1, {rem_b / 1e6:.2f} MB, wi + wdown), medians of {ROUNDS} alternating rounds: "
          f"splitk_gemm_grouped {t_kernel:.4f} ms ({gbs(t_kernel):.2f} GB/s, 2 launches) | "
          f"per-expert splitk_gemm loop {t_loop:.4f} ms ({gbs(t_loop):.2f} GB/s, "
          f"{2 * QWEN3_ACTIVE} launches and a count read) | plain {t_plain:.4f} ms | bound "
          f"{b_ms:.4f} ms ({b_by}) | copy active experts + bmm {t_lib:.4f} ms "
          f"({gbs(t_lib):.2f} GB/s)")
    t_bytes = max(loc_b / HBM_BW, rem_b / link)
    out = {"ms": t_kernel, "loop_ms": t_loop, "plain_ms": t_plain, "bound_ms": b_ms,
           "library_ms": t_lib, "t_bytes": t_bytes, "t_ops": flops / BF16_PEAK}
    out = {k: n_layers * v for k, v in out.items()}
    print(f"  per Qwen3 decode step ({n_layers} MoE layers): splitk_gemm_grouped {out['ms']:.3f} "
          f"ms (per-expert loop {out['loop_ms']:.3f}, copy + bmm {out['library_ms']:.3f}) vs "
          f"bound {out['bound_ms']:.3f} ms")
    time_grouped_prefill(w, w_dev, link, flush, gen, window)
    return out


GROUPED_PREFILL_M = (64, 192, 384)   # expert rows of Qwen3 prompts of ~683, 2048 and 4096 tokens
PREFILL_ROUNDS = 3                   # alternating rounds at these rows, 3 launches each


def time_grouped_prefill(w, w_dev, link, flush, gen, window) -> None:
    """One Qwen3-30B-A3B layer's remote experts at prefill (wi, then wdown,
    all 64 active) at the rows `GROUPED_PREFILL_M`: `splitk_gemm_grouped`
    (the cluster design), the split-K design it replaced (the wrapper's
    private launch path), every expert copied into HBM + `torch.bmm`, the
    plain version with both stacks in HBM, and the bound (each expert's
    bytes once over the link); the device counter's host bytes of both
    designs beside the tiling model (64 x the bytes an expert x the reads
    per expert)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_gemm import _launch_grouped, grouped_tiling, splitk_gemm_grouped

    bf, silu = torch.bfloat16, torch.nn.functional.silu
    e, d, ff = w["wi"].shape[0], w["wi"].shape[1], w["wdown"].shape[1]
    counts = torch.ones(e, dtype=torch.int32, device="cuda")
    staged = {k: torch.empty_like(v) for k, v in w_dev.items()}
    hb = splitk_gemm_grouped.host_bytes
    per_expert = (d * 2 * ff + ff * d) * 2
    rem_b = e * per_expert

    def ffn(gmm, x, ws):
        gate, up = torch.chunk(gmm(x, ws["wi"], counts), 2, -1)
        return gmm(silu(gate) * up, ws["wdown"], counts)

    def cluster(x):
        return ffn(lambda a, b, c: splitk_gemm_grouped(a, b, c, window=window), x, w)

    def split_k(x):
        return ffn(lambda a, b, c: _launch_grouped(a, b, c, window, "split-K"), x, w)

    def library(x):
        for k in staged:
            staged[k].copy_(w[k], non_blocking=True)
        gate, up = torch.chunk(torch.bmm(x, staged["wi"]), 2, -1)
        return torch.bmm(silu(gate) * up, staged["wdown"])

    for m in GROUPED_PREFILL_M:
        x = torch.randn((e, m, d), generator=gen, device="cuda").to(bf)
        want = ffn(ref.splitk_gemm_grouped_ref, x, w_dev)
        counted, model = {}, {}
        for label, fn in (("cluster", cluster), ("split-K", split_k), ("library", library)):
            hb.reset()
            got = fn(x)
            torch.cuda.synchronize()
            rel, _ = rel_err(got, want)
            check(rel < TOL[bf], f"Qwen3 remote experts at prefill M={m} ({label}): max rel err "
                                 f"{rel:.2e}")
            if label != "library":
                counted[label] = int(hb)
                model[label] = rem_b * grouped_tiling(m, bf, design=label).reads
        check(counted == model,
              f"host bytes counted at M={m}: cluster design {counted['cluster']} B, split-K "
              f"design {counted['split-K']} B; tiling model {e} experts x {per_expert} B x "
              f"reads = {model['cluster']} and {model['split-K']} B")
        rounds = alternate([lambda: cluster(x), lambda: split_k(x), lambda: library(x)], flush,
                           n_rounds=PREFILL_ROUNDS, iters=3)
        t_new, t_old, t_lib = (statistics.median(v) for v in rounds)
        t_plain = time_ms(lambda: ffn(ref.splitk_gemm_grouped_ref, x, w_dev), iters=3,
                          flush=flush)
        loc_b = (x.numel() + e * m * (2 * ff + ff + d)) * 2
        b_ms, b_by = bound(loc_b, rem_b, 2 * e * m * (d * 2 * ff + ff * d), link, BF16_PEAK)
        gbs = lambda ms: rem_b / (ms * 1e-3) / 1e9  # noqa: E731
        print(f"  remote experts of one Qwen3-30B-A3B layer at prefill M={m} (all {e} active, "
              f"{rem_b / 1e6:.2f} MB unique, wi + wdown), medians of {PREFILL_ROUNDS} "
              f"alternating rounds: splitk_gemm_grouped (cluster design) {t_new:.4f} ms "
              f"({gbs(t_new):.2f} GB/s unique, host bytes {counted['cluster']}) | split-K design "
              f"{t_old:.4f} ms ({gbs(t_old):.2f} GB/s unique, host bytes {counted['split-K']}) | "
              f"copy + bmm {t_lib:.4f} ms ({gbs(t_lib):.2f} GB/s) | plain {t_plain:.4f} ms | "
              f"bound {b_ms:.4f} ms ({b_by})")
        del x
    del staged


def per_step(t: dict, n_layers: int) -> dict:
    """A decode-attention kernel's per-launch times as per decode step (one
    launch per layer)."""
    return {k: n_layers * v for k, v in t.items()}


def host_ms(fn, iters=50) -> float:
    """Mean host time of one call of `fn` (what a served step pays per call
    before the card sees the launch), from the host clock around `iters`
    calls in a row."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return t * 1e3


def paged_timing_inputs(lens, mp, gen, h=32, kh=32, hd=128, alias_v=False):
    """Paged operands at B = len(lens), H = `h`, Kh = `kh`, `hd`, page 16,
    bf16, whose pools hold exactly the pages the slots use, each once (plus
    the sink): every page of the byte count is read from its tier once, and
    the library yardstick copies only the remote pages in use.  With
    `alias_v` the V pools are the K pools (MLA's latent pages): a page is K
    and V at once.  Returns q, the kernel's pools, their device copies,
    table, tier, lens, and the local and remote bytes of the pages in
    use."""
    b, ps = len(lens), 16
    rng = np.random.default_rng(b * 1000 + mp)
    tier = rng.integers(0, 2, size=(b, mp))
    used = np.arange(mp)[None, :] < np.asarray([-(-n // ps) for n in lens])[:, None]
    table = np.zeros((b, mp), np.int64)
    n_pages = {}
    for t in (0, 1):
        sel = used & (tier == t)
        n_pages[t] = int(sel.sum())
        table[sel] = rng.permutation(n_pages[t])

    def pool(p):
        return torch.randn((p + 1, ps, kh, hd), generator=gen, device="cuda").to(torch.bfloat16)

    pools_dev = {f"k_{name}": pool(n_pages[t]) for name, t in (("local", 0), ("remote", 1))}
    for name, t in (("local", 0), ("remote", 1)):
        pools_dev[f"v_{name}"] = pools_dev[f"k_{name}"] if alias_v else pool(n_pages[t])
    pools = {k: v for k, v in pools_dev.items() if k.endswith("local")}
    pools["k_remote"] = pinned_copy(pools_dev["k_remote"])
    pools["v_remote"] = pools["k_remote"] if alias_v else pinned_copy(pools_dev["v_remote"])
    q = torch.randn((b, h, hd), generator=gen, device="cuda").to(torch.bfloat16)
    as_dev = lambda a: torch.tensor(np.asarray(a, np.int32), device="cuda")  # noqa: E731
    page_bytes = ps * kh * hd * 2 * (1 if alias_v else 2)   # K (+ V) of one page, all kv heads
    return (q, pools, pools_dev, as_dev(table), as_dev(tier), as_dev(lens),
            n_pages[0] * page_bytes, n_pages[1] * page_bytes)


def attention_line(name, label, shape, t, t_wrap, t_host, t_plain, t_lib, b_ms, b_by, rem_b,
                   window) -> None:
    gbs = lambda ms: rem_b / (ms * 1e-3) / 1e9  # noqa: E731
    print(f"  {name} {label} {shape} bf16: kernel {t[window]:.4f} ms (device, the launch "
          f"alone; windows 1/2/4: {t[1]:.4f}/{t[2]:.4f}/{t[4]:.4f}), remote "
          f"{gbs(t[window]):.2f} GB/s | wrapper call {t_wrap:.4f} ms (events), host "
          f"{t_host:.4f} ms per call | plain {t_plain:.4f} ms | bound {b_ms:.4f} ms ({b_by}) | "
          f"library {t_lib:.4f} ms ({gbs(t_lib):.2f} GB/s) | remote bytes {rem_b}")


def paged_timing_case(lens, mp, gen, h=32, kh=32, hd=128, scale=None, alias_v=False):
    """The paged kernel's operands at `lens` (paged_timing_inputs), the
    plain version's output, and the prepared launch at windows 1, 2, 4."""
    from repro_torch.kernels.ref import paged_flashattn_ref
    from repro_torch.kernels.splitk_flashattn import _paged_launch

    q, pools, pools_dev, table, tier, lens_t, loc_b, rem_b = paged_timing_inputs(
        lens, mp, gen, h, kh, hd, alias_v)
    want = paged_flashattn_ref(q, pools_dev["k_local"], pools_dev["v_local"],
                               pools_dev["k_remote"], pools_dev["v_remote"], table, tier, lens_t,
                               scale=scale)
    prep = {w: _paged_launch(q, pools["k_local"], pools["v_local"], pools["k_remote"],
                             pools["v_remote"], table, tier, lens_t, w, scale)
            for w in (1, 2, 4)}
    return q, pools, pools_dev, table, tier, lens_t, loc_b, rem_b, want, prep


def time_paged_attention(label, lens, mp, link, flush, gen, window, h=32, kh=32, hd=128,
                         scale=None, alias_v=False) -> dict:
    """The paged kernel at B = len(lens), H = `h`, Kh = `kh`, `hd`, page 16,
    `lens`: device time of its launch alone (windows 1/2/4), the wrapper
    call, plain and library (remote pool copy + page gather + SDPA) times;
    per launch.  Where the wrapper takes the cluster design (bf16 above hd
    256), the head-group design it replaced is timed beside it, through the
    wrapper's private launch, in alternating rounds with the library call;
    each design's counted remote bytes (`paged_splitk_flashattn.host_bytes`)
    beside `paged_reads`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import paged_flashattn_ref
    from repro_torch.kernels.splitk_flashattn import (
        _launch_paged,
        _paged_launch,
        launch_design,
        paged_splitk_flashattn,
    )

    bf = torch.bfloat16
    q, pools, pools_dev, table, tier, lens_t, loc_b, rem_b, want, prep = paged_timing_case(
        lens, mp, gen, h, kh, hd, scale, alias_v)
    args = (q, pools["k_local"], pools["v_local"], pools["k_remote"], pools["v_remote"], table)
    design = launch_design(*args, window)
    designs = {design.name: prep}
    if design.name == "cluster":
        designs["head-group"] = {w: _paged_launch(*args, tier, lens_t, w, scale, "head-group")
                                 for w in (1, 2, 4)}
    lib = paged_prefetch_sdpa(q, pools, table, tier, lens_t, scale)
    hb = paged_splitk_flashattn.host_bytes
    counted, model = {}, {}
    for name, p in designs.items():
        hb.reset()
        got = _launch_paged(p[window])
        torch.cuda.synchronize()
        counted[name] = int(hb)
        model[name] = paged_model_bytes(launch_design(*args, window, None if name == design.name
                                                      else name),
                                        tier.cpu(), lens, 16, h, kh, hd, 2)
        rel, _ = rel_err(got, want)
        check(rel < TOL[bf] and counted[name] == model[name],
              f"paged attention {name} design {label}: max rel err {rel:.2e}, host bytes "
              f"counted {counted[name]} = model {model[name]}")
    rel, _ = rel_err(lib(), want)
    check(rel < TOL[bf], f"paged attention library yardstick {label}: max rel err {rel:.2e}")
    t = {w: time_ms(lambda w=w: _launch_paged(prep[w]), flush=flush) for w in (1, 2, 4)}

    def wrapper():
        return ops.paged_decode_attention(q, pools, table, tier, lens_t, window=window,
                                          scale=scale)

    t_wrap, t_host = time_ms(wrapper, flush=flush), host_ms(wrapper)
    t_plain = time_ms(lambda: paged_flashattn_ref(
        q, pools_dev["k_local"], pools_dev["v_local"], pools_dev["k_remote"],
        pools_dev["v_remote"], table, tier, lens_t, scale=scale), flush=flush)
    t_lib = time_ms(lib, flush=flush)
    loc_b += q.numel() * 2 * 2                      # q read, out written
    flops = 4 * sum(lens) * h * hd
    b_ms, b_by = bound(loc_b, rem_b, flops, link, BF16_PEAK)
    shape = (f"B={len(lens)} H={h} Kh={kh} hd={hd} page=16 lens={list(lens)} MP={mp}"
             f"{' V=K' if alias_v else ''}")
    attention_line("paged_attention", label, shape, t, t_wrap, t_host, t_plain, t_lib, b_ms,
                   b_by, rem_b, window)
    print(f"    {design.name} design (the wrapper's): {design.stages} stages at window "
          f"{window}, clusters of {design.cluster}, {design.heads_per_cta} heads a CTA; host "
          f"bytes counted a launch {counted[design.name]} = model {model[design.name]}, "
          f"{counted[design.name] / max(1, rem_b):.2f}x the remote pages in use")
    if "head-group" in designs and design.name != "head-group":
        old = designs["head-group"]
        t_old = {w: time_ms(lambda w=w: _launch_paged(old[w]), flush=flush) for w in (1, 2, 4)}
        rounds = alternate([lambda: _launch_paged(prep[window]),
                            lambda: _launch_paged(old[window]), lib], flush)
        new_ms, old_ms, lib_ms = (statistics.median(v) for v in rounds)
        wins = sum(a < b for a, b in zip(rounds[0], rounds[1]))
        print(f"    replaced head-group design: {t_old[window]:.4f} ms (windows 1/2/4: "
              f"{t_old[1]:.4f}/{t_old[2]:.4f}/{t_old[4]:.4f}), host bytes counted a launch "
              f"{counted['head-group']} = model {model['head-group']}, "
              f"{counted['head-group'] / max(1, rem_b):.2f}x the remote pages in use | window "
              f"{window}, medians of {ROUNDS} alternating rounds: cluster {new_ms:.4f} ms, "
              f"head-group {old_ms:.4f} ms ({old_ms / new_ms:.1f}x), library {lib_ms:.4f} ms; "
              f"cluster faster in {wins} | bound {b_ms:.4f} ms: cluster at "
              f"{new_ms / b_ms:.1f}x it")
        t[window], t_lib = new_ms, lib_ms
    del q, pools, pools_dev, prep, designs
    return dict(ms=t[window], wrapper_ms=t_wrap, host_ms=t_host, plain_ms=t_plain,
                bound_ms=b_ms, library_ms=t_lib, remote_bytes=rem_b,
                t_bytes=max(loc_b / HBM_BW, rem_b / link), t_ops=flops / BF16_PEAK)


def paged_prefetch_sdpa(q, pools, table, tier, lens, scale=None):
    """The library yardstick of paged attention: copy the remote page pool
    into HBM (one copy each for K and V, the whole pool; one when the V pool
    is the K pool), gather every slot's pages by its page table, then one
    scaled_dot_product_attention call with `scale` and a length mask.
    Returns the call to time."""
    import torch.nn.functional as F

    alias = pools["v_remote"] is pools["k_remote"] and pools["v_local"] is pools["k_local"]
    k_rem = torch.empty_like(pools["k_remote"], device="cuda")
    v_rem = k_rem if alias else torch.empty_like(pools["v_remote"], device="cuda")
    b, mp = table.shape
    ps, kh, hd = pools["k_local"].shape[1:]
    h = q.shape[1]
    idx = table.long()
    sel = (tier > 0)[..., None, None, None]
    mask = (torch.arange(mp * ps, device="cuda")[None, :] < lens[:, None].long())[:, None, None]

    def gather(local, remote):
        pages = torch.where(sel, remote[idx.clamp(max=remote.shape[0] - 1)],
                            local[idx.clamp(max=local.shape[0] - 1)])
        kv = pages.reshape(b, mp * ps, kh, hd).transpose(1, 2)
        if kh == 1:                                # one kv head under every query head
            return kv.expand(b, h, mp * ps, hd)
        return kv.repeat(1, h // kh, 1, 1)         # group-major: q head h reads h % Kh

    def run():
        k_rem.copy_(pools["k_remote"], non_blocking=True)
        if not alias:
            v_rem.copy_(pools["v_remote"], non_blocking=True)
        k = gather(pools["k_local"], k_rem)
        v = k if alias else gather(pools["v_local"], v_rem)
        return F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=mask,
                                              scale=scale)[:, :, 0]

    return run


def batch_split_timing_case(s_len, kv_len, gen):
    """The batch-split kernel's operands at 2 local + 2 remote requests,
    H = Kh = 32, hd 128, cache S = `s_len` (batch_split_inputs), the plain
    version's output, and the prepared launch at windows 1, 2, 4."""
    from repro_torch.kernels.ref import splitk_flashattn_ref
    from repro_torch.kernels.splitk_flashattn import _batch_split_launch

    q, cache, dev = batch_split_inputs(2, 2, 32, 32, 128, s_len, torch.bfloat16, gen)
    want = splitk_flashattn_ref(q, dev["k_local"], dev["v_local"], dev["k_remote"],
                                dev["v_remote"], kv_len)
    prep = {w: _batch_split_launch(q, cache["k_local"], cache["v_local"], cache["k_remote"],
                                   cache["v_remote"], kv_len, w) for w in (1, 2, 4)}
    return q, cache, dev, want, prep


def time_splitk_attention(label, s_len, kv_len, link, flush, gen, window) -> dict:
    """The batch-split kernel at 2 local + 2 remote requests, H = Kh = 32,
    hd 128, cache S = `s_len`, `kv_len` positions: device time of its launch
    alone (windows 1/2/4), the wrapper call, plain and library (prefetch +
    SDPA) times; per launch."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import splitk_flashattn_ref
    from repro_torch.kernels.splitk_flashattn import _launch_batch_split

    bf = torch.bfloat16
    b_loc = b_rem = 2
    h = kh = 32
    hd = 128
    q, cache, dev, want, prep = batch_split_timing_case(s_len, kv_len, gen)
    # library yardstick: copy the remote requests' rows into HBM beside the
    # local ones, then one scaled_dot_product_attention call
    kbuf = torch.cat([dev["k_local"], torch.empty_like(dev["k_remote"])])
    vbuf = torch.cat([dev["v_local"], torch.empty_like(dev["v_remote"])])

    def prefetch_sdpa():
        for r in range(b_rem):
            kbuf[b_loc + r, :kv_len].copy_(cache["k_remote"][r, :kv_len], non_blocking=True)
            vbuf[b_loc + r, :kv_len].copy_(cache["v_remote"][r, :kv_len], non_blocking=True)
        return F.scaled_dot_product_attention(q[:, :, None], kbuf[:, :kv_len].transpose(1, 2),
                                              vbuf[:, :kv_len].transpose(1, 2))[:, :, 0]

    for design, got in (("kernel", _launch_batch_split(prep[window])),
                        ("library yardstick", prefetch_sdpa())):
        rel, _ = rel_err(got, want)
        check(rel < TOL[bf], f"splitk_flashattn {design} {label}: max rel err {rel:.2e}")
    t = {w: time_ms(lambda w=w: _launch_batch_split(prep[w]), flush=flush) for w in (1, 2, 4)}

    def wrapper():
        return ops.tiered_decode_attention(q, cache, kv_len=kv_len, window=window)

    t_wrap, t_host = time_ms(wrapper, flush=flush), host_ms(wrapper)
    t_plain = time_ms(lambda: splitk_flashattn_ref(q, dev["k_local"], dev["v_local"],
                                                   dev["k_remote"], dev["v_remote"], kv_len),
                      flush=flush)
    t_lib = time_ms(prefetch_sdpa, flush=flush)
    row = kh * hd * 2 * 2                                   # K + V of one position, bf16
    loc_b = q.numel() * 2 * 2 + b_loc * kv_len * row
    rem_b = b_rem * kv_len * row
    flops = 4 * (b_loc + b_rem) * kv_len * h * hd
    b_ms, b_by = bound(loc_b, rem_b, flops, link, BF16_PEAK)
    attention_line("splitk_flashattn", label, f"B={b_loc}|{b_rem} H={h} Kh={kh} hd={hd} "
                   f"S={s_len} kv_len={kv_len}", t, t_wrap, t_host, t_plain, t_lib, b_ms, b_by,
                   rem_b, window)
    del q, cache, dev, kbuf, vbuf, prep
    return dict(ms=t[window], wrapper_ms=t_wrap, host_ms=t_host, plain_ms=t_plain,
                bound_ms=b_ms, library_ms=t_lib, remote_bytes=rem_b,
                t_bytes=max(loc_b / HBM_BW, rem_b / link), t_ops=flops / BF16_PEAK)


def time_flash_prefill(flush, gen) -> dict:
    """flash_prefill in bf16 at `PREFILL_TIMING`'s shapes: each bf16 design
    (`flash_prefill.BF16_DESIGNS`, newest first; the older through the
    private `_launch`), the plain version and SDPA (``is_causal``,
    ``enable_gqa`` under GQA; the port never calls it) in `ROUNDS`
    alternating rounds, medians printed with the bound.  The shape
    `PREFILL_REPORTED` is the one the kernels line reports."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import flash_prefill_ref

    FP = importlib.import_module("repro_torch.kernels.flash_prefill")
    out = {}
    for b, h, kh, t_len, hd, causal in PREFILL_TIMING:
        q = torch.randn((b, h, t_len, hd), generator=gen, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((b, kh, t_len, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        args = (q, k, v)
        calls = [lambda a=args, d=d: FP._launch(*a, causal, d) for d in FP.BF16_DESIGNS]
        calls.append(lambda a=args: flash_prefill_ref(*a, causal))
        calls.append(lambda a=args: F.scaled_dot_product_attention(
            *a, is_causal=causal, enable_gqa=kh != h))
        want = flash_prefill_ref(*args, causal)
        for d, call in zip(FP.BF16_DESIGNS, calls):
            rel, _ = row_rel_err(call(), want)
            check(rel < TOL[torch.bfloat16], f"flash_prefill {d} design B={b} H={h} Kh={kh} "
                                             f"T={t_len} hd={hd}: max rel err per query row "
                                             f"{rel:.2e}")
        del want
        rounds = alternate(calls, flush)
        med = [statistics.median(r) for r in rounds]
        nbytes = 2 * (q.numel() + 2 * k.numel() + q.numel())   # q, k, v read, out written once
        pairs = t_len * (t_len + 1) // 2 if causal else t_len * t_len   # key s <= query t
        flops = 4 * b * h * pairs * hd
        t_bytes, t_ops = nbytes / HBM_BW, flops / BF16_PEAK
        b_ms = max(t_bytes, t_ops) * 1e3
        designs = " | ".join(f"{d} {m:.4f} ms ({flops / (m * 1e-3) / 1e12:.2f} TFLOP/s)"
                             for d, m in zip(FP.BF16_DESIGNS, med))
        wins = sum(x < y for x, y in zip(rounds[0], rounds[1])) if len(rounds) > 3 else 0
        print(f"  flash_prefill B={b} H={h} Kh={kh} T={t_len} hd={hd} "
              f"{'causal' if causal else 'full'} bf16: {designs} | plain {med[-2]:.4f} ms | "
              f"SDPA {med[-1]:.4f} ms ({flops / (med[-1] * 1e-3) / 1e12:.2f} TFLOP/s) | bound "
              f"{b_ms:.4f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}) | "
              f"{FP.BF16_DESIGNS[0]} faster than {FP.BF16_DESIGNS[-1]} in {wins} of "
              f"{len(rounds[0])} rounds")
        if (b, h, kh, t_len, hd, causal) == PREFILL_REPORTED:
            out = dict(ms=med[0], replaced_ms=med[1] if len(med) > 3 else None,
                       plain_ms=med[-2], bound_ms=b_ms, library_ms=med[-1], t_bytes=t_bytes,
                       t_ops=t_ops)
        del q, k, v, args, calls
    return out


# ---------------------------------------------------------------------------
# Phase 6: batch-split token parity on the card (fp32, full width, 2 layers)
# ---------------------------------------------------------------------------
def batch_split_setup(cfg, batch, max_len, dtype, seed):
    """Random weights from `seed`, planned at offload 0.5 and partitioned
    (remote tiers pinned).  Returns (unsplit params, tiered params, window)."""
    from repro_torch.core import engine as offload_engine
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = M.init_params(cfg, gen, dtype=dtype, device="cuda")
    plan = offload_engine.plan(cfg, WorkloadSpec(batch=batch, seq_len=max_len, phase="decode"),
                               H100_SXM, global_ratio=0.5)
    tparams = plan.partition(params, align=128, place_remote=True)
    return params, tparams, plan.window.n_inflight


def batch_split_generate(cfg, tparams, prompts, max_len, new_tokens, window, steps_out=None):
    """Prefill through the tiered kernel matmul, split the cache by batch
    (half the requests remote), then greedy batch-split decode steps.
    Returns the tokens [B, new_tokens] and the split cache."""
    from repro_torch.models import model as M
    from repro_torch.serving import tiered_decode as TD

    logits, cache = M.prefill(cfg, tparams, {"tokens": prompts}, max_len=max_len,
                              mm=TD.kernel_mm(window))
    kv = TD.split_cache_batch(cache, 0.5)
    del cache
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok.cpu()]
    t_len = prompts.shape[1]
    for i in range(new_tokens - 1):
        t0 = time.time()
        logits, kv = TD.tiered_decode_step(cfg, tparams, kv, tok[:, None], t_len + i,
                                           window=window)
        tok = torch.argmax(logits[:, 0], dim=-1)
        out.append(tok.cpu())                      # the host needs each step's tokens
        if steps_out is not None:
            steps_out.append(time.time() - t0)
    return torch.stack(out, dim=1), kv


def phase_batch_split_parity() -> None:
    import repro_torch.configs as C
    from repro_torch.models import model as M

    cfg = dataclasses.replace(C.get("llama2_7b"), n_layers=2)
    b, t_len, max_len, new_tokens = DECODE_BATCH, 16, 32, 9
    params, tparams, window = batch_split_setup(cfg, b, max_len, torch.float32, seed=11)
    rng = np.random.default_rng(11)
    prompts = torch.tensor(rng.integers(3, cfg.vocab, (b, t_len)).astype(np.int32),
                           device="cuda")
    got, kv = batch_split_generate(cfg, tparams, prompts, max_len, new_tokens, window)
    check(kv["k_local"].shape[1] == b // 2 and kv["k_remote"].shape[1] == b // 2
          and kv["k_remote"].is_pinned(),
          f"cache split {kv['k_local'].shape[1]} local | {kv['k_remote'].shape[1]} remote "
          f"(pinned host) requests")
    logits, cache = M.prefill(cfg, params, {"tokens": prompts}, max_len=max_len)
    tok = torch.argmax(logits[:, -1], dim=-1)
    want, gaps = [tok.cpu()], [torch.topk(logits[:, -1].float(), 2).values.diff().abs().min()]
    for i in range(new_tokens - 1):
        logits, cache = M.decode_step(cfg, params, cache, tok[:, None], t_len + i)
        tok = torch.argmax(logits[:, 0], dim=-1)
        want.append(tok.cpu())
        gaps.append(torch.topk(logits[:, 0].float(), 2).values.diff().abs().min())
    want = torch.stack(want, dim=1)
    for r in range(b):
        check(torch.equal(got[r], want[r]),
              f"batch-split request {r} ({'remote' if r >= b // 2 else 'local'} cache): "
              f"{got[r].tolist()} vs plain decode_step {want[r].tolist()}")
    print(f"  smallest top-2 logit gap on the plain path: {float(min(gaps)):.3e} "
          f"({new_tokens - 1} decode steps)")


# ---------------------------------------------------------------------------
# Phase 7: the batch-split served run (full llama2-7b, bf16, offload 0.5)
# ---------------------------------------------------------------------------
def phase_batch_split_serve() -> dict:
    import repro_torch.configs as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.splitk_flashattn import scatter_rows, splitk_flashattn
    from repro_torch.kernels.splitk_gemm import splitk_gemm
    from repro_torch.runtime.telemetry import weight_tier_bytes

    cfg = C.get("llama2_7b")
    b, t_len, max_len, new_tokens = DECODE_BATCH, SPLIT_PROMPT_LEN, 512, 32
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    params, tparams, window = batch_split_setup(cfg, b, max_len, torch.bfloat16, seed=0)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"batch-split run set-up (weights drawn, partitioned, remote tier pinned): "
          f"{time.time() - t0:.1f} s; window {window}")
    leaves = list(remote_leaves(tparams))
    w_local, w_remote = weight_tier_bytes(tparams)
    rng = np.random.default_rng(1)
    prompts = torch.tensor(rng.integers(3, cfg.vocab, (b, t_len)).astype(np.int32),
                           device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    splitk_gemm.launches = splitk_flashattn.launches = scatter_rows.launches = 0
    steps: list[float] = []
    t0 = time.time()
    toks, kv = batch_split_generate(cfg, tparams, prompts, max_len, new_tokens, window, steps)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"splitk_gemm": splitk_gemm.launches,
                "splitk_flashattn": splitk_flashattn.launches,
                "scatter_rows": scatter_rows.launches}
    peak = torch.cuda.max_memory_allocated()
    n_steps = len(steps)
    tpot = sum(steps) / n_steps
    host = _build.load().libs["host_mem"]
    kv_pinned = all(kv[k].device.type == "cpu" and kv[k].is_pinned()
                    and host.dak_check_mapped(kv[k].data_ptr()) == 0
                    for k in ("k_remote", "v_remote"))
    kv_local = kv["k_local"].nbytes + kv["v_local"].nbytes
    kv_remote = kv["k_remote"].nbytes + kv["v_remote"].nbytes
    total_w = w_local + w_remote
    print(f"served {b} requests ({t_len} prompt + {new_tokens} new tokens each, batch-split "
          f"cache, S={max_len}) in {wall:.2f} s | {b * new_tokens / wall:.2f} tokens/s | TPOT "
          f"{tpot * 1e3:.1f} ms over {n_steps} decode steps (median "
          f"{statistics.median(steps) * 1e3:.1f} ms)")
    print(f"launches during the batch-split run: {launches} "
          f"({launches['splitk_flashattn'] / n_steps:.2f} splitk_flashattn per decode step)")
    print(f"kv cache: {kv_local} B local ({kv_local / 1e9:.3f} GB) + {kv_remote} B remote "
          f"({kv_remote / 1e9:.3f} GB, pinned host) | weights {w_local / 1e9:.3f} GB local + "
          f"{w_remote / 1e9:.3f} GB remote | peak device memory {peak} ({peak / 1e9:.3f} GB) "
          f"vs total weights {total_w / 1e9:.3f} GB")
    check(toks.shape == (b, new_tokens) and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"every request emitted {new_tokens} tokens in [0, vocab)")
    check(launches["splitk_flashattn"] == cfg.n_layers * n_steps,
          f"splitk_flashattn launched exactly {cfg.n_layers} times per decode step")
    check(launches["splitk_gemm"] > 0 and launches["scatter_rows"] > 0,
          "the tiered GEMM and the remote-row writer launched on the batch-split path")
    check(kv_pinned and all(leaf.remote.is_pinned() and leaf.remote.device.type == "cpu"
                            for leaf in leaves) and len(leaves) == 6,
          "remote KV rows and all 6 remote weight tiers are pinned, mapped host memory")
    check(peak < total_w, "peak device memory below the model's total weight bytes")
    return {"launches": launches, "tpot_ms": tpot * 1e3}


# ---------------------------------------------------------------------------
# Phase 8: flash_prefill through its entry point at llama2-7b prefill shape
# ---------------------------------------------------------------------------
def phase_flash_prefill() -> dict:
    from repro_torch.kernels import flash_prefill

    b, h, t_len, hd, n_layers = DECODE_BATCH, 32, 256, 128, 32
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((b, h, t_len, hd), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    flash_prefill.launches = 0
    by_design = flash_prefill.launches_by_design
    by_design.update(dict.fromkeys(by_design, 0))
    outs_ok = True
    for _ in range(n_layers):
        o = flash_prefill(q, k, v, causal=True)
        outs_ok = outs_ok and o.shape == q.shape and bool(torch.isfinite(o.float()).all())
    torch.cuda.synchronize()
    launches = flash_prefill.launches
    check(outs_ok and launches == n_layers and by_design["wgmma"] == n_layers,
          f"flash_prefill B={b} H=Kh={h} T={t_len} hd={hd} causal bf16, once per layer: "
          f"{launches} launches ({by_design}), outputs finite and [B, H, T, hd]")
    return {"launches": {"flash_prefill": launches}}


# ---------------------------------------------------------------------------
# Phase 9: how fast kernels read pinned host memory (printed lines only)
# ---------------------------------------------------------------------------
PROBE_FORMS = ("cp.async 16 B", "bulk 1-D", "TMA 2-D")
PROBE_CTAS = (32, 66, 132, 264, 528)
PROBE_INFLIGHT_KB = (4, 16, 64)
PROBE_ROW_BYTES = (128, 256, 512)


def phase_probe(card: dict) -> float:
    """Read a 64 MiB pinned, mapped host buffer (a [16384, 4096 B] matrix:
    the shape of a remote tier of K rows by 2048 bf16 columns) with the
    read-only probe kernel, sweeping copy form, CTAs, bytes in flight per CTA
    and the width of each contiguous row read; each rate beside the copy
    engine's on the same buffer.  Returns the best kernel rate, GB/s."""
    from repro_torch.kernels import _build

    lib = _build.load_measurement().libs["host_probe"]
    rows, pitch = 16384, 4096
    nbytes = rows * pitch
    dev = torch.randint(0, 256, (rows, pitch), dtype=torch.uint8, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(9))
    buf = pinned_copy(dev)
    want = int((dev.view(torch.int32).long() & 0xFFFFFFFF).sum())
    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    t_ce = time_ms(lambda: dev.copy_(buf, non_blocking=True), iters=5, flush=scratch.zero_)
    ce = nbytes / (t_ce * 1e-3) / 1e9
    print(f"host-link read probe on {card['name']} (power limit {card['power']}): 64 MiB "
          f"pinned host buffer; copy engine (cudaMemcpyAsync to HBM) {ce:.2f} GB/s; kernel "
          f"rates in GB/s, 4-stage ring per CTA, median of 3, L2 flushed")
    checksum = torch.zeros(1, dtype=torch.int64, device="cuda")
    stream = _build.stream_handle(torch.device("cuda"))
    best = {}
    for form, form_name in enumerate(PROBE_FORMS):
        for row_b in PROBE_ROW_BYTES:
            cells = []
            for ctas in PROBE_CTAS:
                rates = []
                for kb in PROBE_INFLIGHT_KB:
                    stage = kb * 1024 // 4

                    def run(form=form, ctas=ctas, row_b=row_b, stage=stage):
                        _build.check(lib.dak_host_read_probe(
                            buf.data_ptr(), rows, pitch, form, ctas, row_b, stage, 0,
                            checksum.data_ptr(), stream), f"host probe ({form_name})")

                    checksum.zero_()
                    run()
                    torch.cuda.synchronize()
                    got = int(checksum.item()) % 2**64
                    check(got == want % 2**64, f"probe {form_name} row {row_b} B, {ctas} CTAs, "
                                               f"{kb} KB in flight read every byte")
                    rate = nbytes / (time_ms(run, iters=3, flush=scratch.zero_) * 1e-3) / 1e9
                    rates.append(rate)
                    if rate > best.get(form_name, (0.0,))[0]:
                        best[form_name] = (rate, row_b, ctas, kb)
                cells.append(f"{ctas} CTAs " + "/".join(f"{r:.1f}" for r in rates))
            print(f"  {form_name:13s} row {row_b:3d} B | in flight {'/'.join(map(str, PROBE_INFLIGHT_KB))}"
                  f" KB per CTA: " + " | ".join(cells))
    for form_name, (rate, row_b, ctas, kb) in best.items():
        print(f"  best {form_name}: {rate:.2f} GB/s ({rate / ce:.2f}x the copy engine) at row "
              f"{row_b} B, {ctas} CTAs, {kb} KB in flight per CTA")
    cap = max(rate for rate, *_ in best.values())
    # do kernel reads and the copy engine share one limit? Both at once, on
    # two streams, each over its own 64 MiB buffer
    buf2, dev2 = pinned_copy(dev), torch.empty_like(dev)
    side = torch.cuda.Stream()
    rate, row_b, ctas, kb = best[PROBE_FORMS[2]]
    form, stage = 2, kb * 1024 // 4

    def both():
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dev2.copy_(buf2, non_blocking=True)
        _build.check(lib.dak_host_read_probe(buf.data_ptr(), rows, pitch, form, ctas, row_b, stage,
                                             0, checksum.data_ptr(), stream), "host probe")
        torch.cuda.current_stream().wait_stream(side)

    t_both = time_ms(both, iters=5, flush=scratch.zero_)
    print(f"  TMA kernel ({ctas} CTAs, {kb} KB in flight, row {row_b} B) and copy engine at once: "
          f"{2 * nbytes / (t_both * 1e-3) / 1e9:.2f} GB/s together over {t_both:.3f} ms "
          f"(alone: {rate:.2f} and {ce:.2f} GB/s)")
    del buf, dev, buf2, dev2
    # access order: all CTAs down the rows together (as whole-K tiles read)
    # or one contiguous run of rows each (as the pieces of a K split read),
    # on this buffer and on one of 1 GiB, too large for any host cache
    for size_rows in (rows, 16 * rows):
        dev = torch.randint(0, 256, (size_rows, pitch), dtype=torch.uint8, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(9))
        buf = pinned_copy(dev)
        want = int((dev.view(torch.int32).long() & 0xFFFFFFFF).sum()) % 2**64
        size = size_rows * pitch
        t_ce = time_ms(lambda: dev.copy_(buf, non_blocking=True), iters=3, flush=scratch.zero_)
        cells = []
        for form in (0, 2):
            for contiguous in (0, 1):
                def run(form=form, contiguous=contiguous):
                    _build.check(lib.dak_host_read_probe(
                        buf.data_ptr(), size_rows, pitch, form, 264, 512, 16 * 1024 // 4,
                        contiguous, checksum.data_ptr(), stream), "host probe")

                checksum.zero_()
                run()
                torch.cuda.synchronize()
                check(int(checksum.item()) % 2**64 == want,
                      f"probe {PROBE_FORMS[form]} {'contiguous' if contiguous else 'round robin'} "
                      f"{size >> 20} MiB read every byte")
                r = size / (time_ms(run, iters=3, flush=scratch.zero_) * 1e-3) / 1e9
                cells.append(f"{PROBE_FORMS[form]} {'runs per CTA' if contiguous else 'rows together'}"
                             f" {r:.2f}")
        print(f"  {size >> 20} MiB, 264 CTAs, 16 KB in flight, row 512 B: " + " | ".join(cells)
              + f" | copy engine {size / (t_ce * 1e-3) / 1e9:.2f} GB/s")
        del dev, buf
    del scratch
    return cap


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# Phases 22-26: the serving frontend, the encoder and the VLM
# ---------------------------------------------------------------------------
FRONTEND_PARITY = (("llama2_7b", 2, False), ("qwen3_moe_30b_a3b", 2, True),
                   ("deepseek_v2_236b", 1, True), ("mamba2_370m", 2, False),
                   ("zamba2_2p7b", ZAMBA2_PARITY_LAYERS, False))
BURST = {"batch": (8, 0, 384, 512), "interactive": (4, 2, 64, 128)}  # n, priority, prompt lens
BURST_NEW_TOKENS = 16
SLO_CHUNK = 128             # phase 23's prefill chunk (tokens a step)
HUBERT_CLIPS, HUBERT_FRAMES = 4, 500     # phase 24: 10 s clips at HuBERT's 50 frames/s
VLM_PATCHES, VLM_TEXT = 576, 128         # phase 26: one image's patches, then the text
LLAVA_PEAK_LIMIT = 40e9     # device bytes LLaVA-NeXT-34B may peak at (70.6 GB of bf16 weights)


def dense_prefill_model(params, rows: int, top_rows: int = 1,
                        k_split: int | None = None) -> tuple[int, list[int]]:
    """Remote weight bytes that one pass of `rows` rows reads through
    `splitk_gemm`, by the tiling model (`splitk_gemm.gemm_tiling`): each
    column-split layer weight's remote tier once per cluster of M tiles in
    the wrapper's design (`k_split` 0: the whole-K design, once per M tile),
    the top-level ones (lm_head) as `top_rows` rows read them (a decoder's
    prefill runs lm_head on its last row alone).  Returns the bytes and the
    reads of the layer weights."""
    from repro_torch.core.tiering import TieredTensor
    from repro_torch.kernels.splitk_gemm import gemm_tiling

    def reads(w, m):
        return gemm_tiling(m, w.local.shape[-2], w.local.shape[-1], w.remote.shape[-1],
                           w.remote.dtype, sm_count=sm_count(), k_split=k_split).reads

    layer = [w for w in params["layers"].values()
             if isinstance(w, TieredTensor) and w.axis == -1 and w.remote.numel()]
    top = [w for w in params.values() if isinstance(w, TieredTensor) and w.remote.numel()]
    total = (sum(w.remote.nbytes * reads(w, rows) for w in layer)
             + sum(w.remote.nbytes * reads(w, top_rows) for w in top))
    return total, sorted({reads(w, rows) for w in layer})


def count_prefill_passes(eng) -> list[tuple[int, int]]:
    """Wrap `eng`'s prefill pass so that each appends (rows, the remote bytes
    `splitk_gemm.host_bytes` counted during it) to the list returned."""
    from repro_torch.kernels.splitk_gemm import splitk_gemm

    passes, run = [], eng._run_prefill_chunk

    def counted(slot, ps, n):
        before = int(splitk_gemm.host_bytes)
        run(slot, ps, n)
        passes.append((n, int(splitk_gemm.host_bytes) - before))

    eng._run_prefill_chunk = counted
    return passes


def column_split_remote(params) -> tuple[int, int]:
    """Remote bytes of the column-split layer weights and of the top-level
    ones (lm_head): one full read of each."""
    from repro_torch.core.tiering import TieredTensor

    layer = sum(w.remote.nbytes for w in params["layers"].values()
                if isinstance(w, TieredTensor) and w.axis == -1)
    top = sum(w.remote.nbytes for w in params.values() if isinstance(w, TieredTensor))
    return layer, top


def phase_frontend_parity() -> None:
    """Phase 3's check for every decoder family with the SLO scheduler,
    chunks of 4 prompt tokens and mixed priorities, then the
    priority-preemption case."""
    for arch, n_layers, dropless in FRONTEND_PARITY:
        print(f"  {arch}, {n_layers} layers{', dropless' if dropless else ''}:")
        phase_parity(arch, n_layers, dropless, frontend=True)
        gc.collect()
        torch.cuda.empty_cache()
    phase_preemption_parity()


def phase_preemption_parity() -> None:
    """tests/test_frontend.py's priority-preemption case at full width (2
    layers of llama2-7b, fp32, offload 0.7, page 4, 3 slots): two
    low-priority prompts fill the local pool, a high-priority arrival after
    one step demotes their pages into the pinned pool, and every request,
    the victims included, emits the plain reference's tokens."""
    import repro_torch.configs as C
    from repro_torch.frontend.metrics import ModeledClock
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(C.get("llama2_7b"), n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                           dtype=torch.float32, device="cuda")
    eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.7,
                        page_size=4, scheduler="priority", clock=ModeledClock(), device="cuda")
    rng = np.random.default_rng(41)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=10, priority=5 if i == 2 else 0)
            for i, n in enumerate((16, 14, 12))]
    eng.submit(reqs[0])
    eng.submit(reqs[1])
    eng.step()
    eng.submit(reqs[2])                         # the high-priority arrival
    stats = eng.run()
    check(stats.served == 3 and stats.preemptions >= 1 and stats.preempt_demoted_pages >= 1,
          f"priority preemption: served {stats.served}/3, {stats.preemptions} preemptions "
          f"demoted {stats.preempt_demoted_pages} pages into the pinned pool "
          f"(per request {[r.preemptions for r in reqs]})")
    for r in reqs:
        want, gaps = reference_tokens(cfg, params, torch.tensor(r.prompt, device="cuda"), 10, 32)
        check(r.out_tokens == want,
              f"request {r.rid} (priority {r.priority}, preempted {r.preemptions}x): engine "
              f"{r.out_tokens} vs reference {want} (smallest top-2 gap {min(gaps):.3e})")


def burst_requests(cfg, rng) -> tuple[list, list]:
    """Phase 23's burst: 8 batch requests (priority 0, prompts of 384-512
    tokens), then 4 interactive ones (priority 2, 64-128 tokens)."""
    from repro_torch.serving.engine import Request

    out, rid = {}, 0
    for cls, (n, prio, lo, hi) in BURST.items():
        out[cls] = []
        for _ in range(n):
            plen = int(rng.integers(lo, hi + 1))
            out[cls].append(Request(rid=rid, prompt=rng.integers(3, cfg.vocab, plen)
                                    .astype(np.int32), max_new_tokens=BURST_NEW_TOKENS,
                                    cls=cls, priority=prio))
            rid += 1
    return out["batch"], out["interactive"]


def phase_frontend_serve() -> None:
    """llama2-7b (32 layers, bf16, offload 0.5, page 16, 4 slots) serves a
    burst on the wall clock twice: FCFS with whole prompts, then the SLO
    scheduler with chunks of `SLO_CHUNK` tokens.  All 12 requests arrive at
    t=0 in both runs, the 8 batch ones first.  One engine serves both runs
    (it is idle between them, each run with a fresh scheduler and stats).
    The remote weight bytes of prefill are counted on the device
    (`splitk_gemm.host_bytes`, read around each pass) beside the tiling
    model of the passes' rows (`dense_prefill_model`: the column-split layer
    weights once per cluster of M tiles, the split lm_head once, on the last
    row)."""
    import repro_torch.configs as C
    from repro_torch.frontend.scheduler import get_scheduler
    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineStats, ServingEngine

    cfg = C.get("llama2_7b")
    max_len = BURST["batch"][3] + BURST_NEW_TOKENS
    eng = ServingEngine(cfg, M.layer_source(cfg, torch.Generator(device="cuda").manual_seed(0),
                                            dtype=torch.bfloat16, device="cuda"),
                        max_batch=DECODE_BATCH, max_len=max_len, global_offload_ratio=0.5,
                        page_size=16, device="cuda")
    layer_rem, top_rem = column_split_remote(eng.params)
    print(f"  kv pages {eng.plan.kv_pages.local_pages} local + {eng.plan.kv_pages.remote_pages} "
          f"remote of {BURST_NEW_TOKENS + BURST['batch'][3]}-token slots; remote weights "
          f"{layer_rem / 1e9:.3f} GB in the layers + {top_rem / 1e9:.3f} GB lm_head")
    tokens = {}
    counted_passes = count_prefill_passes(eng)
    for name, chunk in (("fcfs", None), ("slo", SLO_CHUNK)):
        counted_passes.clear()
        eng.scheduler = get_scheduler(name, **({"chunk_tokens": chunk} if chunk else {}))
        eng.stats = EngineStats()
        batch, inter = burst_requests(cfg, np.random.default_rng(0))
        torch.cuda.synchronize()
        t0 = time.time()
        for r in batch + inter:
            eng.submit(r)
        stats = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        tokens[name] = {r.rid: r.out_tokens for r in batch + inter}
        passes = stats.prefill_passes
        models = [dense_prefill_model(eng.params, n) for n in passes]
        read = sum(b for b, _ in models)
        counted = sum(c for _, c in counted_passes)
        rep = stats.slo_report()
        print(f"  {name}{f' (chunk {chunk})' if chunk else ' (whole prompts)'}: served "
              f"{stats.served}/12 in {wall:.2f} s | "
              f"TPOT {stats.tpot * 1e3:.1f} ms over {stats.decode_steps} decode steps | prefill "
              f"{stats.prefill_time:.2f} s in {len(passes)} passes of {sum(passes)} tokens | "
              f"prefill_chunks {stats.prefill_chunks} | preemptions {stats.preemptions} "
              f"({stats.preempt_demoted_pages} pages demoted) | spills {stats.spills}")
        for cls, r in rep.items():
            print(f"    {cls}: n={r['requests']} wall TTFT p50 {r['ttft_p50'] * 1e3:.1f} ms "
                  f"p95 {r['ttft_p95'] * 1e3:.1f} ms | queue p95 "
                  f"{r['queue_delay_p95'] * 1e3:.1f} ms | preemptions {r['preemptions']}")
        print(f"    remote weight bytes of prefill, counted on the device: {counted} B "
              f"({counted / 1e9:.3f} GB), {counted / max(1, sum(passes)) / 1e6:.3f} MB per "
              f"prefill token; tiling model of the passes' rows {read} B (the layers' tiles read "
              f"{sorted({r for _, rs in models for r in rs})} times a pass)")
        check(counted == read and [n for n, _ in counted_passes] == passes,
              f"{name}: prefill's remote bytes counted {counted} = tiling model {read} over "
              f"{len(passes)} passes")
        check(stats.served == 12 and all(len(t) == BURST_NEW_TOKENS
                                         for t in tokens[name].values()),
              f"{name}: every request served with {BURST_NEW_TOKENS} tokens")
        if name == "slo":
            check(stats.prefill_chunks > 0,
                  f"slo: prompts split ({stats.prefill_chunks} chunks)")
    same = sum(tokens["fcfs"][rid] == tokens["slo"][rid] for rid in tokens["fcfs"])
    print(f"  requests whose tokens agree between the runs: {same}/12 ({same / 12:.0%}; bf16 "
          f"chunked and whole-prompt attention reduce in different orders)")


def phase_encoder() -> None:
    """HuBERT-XLarge: a 2-layer full-width fp32 forward tiered at offload
    0.5 (every projection through `splitk_gemm`) against the same weights
    unsplit in HBM; then all 48 layers in bf16 at offload 0.5 through
    `launch.steps.make_prefill_step` on 4 clips of 500 frames."""
    import repro_torch.configs as C
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import engine as E
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import _build
    from repro_torch.kernels.splitk_gemm import splitk_gemm
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.runtime.telemetry import weight_tier_bytes
    from repro_torch.serving import tiered_decode as TD

    shape = ShapeConfig("hubert_10s", HUBERT_FRAMES, HUBERT_CLIPS, "prefill")
    wl = WorkloadSpec(batch=HUBERT_CLIPS, seq_len=HUBERT_FRAMES, phase="prefill")
    cfg = dataclasses.replace(C.get("hubert_xlarge"), n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(7), device="cuda")
    plan = E.plan(cfg, wl, H100_SXM, global_ratio=0.5)
    tiered = plan.partition_source(M.LayerSource.from_tree(params), align=128)
    batch = steps.input_specs(cfg, shape, torch.Generator(device="cuda").manual_seed(1),
                              dtype=torch.float32, device="cuda")
    n0 = splitk_gemm.launches
    got, cache = steps.make_prefill_step(cfg, mm=TD.kernel_mm(1))(tiered, batch)
    want = M.forward(cfg, params, batch)
    rel, ab = rel_err(got, want)
    check(cache == {} and rel < TOL[torch.float32] and splitk_gemm.launches - n0 == 11,
          f"2-layer fp32 encoder forward on {HUBERT_CLIPS} x {HUBERT_FRAMES} frames tiered at 0.5 "
          f"({splitk_gemm.launches - n0} splitk_gemm launches) vs unsplit in HBM: rel {rel:.3e} "
          f"(abs {ab:.3e}) < 2e-4")
    del params, tiered, got, want
    gc.collect()
    torch.cuda.empty_cache()

    cfg = C.get("hubert_xlarge")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    plan = E.plan(cfg, wl, H100_SXM, global_ratio=0.5)
    params = plan.partition_source(M.layer_source(cfg, torch.Generator(device="cuda")
                                                  .manual_seed(0), dtype=torch.bfloat16,
                                                  device="cuda"), align=128)
    torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated()
    w_local, w_remote = weight_tier_bytes(params)
    pinned = _build.pinned_bytes()
    layer_rem, top_rem = column_split_remote(params)
    print(f"  48 layers built one at a time in {time.time() - t0:.1f} s: weights "
          f"{w_local / 1e9:.3f} GB local + {w_remote / 1e9:.3f} GB remote, pinned host bytes "
          f"{pinned} ({pinned / 1e9:.3f} GB), set-up peak {(setup_peak - base) / 1e9:.3f} GB")
    check(pinned == int(w_remote) and layer_rem + top_rem == int(w_remote),
          "pinned host bytes are the remote weight tiers, every one column-split")
    batch = steps.input_specs(cfg, shape, torch.Generator(device="cuda").manual_seed(1),
                              dtype=torch.bfloat16, device="cuda")
    step = steps.make_prefill_step(cfg, mm=TD.kernel_mm(1))
    torch.cuda.reset_peak_memory_stats()
    splitk_gemm.host_bytes.reset()
    logits, _ = step(params, batch)             # warm-up, its remote bytes counted
    torch.cuda.synchronize()
    counted = int(splitk_gemm.host_bytes)
    times, n0 = [], splitk_gemm.launches
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits, _ = step(params, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    per_fwd = (splitk_gemm.launches - n0) / 3
    peak = torch.cuda.max_memory_allocated() - base
    ms = statistics.median(times)
    rows = HUBERT_CLIPS * HUBERT_FRAMES
    model, reads = dense_prefill_model(params, rows, top_rows=rows)
    whole_k, _ = dense_prefill_model(params, rows, top_rows=rows, k_split=0)
    print(f"  forward of {HUBERT_CLIPS} x {HUBERT_FRAMES} frames: median {ms:.2f} ms over 3 "
          f"(runs {', '.join(f'{t:.2f}' for t in times)}), "
          f"{rows * 1e3 / ms:.0f} frames/s | splitk_gemm {per_fwd:.0f} launches a forward | "
          f"remote bytes once {w_remote / 1e9:.3f} GB, counted on the device a forward "
          f"{counted} B ({counted / 1e9:.3f} GB; tiling model {model} B, {reads} read(s) of "
          f"{rows} rows; the whole-K design's tiling {whole_k / 1e9:.3f} GB), "
          f"{counted / (ms * 1e-3) / 1e9:.1f} GB/s if the forward were only that read | "
          f"peak device memory {peak / 1e9:.3f} GB vs weights {(w_local + w_remote) / 1e9:.3f} "
          f"GB")
    check(counted == model, f"encoder forward: remote bytes counted {counted} = tiling model "
                            f"{model}")
    check(tuple(logits.shape) == (HUBERT_CLIPS, HUBERT_FRAMES, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "encoder logits finite, [4, 500, 504]")
    check(per_fwd == cfg.n_layers * 5 + 1,
          f"splitk_gemm launched {per_fwd:.0f} = 48 layers x 5 + lm_head times a forward")
    check(peak < w_local + w_remote,
          "peak device memory below the weights (the remote tier never came into HBM)")
    # the same weights unsplit in HBM (1.89 GB), through the plain forward
    whole = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          dtype=torch.bfloat16, device="cuda")
    want = M.forward(cfg, whole, batch)
    rel, ab = rel_err(logits, want)
    check(rel < TOL[torch.bfloat16],
          f"48-layer bf16 forward tiered at 0.5 vs the same weights unsplit in HBM: rel "
          f"{rel:.3e} (abs {ab:.3e}) < {TOL[torch.bfloat16]:.0e}")


def phase_vlm_parity() -> None:
    """LLaVA-NeXT-34B at full width, 2 layers, fp32: phase 3's token check
    (offload 0.5, page 4), then a prefill of `VLM_PATCHES` patches and 16
    tokens through `launch.steps.make_prefill_step` tiered at offload 0.5
    against the prefill over the same weights unsplit in HBM."""
    import repro_torch.configs as C
    from repro_torch.core import engine as E
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.serving import tiered_decode as TD

    phase_parity("llava_next_34b", n_layers=2)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(C.get("llava_next_34b"), n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(7), device="cuda")
    plan = E.plan(cfg, WorkloadSpec(batch=1, seq_len=VLM_PATCHES + 16, phase="prefill"),
                  H100_SXM, global_ratio=0.5)
    tiered = plan.partition_source(M.LayerSource.from_tree(params), align=128)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = {"tokens": torch.randint(3, cfg.vocab, (1, 16), generator=gen, device="cuda"),
             "patches": torch.randn((1, VLM_PATCHES, M.VISION_EMBED_DIM), generator=gen,
                                    device="cuda")}
    got, gcache = steps.make_prefill_step(cfg, mm=TD.kernel_mm(1))(tiered, batch)
    want, wcache = steps.make_prefill_step(cfg)(params, batch)
    rel, ab = rel_err(got, want)
    crel = max(rel_err(gcache[k], wcache[k])[0] for k in ("k", "v"))
    check(rel < TOL[torch.float32] and crel < TOL[torch.float32]
          and tuple(gcache["k"].shape[2:3]) == (VLM_PATCHES + 16,),
          f"prefill of {VLM_PATCHES} patches + 16 tokens tiered at 0.5 vs unsplit: logits rel "
          f"{rel:.3e} (abs {ab:.3e}), cache rel {crel:.3e}, both < 2e-4")


def vlm_patch_prefill(eng) -> None:
    """After phase 26's served run: one prefill of `VLM_PATCHES` patches and
    `VLM_TEXT` tokens through `launch.steps.make_prefill_step` over the
    served engine's tiered weights."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.splitk_gemm import splitk_gemm
    from repro_torch.launch import steps
    from repro_torch.serving import tiered_decode as TD

    cfg = eng.cfg
    batch = steps.input_specs(cfg, ShapeConfig("llava_image", 2 * VLM_PATCHES, 1, "prefill"),
                              torch.Generator(device="cuda").manual_seed(3),
                              dtype=torch.bfloat16, device="cuda")
    batch["tokens"] = batch["tokens"][:, :VLM_TEXT]
    rows = VLM_PATCHES + VLM_TEXT
    layer_rem, top_rem = column_split_remote(eng.params)
    step = steps.make_prefill_step(cfg, mm=TD.kernel_mm(eng.window))
    torch.cuda.synchronize()
    splitk_gemm.host_bytes.reset()
    n0, t0 = splitk_gemm.launches, time.time()
    logits, cache = step(eng.params, batch)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3
    counted = int(splitk_gemm.host_bytes)
    read, reads = dense_prefill_model(eng.params, rows)
    whole_k, _ = dense_prefill_model(eng.params, rows, k_split=0)
    print(f"  prefill of {VLM_PATCHES} patches + {VLM_TEXT} tokens: {ms:.1f} ms, "
          f"{splitk_gemm.launches - n0} splitk_gemm launches, remote weight bytes counted on "
          f"the device {counted} B ({counted / 1e9:.3f} GB; tiling model {read} B: "
          f"{layer_rem / 1e9:.3f} GB of layers read {reads} time(s) + lm_head "
          f"{top_rem / 1e9:.3f} once; the whole-K design's tiling {whole_k / 1e9:.3f} GB), "
          f"{counted / (ms * 1e-3) / 1e9:.1f} GB/s if the prefill were only that read; "
          f"peak device memory since serving began {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB")
    check(counted == read, f"patch prefill: remote bytes counted {counted} = tiling model {read}")
    check(tuple(logits.shape) == (1, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
          and tuple(cache["k"].shape[:3]) == (cfg.n_layers, 1, rows),
          f"patch prefill logits finite and the cache holds {rows} positions")


# ---------------------------------------------------------------------------
# Phases 27-28: the adaptive runtime and elastic degradation
# ---------------------------------------------------------------------------
ELASTIC_SHRINK = (2, 0.2)   # at decode step 2, keep 20% of the local page pool
ATTN_MAX_WINDOW = 8         # csrc/dak_common.cuh DAK_MAX_WINDOW: the attention ring's cap
ATTN_RING_MAX = 96 * 1024   # csrc/decode_attn.cuh RING_MAX: ring bytes a CTA


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def elastic_view(eng) -> dict:
    """The counters, health ladder and ratio a run must reproduce."""
    s = eng.stats
    view = {k: getattr(s, k) for k in (
        "served", "failed_requests", "health", "cache_full_caught", "elastic_demoted_pages",
        "remote_grown_pages", "shed_steps", "elastic_replans", "replans", "promoted_pages",
        "demoted_pages", "final_window", "decode_steps")}
    view["shrink_events"] = eng.health.counters.shrink_events
    view["transitions"] = [tuple(t) for t in eng.health.transitions]
    view["global_ratio"] = (eng.runtime.plan.global_ratio if eng.runtime is not None
                            else eng.plan.global_ratio)
    return view


def elastic_parity_runs(cfg, params, device: str) -> dict:
    """Phase 27's four runs on `device`: {name: (tokens, view)}; the
    zero-budget runtime is tests/test_elastic.py's, at the engine's
    alignment (the card's TMA boxes need 16-byte rows)."""
    from repro_torch.core import engine as offload_engine
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.runtime.controller import RuntimeController
    from repro_torch.serving.engine import Request, ServingEngine

    plan = offload_engine.plan(cfg, WorkloadSpec(batch=3, seq_len=32, phase="decode"), H100_SXM,
                               global_ratio=0.5, kv_page_size=4)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab, n).astype(np.int32) for n in (10, 16, 7, 14, 9)]
    out = {}
    for name in ("static", "adaptive", "shrink", "adaptive+shrink"):
        runtime = (RuntimeController(cfg, plan, H100_SXM, window_budget=0, migration_budget=0,
                                     drift_threshold=float("inf"), align=128)
                   if name == "adaptive+shrink" else None)
        eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.5,
                            page_size=4, adaptive=name == "adaptive", runtime=runtime,
                            device=device)
        check(eng._align == 128, f"engine alignment {eng._align} is the runtime's 128")
        if name.endswith("shrink"):
            eng.schedule_hbm_shrink(*ELASTIC_SHRINK)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out[name] = ([r.out_tokens for r in reqs], elastic_view(eng))
        del eng
        gc.collect()
    return out


def phase_elastic_parity() -> None:
    """llama2-7b at full width, 2 layers, fp32, offload 0.5, page 4, 3
    slots, phase 3's five prompts: a static run, `adaptive=True`, a static
    run with `schedule_hbm_shrink(2, 0.2)` and the zero-budget runtime with
    the same shrink, each on the card and on the CPU from the same weights.
    On the card every run's tokens equal the static run's; each run's
    counters, health ladder and final ratio equal the CPU run's."""
    import repro_torch.configs as C
    from repro_torch.models import model as M

    cfg = dataclasses.replace(C.get("llama2_7b"), n_layers=2)
    cpu_params = M.init_params(cfg, torch.Generator().manual_seed(7), dtype=torch.float32,
                               device="cpu")
    params = tree_to(cpu_params, "cuda")
    t0 = time.time()
    card = elastic_parity_runs(cfg, params, "cuda")
    t_card = time.time() - t0
    cpu = elastic_parity_runs(cfg, cpu_params, "cpu")
    print(f"  4 runs on the card in {t_card:.1f} s, on the CPU in {time.time() - t0 - t_card:.1f} s")
    gaps = []
    rng = np.random.default_rng(7)
    for n in (10, 16, 7, 14, 9):
        prompt = torch.tensor(rng.integers(3, cfg.vocab, n).astype(np.int32), device="cuda")
        gaps += reference_tokens(cfg, params, prompt, 8, 32)[1]
    want = card["static"][0]
    for name, (tokens, view) in card.items():
        cpu_tokens, cpu_view = cpu[name]
        print(f"  {name}: {json.dumps(view)}")
        check(tokens == want,
              f"{name}: the card's tokens equal the static run's (smallest top-2 logit gap "
              f"{min(gaps):.3e}; the CPU run's tokens agree with the card's for "
              f"{sum(a == b for a, b in zip(tokens, cpu_tokens))}/5 requests)")
        check(view == cpu_view, f"{name}: counters, health ladder and final ratio equal the CPU "
                                f"run's" + ("" if view == cpu_view else f" (CPU {cpu_view})"))
        check(view["served"] == 5 and view["failed_requests"] == 0
              and view["health"] == "healthy",
              f"{name}: served {view['served']}/5, {view['failed_requests']} failed, ends "
              f"{view['health']}")
        if name.endswith("shrink"):
            check(view["shrink_events"] == 1
                  and view["elastic_demoted_pages"] + view["remote_grown_pages"] > 0,
                  f"{name}: the shrink bit ({view['elastic_demoted_pages']} pages demoted, "
                  f"{view['remote_grown_pages']} grown)")
    view = card["adaptive+shrink"][1]
    check(view["elastic_replans"] >= 1 and view["global_ratio"] > 0.5,
          f"adaptive+shrink re-planned {view['elastic_replans']}x to ratio "
          f"{view['global_ratio']:.4f}")


def kernel_stages(eng, window: int) -> dict:
    """The ring depths the kernels run at `window` on the served shapes
    (the clamps of the CUDA launchers): paged attention keeps min(window, 8)
    + 1 stages within RING_MAX and the pages a slot holds; the split-K
    decode GEMM min(window, its loads a CTA) for each column-split weight
    (its shared-memory cap, 40 stages, is never reached here)."""
    from repro_torch.core.tiering import TieredTensor
    from repro_torch.kernels.splitk_gemm import DECODE_BK, decode_k_split

    pc = eng.pcache
    k_pool = pc.pools["k_local"]
    box = -(-pc.page_size * k_pool.shape[-1] * k_pool.element_size() // 128) * 128
    out = {"paged_attention": max(1, min(min(window, ATTN_MAX_WINDOW) + 1,
                                         ATTN_RING_MAX // (2 * box), pc.max_pages))}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key, w in list(eng.params["layers"].items()) + [("lm_head", eng.params.get("lm_head"))]:
        if isinstance(w, TieredTensor) and w.axis == -1:
            k = w.local.shape[-2]
            k_split = decode_k_split(w.local.shape[-1], w.remote.shape[-1], k, sms)
            out[f"splitk_gemm[{key}]"] = min(window, -(-min(k_split, k) // DECODE_BK))
    return out


def replan_probe(eng, probes: list) -> None:
    """Wrap the runtime's forced re-plan to record, for each call, its device
    memory (before, peak), pinned bytes, the bytes of the operands it
    rewrites and how long it paused the step."""
    from repro_torch.core.tiering import TieredTensor
    from repro_torch.kernels import _build
    from repro_torch.models.registry import resolve

    inner = eng.runtime.elastic_replan

    def local(w) -> int:
        return w.local.nbytes if isinstance(w, TieredTensor) else w.nbytes

    def total(w) -> int:
        return w.local.nbytes + w.remote.nbytes if isinstance(w, TieredTensor) else w.nbytes

    def probed(frac, params):
        torch.cuda.synchronize()
        before, pinned = torch.cuda.memory_allocated(), _build.pinned_bytes()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        out = inner(frac, params)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        changed = [od for od in eng.plan.registry
                   if resolve(out, od.path) is not resolve(params, od.path)]
        old = [resolve(params, od.path) for od in changed]
        new = [resolve(out, od.path) for od in changed]
        probes.append(dict(
            ratio=eng.runtime.plan.global_ratio, seconds=seconds, before=before, peak=torch.cuda.max_memory_allocated(),
            pinned_before=pinned, pinned_during=_build.pinned_bytes(),
            changed=[od.path_str for od in changed],
            old_local=sum(local(w) for w in old), new_local=sum(local(w) for w in new),
            # one slice of a layer stack, or a whole top-level leaf (lm_head)
            largest_layer=max([total(w) // (w.shape[0] if len(od.path) > 1 else 1)
                               for od, w in zip(changed, old)] + [0])))
        return out

    eng.runtime.elastic_replan = probed


def phase_elastic_serve() -> None:
    """Phase 4's traffic (llama2-7b, 32 layers, bf16, offload 0.5, FCFS, 4
    slots, page 16, 8 requests of 128 + 32 tokens) three times: (a) static;
    (b) the adaptive runtime closed over each decode step's bandwidth, timed
    by CUDA events (`runtime.telemetry.CudaEventSource`); (c) the same
    runtime with `schedule_hbm_shrink(2, 0.2)`, whose forced re-plan moves
    weight columns out of HBM into new pinned tiers.  Each engine is built
    layer by layer from the same seed."""
    import repro_torch.configs as C
    from repro_torch.core import congestion
    from repro_torch.core import engine as offload_engine
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.runtime.controller import RuntimeController
    from repro_torch.runtime.telemetry import CudaEventSource, weight_tier_bytes
    from repro_torch.serving.engine import Request, ServingEngine

    cfg, new_tokens, n_req = C.get("llama2_7b"), 32, 8
    max_len = PREFILL_LEN + new_tokens
    plan = offload_engine.plan(cfg, WorkloadSpec(batch=DECODE_BATCH, seq_len=max_len,
                                                 phase="decode"),
                               H100_SXM, global_ratio=0.5, kv_page_size=16)
    tokens, tpot = {}, {}
    for case in ("static", "adaptive", "shrink"):
        runtime = None
        if case != "static":
            prior = congestion.ModelSource(congestion.CongestionModel(H100_SXM),
                                           plan.window.n_streams, plan.window.chunk_bytes)
            runtime = RuntimeController(cfg, plan, H100_SXM, align=128,
                                        source=CudaEventSource(prior, "cuda"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        eng = ServingEngine(cfg, M.layer_source(cfg, gen, dtype=torch.bfloat16, device="cuda"),
                            max_batch=DECODE_BATCH, max_len=max_len, global_offload_ratio=0.5,
                            page_size=16, runtime=runtime, device="cuda")
        check(eng._align == 128, f"engine alignment {eng._align} is the runtime's 128")
        probes: list[dict] = []
        if case == "shrink":
            eng.schedule_hbm_shrink(*ELASTIC_SHRINK)
            replan_probe(eng, probes)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, PREFILL_LEN).astype(np.int32),
                        max_new_tokens=new_tokens) for i in range(n_req)]
        for r in reqs:
            eng.submit(r)
        src = runtime.source if runtime is not None else None
        steps = []
        torch.cuda.synchronize()
        around = []                            # (device bytes before, after, pinned after) a re-plan step
        t0 = time.time()
        while eng.scheduler.waiting or any(r is not None for r in eng.active):
            rec = {"window": runtime.window if runtime is not None else eng.window,
                   "decode_s": eng.stats.decode_time, "admitted": len(eng.stats.ttfts),
                   "replans": eng.stats.elastic_replans}
            timed = src.timed_steps if src is not None else 0
            mem = torch.cuda.memory_allocated()
            eng.step()
            rec["decode_ms"] = (eng.stats.decode_time - rec.pop("decode_s")) * 1e3
            rec["admitted"] = len(eng.stats.ttfts) > rec["admitted"]
            rec["replanned"] = eng.stats.elastic_replans > rec.pop("replans")
            if rec["replanned"]:
                torch.cuda.synchronize()
                around.append((mem, torch.cuda.memory_allocated(), _build.pinned_bytes()))
            if src is not None and src.timed_steps > timed:
                rec.update(device_ms=src.last_seconds * 1e3, host_gbs=src.last.host_bw / 1e9,
                           hbm_gbs=src.last.hbm_bw / 1e9, remote_gb=src.last_bytes[1] / 1e9)
            steps.append(rec)
        wall = time.time() - t0
        stats = eng.stats
        tokens[case], tpot[case] = [r.out_tokens for r in reqs], stats.tpot * 1e3
        agree = sum(a == b for a, b in zip(tokens[case], tokens["static"]))
        print(f"  ({case}) served {stats.served}/{n_req} in {wall:.2f} s | TPOT {tpot[case]:.1f} ms "
              f"over {stats.decode_steps} decode steps (static {tpot['static']:.1f}) | tokens of "
              f"{agree}/{n_req} requests equal the static run's (bf16)")
        check(stats.served == n_req and stats.failed_requests == 0
              and all(len(r.out_tokens) == new_tokens for r in reqs),
              f"({case}) served {stats.served}/{n_req}, {stats.failed_requests} failed, every "
              f"request emitted {new_tokens} tokens")
        if runtime is not None:
            rep = runtime.report()
            timed_steps = [s for s in steps if "host_gbs" in s]
            by_window: dict[int, list] = {}
            for s in timed_steps:
                by_window.setdefault(s["window"], []).append(s)
            print(f"  ({case}) window: static seed {rep['window']['static']}, min "
                  f"{rep['window']['min']}, max {rep['window']['max']}, final "
                  f"{rep['window']['final']}, converged {rep['window']['converged']}; trajectory "
                  f"{[s['window'] for s in steps]}; {src.timed_steps} steps timed, "
                  f"{src.prior_answers} measurements answered by the model before the first")
            for w, ss in sorted(by_window.items()):
                print(f"    window {w}: {len(ss)} steps, remote "
                      f"{statistics.mean(s['host_gbs'] for s in ss):.2f} GB/s, local "
                      f"{statistics.mean(s['hbm_gbs'] for s in ss):.2f} GB/s, device "
                      f"{statistics.mean(s['device_ms'] for s in ss):.1f} ms a step; kernel "
                      f"stages {kernel_stages(eng, w)}")
            print(f"  ({case}) re-plans {stats.replans} (forced {stats.elastic_replans}); "
                  f"migration: {stats.promoted_pages} pages promoted, {stats.demoted_pages} "
                  f"demoted (each move waits for the stream); final ratio "
                  f"{runtime.plan.global_ratio:.4f}")
            check(bool(timed_steps) and all(s["host_gbs"] > 0 and s["hbm_gbs"] > 0
                                            for s in timed_steps),
                  f"({case}) the CUDA-event source timed {len(timed_steps)} decode steps, each "
                  f"with a positive bandwidth per tier")
        if case == "shrink":
            h = eng.health
            print(f"  (shrink) health: {json.dumps(elastic_view(eng))}")
            check(h.counters.shrink_events == 1
                  and stats.elastic_demoted_pages + stats.remote_grown_pages > 0
                  and stats.elastic_replans >= 1 and runtime.plan.global_ratio > 0.5
                  and stats.health == "healthy",
                  f"(shrink) 1 shrink, {stats.elastic_demoted_pages} pages demoted + "
                  f"{stats.remote_grown_pages} grown, {stats.elastic_replans} forced re-plans to "
                  f"ratio {runtime.plan.global_ratio:.4f}, ends {stats.health}")
            check(len(around) == len(probes),
                  f"(shrink) one forced re-plan a step ({len(probes)} re-plans in "
                  f"{len(around)} steps)")
            pure = [(i, s) for i, s in enumerate(steps) if not s["admitted"] and s["decode_ms"] > 0]
            marks = [i for i, s in enumerate(steps) if s["replanned"]] + [len(steps)]
            mean = lambda ss, key: statistics.mean(s[key] for s in ss) if ss else float("nan")  # noqa: E731
            first = [s for i, s in pure if i < marks[0]]
            print(f"  (shrink) decode steps that admitted nothing before the first re-plan: "
                  f"{len(first)} at TPOT {mean(first, 'decode_ms'):.1f} ms, "
                  f"{mean(first, 'remote_gb'):.3f} GB remote a step")
            for n, (probe, (mem0, mem1, pinned1)) in enumerate(zip(probes, around)):
                span = [s for i, s in pure if marks[n] < i < marks[n + 1]]
                moved = probe["old_local"] - probe["new_local"]
                transient = probe["peak"] - probe["before"] - probe["new_local"]
                slack = (len(probe["changed"]) * 2 + 2) << 20
                print(f"  (shrink) forced re-plan {n + 1} at engine step {marks[n] + 1}, to ratio "
                      f"{probe['ratio']:.4f}: rewrote {len(probe['changed'])} operands "
                      f"{probe['changed']} in {probe['seconds'] * 1e3:.1f} ms (the step's pause); "
                      f"then {len(span)} decode steps that admitted nothing at TPOT "
                      f"{mean(span, 'decode_ms'):.1f} ms, {mean(span, 'remote_gb'):.3f} GB remote "
                      f"a step")
                print(f"  (shrink)   device memory {mem0} before the step, {mem1} after "
                      f"({(mem1 - mem0) / 1e9:+.3f} GB; local bytes moved to the host "
                      f"{moved / 1e9:.3f} GB); pinned bytes {probe['pinned_before']} before, "
                      f"{probe['pinned_during']} while both trees lived, {pinned1} after "
                      f"({(pinned1 - probe['pinned_before']) / 1e9:+.3f} GB)")
                if probe["changed"]:
                    check(mem1 < mem0 and pinned1 > probe["pinned_before"],
                          f"(shrink) re-plan {n + 1}: device memory fell by "
                          f"{(mem0 - mem1) / 1e9:.3f} GB and pinned bytes rose by "
                          f"{(pinned1 - probe['pinned_before']) / 1e9:.3f} GB")
                check(transient < probe["largest_layer"] + slack,
                      f"(shrink) re-plan {n + 1} held beyond the new local tiers it keeps "
                      f"{transient / 1e6:.1f} MB (peak {probe['peak'] / 1e9:.3f} - before "
                      f"{probe['before'] / 1e9:.3f} - new local {probe['new_local'] / 1e9:.3f} GB), "
                      f"below the largest operand layer it rewrites, "
                      f"{probe['largest_layer'] / 1e6:.1f} MB (+ {slack >> 20} MiB allocator "
                      f"rounding)")
            check(bool(probes) and bool(probes[0]["changed"]),
                  f"(shrink) the first forced re-plan rewrote operands "
                  f"({probes[0]['changed'] if probes else 'none ran'})")
            w_local, w_remote = weight_tier_bytes(eng.params)
            print(f"  (shrink) weights now {w_local / 1e9:.3f} GB local + {w_remote / 1e9:.3f} GB "
                  f"remote")
        del eng, runtime, src
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 29: the compiled decode step (one CUDA graph per bucket)
# ---------------------------------------------------------------------------
COMPILED_PARITY = (("llama2_7b", 2), ("mamba2_370m", 2),
                   ("zamba2_2p7b", ZAMBA2_PARITY_LAYERS), ("llava_next_34b", 2))
# (arch, layers or None for all): llama2-7b at 16 of its 32 layers since the
# training phase (33) joined the default run; figures before it are at 32
COMPILED_SERVED = (("llama2_7b", 16), ("mamba2_370m", None))


def launch_counts() -> dict:
    from repro_torch.serving.compiled_step import LAUNCH_COUNTERS

    return {c.__name__: c.launches for c in LAUNCH_COUNTERS}


def reset_launch_counts() -> None:
    from repro_torch.serving.compiled_step import LAUNCH_COUNTERS

    for c in LAUNCH_COUNTERS:
        c.launches = 0


def serve_counting(eng, reqs) -> list[dict]:
    """Serve `reqs` one engine step at a time; returns each step's launches
    per kernel wrapper."""
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.scheduler.waiting or eng.prefilling or any(r is not None for r in eng.active):
        before = launch_counts()
        eng.step()
        steps.append({k: v - before[k] for k, v in launch_counts().items()})
    return steps


def phase_compiled_parity() -> None:
    """Fp32 at full width and cut depth (offload 0.5, page 4, 3 slots, phase
    3's prompts): every family's graphed engine emits exactly its eager
    engine's tokens and the plain per-request reference's, and launches each
    kernel exactly as often, step by step (replays add what the capture
    recorded)."""
    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine

    for arch, n_layers in COMPILED_PARITY:
        cfg = dataclasses.replace(C.get(arch), n_layers=n_layers)
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                               dtype=torch.float32, device="cuda")
        rng = np.random.default_rng(7)
        prompts = [rng.integers(3, cfg.vocab, n).astype(np.int32) for n in (10, 16, 7, 14, 9)]
        runs = {}
        for jit in (False, True):
            reset_launch_counts()
            eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.5,
                                page_size=4, jit_step=jit, device="cuda")
            reqs = [Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
            per_step = serve_counting(eng, reqs)
            runs[jit] = ([r.out_tokens for r in reqs], per_step, eng.compile_count,
                         eng.compile_cache_hits, eng.recaptures, eng.stats.decode_steps)
            del eng
            gc.collect()
        (eager, eager_steps, *_), (graphed, graph_steps, count, hits, recap, steps) = \
            runs[False], runs[True]
        want = [reference_tokens(cfg, params, torch.tensor(p, device="cuda"), 8, 32)[0]
                for p in prompts]
        check(graphed == eager == want,
              f"{arch} ({n_layers} layers, fp32): graphed tokens equal eager and the plain "
              f"reference's for {len(want)} requests ({sum(map(len, want))} tokens)")
        check(graph_steps == eager_steps and count >= 1 and count + hits == steps
              and recap == 0 and runs[False][2] == 0,
              f"{arch}: launches per engine step equal eager's in all {len(graph_steps)} steps "
              f"({sum(s['splitk_gemm'] for s in graph_steps)} splitk_gemm, "
              f"{sum(s['paged_splitk_flashattn'] for s in graph_steps)} paged attention, "
              f"{sum(s['scatter_rows'] for s in graph_steps)} row scatters); {count} bucket(s), "
              f"{hits} cache hits over {steps} decode steps, no recapture; the eager engine "
              f"compiled nothing")
        del params
        gc.collect()
        torch.cuda.empty_cache()


def fresh_serving_state(eng) -> None:
    """Give a served engine back the cache state of a fresh one (empty
    pools and tables, zeroed recurrent state, new stats), keeping its
    partitioned weights."""
    from repro_torch.serving.engine import EngineStats

    eng._drop_graphs()                     # they hold the old pools' addresses
    if eng.pcache is not None:
        eng.pcache = None
        gc.collect()
        eng.pcache = eng._make_pcache()
    if eng.cache is not None:
        for c in eng.cache.values():
            c.zero_()
    eng._next_tok[:] = 0
    eng.stats = EngineStats()
    eng.stats.final_window = eng.window


def phase_compiled_serve() -> None:
    """Phase 4's traffic (bf16, full width at the depths of `COMPILED_SERVED`,
    offload 0.5, page 16, 4 slots, 8 requests of 128 + 32 tokens) served eagerly and then graphed on
    the same weights (one engine, its cache state reset in between): tokens
    equal exactly (the same kernels run in the same order), TPOT, the
    profiler's device-busy share and host time a step of each, the capture
    time of each bucket and the graph pool's bytes."""
    import repro_torch.configs as C
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine

    new_tokens = 32
    for arch, n_layers in COMPILED_SERVED:
        cfg = C.get(arch)
        depth = f"{cfg.n_layers} layers"
        if n_layers is not None:
            depth = f"{n_layers} of {cfg.n_layers} layers"
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        t0 = time.time()
        eng = ServingEngine(
            cfg, M.layer_source(cfg, torch.Generator(device="cuda").manual_seed(0),
                                dtype=torch.bfloat16, device="cuda"),
            max_batch=DECODE_BATCH, max_len=PREFILL_LEN + new_tokens, global_offload_ratio=0.5,
            page_size=16, jit_step=False, device="cuda")
        print(f"{arch} ({depth}, bf16): engine built in {time.time() - t0:.1f} s")
        out = {}
        for mode in ("eager", "graphed"):
            if mode == "graphed":
                fresh_serving_state(eng)
                eng._jit = True
            rng = np.random.default_rng(0)
            reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, PREFILL_LEN).astype(np.int32),
                            max_new_tokens=new_tokens) for i in range(8)]
            reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            per_step = serve_counting(eng, reqs)
            torch.cuda.synchronize()
            wall = time.time() - t0
            st = eng.stats
            served, steps, tpot, tps = (st.served, st.decode_steps, st.tpot * 1e3,
                                        st.generated_tokens / wall)
            peak = torch.cuda.max_memory_allocated()
            prof = profile_decode_steps(eng, cfg, rng, PREFILL_LEN)
            out[mode] = {"tokens": [r.out_tokens for r in reqs], "steps": per_step,
                         "tpot": tpot, "prof": prof}
            host = (f"host time a step {prof['traced_ms'] - prof['busy_ms']:.2f} ms"
                    if prof else "host time not measured")
            print(f"  {mode}: served {served}/8 in {wall:.2f} s | TPOT {tpot:.2f} ms over {steps} "
                  f"decode steps | {tps:.2f} tokens/s | peak device memory {peak / 1e9:.3f} GB | "
                  f"profiler: " + (f"traced step {prof['traced_ms']:.2f} ms, device busy "
                                   f"{prof['busy_ms']:.2f} ms ({prof['busy_share']:.1%}), "
                                   if prof else "") + host)
        for key, g in eng._compiled.items():
            print(f"  bucket {key[:2]}: captured {g.captures}x, last capture (warm-up "
                  f"included) {g.capture_s * 1e3:.1f} ms, graph pool grew {g.pool_bytes} bytes")
        e, g = out["eager"], out["graphed"]
        check(g["tokens"] == e["tokens"] and all(len(t) == new_tokens for t in g["tokens"]),
              f"{arch} bf16: graphed tokens equal eager tokens exactly for all 8 requests")
        check(g["steps"] == e["steps"] and eng.compile_count >= 1,
              f"{arch} bf16: launches per engine step under replay equal eager's "
              f"({len(g['steps'])} steps, {eng.compile_count} bucket(s), "
              f"{eng.compile_cache_hits} hits, {eng.recaptures} recaptures)")
        print(f"  {arch}: TPOT eager {e['tpot']:.2f} ms -> graphed {g['tpot']:.2f} ms "
              f"({e['tpot'] / g['tpot']:.2f}x)")
        del eng
        gc.collect()
        torch.cuda.empty_cache()

# ---------------------------------------------------------------------------
# Phase 30: the measurement surface (--bench-json, --no-kernels), the
# autotuner (--autotune, --autotune-cache) and the kernel lints
# ---------------------------------------------------------------------------
SURFACE_ARGS = ("--arch", "llama2_7b", "--dtype", "bfloat16", "--offload-ratio", "0.5",
                "--page-size", "16", "--max-batch", str(DECODE_BATCH), "--requests", "8",
                "--prompt-len", str(PREFILL_LEN), "--new-tokens", "32",
                "--max-len", str(PREFILL_LEN + 32))
# the served plans of the chip phases: (arch, layers or None for all, offload,
# page, slots, max_len, element bytes)
SERVED_PLANS = (
    ("llama2_7b", None, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 32, 2),
    ("llama2_7b", 2, 0.5, 4, 3, 32, 4),
    ("qwen3_moe_30b_a3b", None, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 32, 2),
    ("deepseek_v2_236b", 2, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 32, 2),
    ("opt_6p7b", None, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 32, 2),
    ("opt_30b", None, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 16, 2),
    ("mamba2_370m", None, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 32, 2),
    ("zamba2_2p7b", None, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 32, 2),
    ("llava_next_34b", None, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 16, 2),
    ("hubert_xlarge", None, 0.5, 16, DECODE_BATCH, PREFILL_LEN + 32, 2),
)


def serve_cli(args: list[str]) -> tuple[dict, dict]:
    """`launch/serve.main(args)` with the launch counts zeroed just before;
    returns its report and the launches it made."""
    from repro_torch.launch import serve

    reset_launch_counts()
    report = serve.main(list(args))
    torch.cuda.synchronize()
    return report, launch_counts()


def tuned_gemm_check(entry, dtype, gen) -> float:
    """A tuned GEMM winner's launch at its served shape against the plain
    version; returns the relative error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_gemm import splitk_gemm

    m, k, n_loc, n_rem = entry.shape
    wl, wr, wr_dev = make_tier_pair(k, n_loc, n_rem, dtype, gen)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    got = splitk_gemm(x, wl, wr, window=entry.config["window"],
                      k_split=entry.config["k_split"])
    return rel_err(got, ref.splitk_gemm_ref(x, wl, wr_dev))[0]


def tuned_paged_check(entry, dtype, gen) -> float:
    """A tuned paged-attention winner (window = its slots) at its served
    shape against the plain version; returns the relative error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn

    h, kh, hd, ps, mp = entry.shape
    lens = [min(mp * ps, n) for n in PAGED_LENS]
    q, pools, pools_dev, table, tier, lens_t = paged_inputs(
        DECODE_BATCH, h, kh, hd, ps, mp, 2 * mp, 2 * mp, lens, dtype, gen)
    got = paged_splitk_flashattn(q, pools["k_local"], pools["v_local"], pools["k_remote"],
                                 pools["v_remote"], table, tier, lens_t,
                                 window=entry.config["slots"])
    want = ref.paged_flashattn_ref(q, pools_dev["k_local"], pools_dev["v_local"],
                                   pools_dev["k_remote"], pools_dev["v_remote"], table, tier,
                                   lens_t)
    return rel_err(got, want)[0]


def modeled_winner_agreement(tuner, entries, gen) -> tuple[int, int]:
    """For each served GEMM shape, the model's pick among {split-K at the
    wrapper's split, whole K} x {window 1, 2} against the fastest of the
    four timed on the card (CUDA events, L2 flushed, median of 10, in
    alternating rounds); prints both and returns (agreeing, shapes)."""
    from repro_torch.kernels import splitk_gemm as G

    scratch = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    agree = 0
    for e in entries:
        m, k, n_loc, n_rem = e.shape
        wl, wr, _ = make_tier_pair(k, n_loc, n_rem, torch.bfloat16, gen)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        split = G.decode_k_split(n_loc, n_rem, k, G.sm_count(tuner.hw))
        configs = [(ks, w) for ks in (split, 0) for w in (1, 2)]
        timed = alternate([lambda ks=ks, w=w: G._launch(x, wl, wr, w, ks) for ks, w in configs],
                          scratch.zero_)
        ms = [statistics.median(t) for t in timed]
        modeled = [tuner._gemm_cost(m, k, n_loc, n_rem, ks, w, 2) for ks, w in configs]
        fast, pick = ms.index(min(ms)), modeled.index(min(modeled))
        agree += fast == pick
        name = lambda i: f"{'split-K' if configs[i][0] else 'whole K'} w{configs[i][1]}"  # noqa: E731
        print(f"  GEMM {e.shape}: card {' | '.join(f'{name(i)} {ms[i]:.4f}' for i in range(4))}"
              f" ms -> fastest {name(fast)}; model picks {name(pick)}; full-sweep winner "
              f"{e.config}")
        del wl, wr, x
    return agree, len(entries)


def surface_lints(tuner, card) -> None:
    """(d): every launch configuration phase 30 used, `smem_footprint_bytes`
    against each kernel's own count; the lints' 227 KiB against the card's
    opt-in limit; check_kernels clean at every chip phase's served plan."""
    import repro_torch.configs as C
    from repro_torch.analysis import kernel_lints as KL
    from repro_torch.core import engine as E
    from repro_torch.core.ebmodel import WorkloadSpec
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.kernels import splitk_flashattn as A
    from repro_torch.kernels import splitk_gemm as G

    fp = KL.flash_prefill
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    check(KL.SMEM_OPTIN_BYTES == optin,
          f"the lints' per-CTA shared memory {KL.SMEM_OPTIN_BYTES} B equals the card's "
          f"shared_memory_per_block_optin {optin} B")
    cfg = C.get("llama2_7b")
    plan = E.plan(cfg, WorkloadSpec(batch=DECODE_BATCH, seq_len=PREFILL_LEN + 32,
                                    phase="decode"), H100_SXM, global_ratio=0.5, kv_page_size=16)
    gemms, attns, prefills = KL.describe_launches(
        cfg, plan, KL.operand_shapes(cfg), align=128, batch=DECODE_BATCH,
        max_len=PREFILL_LEN + 32, dtype_bytes=2)
    gemm_cfgs = {(g.m, g.k, g.k_split, g.window) for g in gemms}
    gemm_cfgs |= {(e.shape[0], e.shape[1], e.config["k_split"], e.config["window"])
                  for e in tuner.table.values() if e.op == "splitk_gemm" and e.config}
    gemm_cfgs |= {(PREFILL_LEN, k, 0, 1) for k in (4096, 11008)}      # prefill's whole K
    bad = []
    for m, k, ks, w in sorted(gemm_cfgs):
        want = G.smem_query(m, k, window=w, k_split=ks, dtype=torch.bfloat16)
        got = (G.smem_footprint_bytes(m, k, 0, 0, window=w, k_split=ks, dtype=torch.bfloat16),
               G.ring_stages(m, k, window=w, k_split=ks, dtype=torch.bfloat16)[0])
        if got != want:
            bad.append(((m, k, ks, w), got, want))
    attn_cfgs = {(a.kind, a.h, a.kh, a.hd, a.chunk, a.n_chunks, a.window) for a in attns}
    attn_cfgs |= {("paged", *e.shape, e.config["slots"]) for e in tuner.table.values()
                  if e.op == "paged_splitk_flashattn" and e.config}
    attn_cfgs.add(("batch", 32, 32, 128, A.CHUNK, -(-SPLIT_KV_LEN // A.CHUNK), 1))   # phase 7
    for kind, h, kh, hd, chunk, n, w in sorted(attn_cfgs):
        if kind == "paged":
            want = A.paged_smem_query(DECODE_BATCH, h, kh, hd, chunk, n, window=w,
                                      dtype=torch.bfloat16)
            d = A.paged_design(DECODE_BATCH, h, kh, hd, chunk, n, window=w, dtype=torch.bfloat16)
            got = (d.smem, d.stages)
        else:
            want = A.smem_query(h, kh, hd, chunk * n, window=w, dtype=torch.bfloat16)
            got = (A.smem_footprint_bytes(h, kh, hd, chunk * n, window=w, dtype=torch.bfloat16),
                   A.ring_stages(w, 2 * A._box_bytes(chunk, hd, 2), n)[0])
        if got != want:
            bad.append(((kind, h, kh, hd, chunk, n, w), got, want))
    prefill_cfgs = [(torch.bfloat16, which) for which in fp.BF16_DESIGNS]
    prefill_cfgs.append((torch.float32, None))
    for dtype, which in prefill_cfgs:
        got = fp.smem_footprint_bytes(128, dtype=dtype, which=which)
        want = fp.smem_query(128, dtype=dtype, which=which)
        if got != want:
            bad.append((("flash_prefill", dtype, which), got, want))
    check(not bad, f"smem_footprint_bytes equals the kernel's own count (bytes and ring stages) "
                   f"for all {len(gemm_cfgs)} GEMM, {len(attn_cfgs)} attention and "
                   f"{len(prefill_cfgs)} flash_prefill launch configurations of phase 30"
                   + (f": {bad[:3]}" if bad else ""))
    findings = []
    for arch, n_layers, ratio, page, slots, max_len, db in SERVED_PLANS:
        cfg = C.get(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        plan = E.plan(cfg, WorkloadSpec(batch=slots, seq_len=max_len, phase="decode"),
                      H100_SXM, global_ratio=ratio, kv_page_size=page)
        findings += KL.check_kernels(cfg, plan, H100_SXM, KL.operand_shapes(cfg),
                                     align=32 if cfg.d_model < 1024 else 128, batch=slots,
                                     max_len=max_len, dtype_bytes=db, where=arch)
    check(not findings, f"check_kernels is clean at the {len(SERVED_PLANS)} served plans of the "
                        f"chip phases" + (f": {[str(f) for f in findings[:3]]}" if findings
                                          else ""))


def phase_surface(card: dict) -> None:
    """Phase 30: (a) the llama2-7b served run of phase 4 through
    `launch/serve.main` with --bench-json; (b) the same traffic with
    --autotune and --autotune-cache: every tuned configuration held against
    its plain version, the table reloaded lookup-only reproducing every
    winner, its lints clean, TPOT tuned and default, and the share of GEMM
    shapes where the model's pick matches the card's; (c) --no-kernels, the
    reference oracle: tokens equal to the tiered engine's at 2 layers in
    fp32, no kernel launched, and its TPOT at 32 layers in bf16 beside the
    all-HBM TPOT of the tiered engine at offload 0; (d) the lints."""
    import repro_torch.configs as C
    from repro_torch.analysis.kernel_lints import check_autotune_table
    from repro_torch.kernels.autotune import Autotuner
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine

    out = REPO / "build" / "phase30"
    out.mkdir(parents=True, exist_ok=True)
    where = f"{card['name']} at {card['power']}"
    # (a) the report
    bench = out / "bench.json"
    rep, runs = serve_cli([*SURFACE_ARGS, "--bench-json", str(bench)])
    data = json.loads(bench.read_text())
    rate = data["generated_tokens"] / data["wall_s"]
    check(data == json.loads(json.dumps(rep, default=float)) and data["schema_version"] == 2
          and data["provenance"]["torch"] == torch.__version__ and data["served"] == 8
          and data["generated_tokens"] == 8 * 32,
          f"--bench-json wrote the report main returned: schema_version 2, provenance torch "
          f"{data['provenance']['torch']}, 8 served, {data['generated_tokens']} tokens")
    check(abs(data["tokens_per_s"] - rate) <= 1e-9 * rate
          and data["tokens_per_s"] <= DECODE_BATCH * 1e3 / data["tpot_ms"],
          f"report tokens/s {data['tokens_per_s']:.3f} = generated / wall, within the "
          f"{DECODE_BATCH} slots' decode rate at TPOT {data['tpot_ms']:.2f} ms "
          f"({DECODE_BATCH * 1e3 / data['tpot_ms']:.3f} tokens/s)")
    check(runs["splitk_gemm"] > 0 and runs["paged_splitk_flashattn"] > 0,
          f"the default run launched splitk_gemm {runs['splitk_gemm']} and paged attention "
          f"{runs['paged_splitk_flashattn']} times")
    # (b) the autotuner
    table = out / "autotune.json"
    table.unlink(missing_ok=True)
    rep_t, _ = serve_cli([*SURFACE_ARGS, "--autotune", "--autotune-cache", str(table),
                          "--bench-json", str(out / "bench_tuned.json")])
    tuner = Autotuner.load(str(table), sweep=False)
    fresh = Autotuner(tuner.hw)

    def lookup(t, e):
        if e.op == "splitk_gemm":
            return t.best_gemm(*e.shape, e.dtype)
        return t.best_paged(*e.shape, e.ratio, e.dtype)

    loaded = all(lookup(tuner, e) == e.config for e in tuner.table.values())
    # a GEMM key fixes its sweep (an attention key buckets the remote fraction)
    swept = all(lookup(fresh, e) == e.config for e in tuner.table.values()
                if e.op == "splitk_gemm")
    lints = check_autotune_table([e.to_json() for e in tuner.table.values()])
    check(len(tuner.table) >= 6 and loaded and tuner.misses == 0 and swept and not lints
          and tuner.validate() == [],
          f"the {len(tuner.table)}-entry table reloaded lookup-only reproduces every winner "
          f"(hits {tuner.hits}, misses {tuner.misses}), a fresh sweep every GEMM winner; "
          f"check_autotune_table finds {len(lints)}")
    gen = torch.Generator(device="cuda").manual_seed(30)
    errs = {}
    for e in tuner.table.values():
        check_one = {"splitk_gemm": tuned_gemm_check,
                     "paged_splitk_flashattn": tuned_paged_check}[e.op]
        for dtype in (torch.bfloat16, torch.float32):
            errs[(e.op, e.shape, e.config.__repr__(), dtype)] = check_one(e, dtype, gen)
    torch.cuda.synchronize()
    worst = {dt: max(v for (_, _, _, d), v in errs.items() if d == dt) for dt in TOL}
    check(all(v < TOL[d] for (_, _, _, d), v in errs.items()),
          f"every tuned configuration of the run ({len(tuner.table)}) matches its plain version "
          f"at the served shape: worst relative error bf16 {worst[torch.bfloat16]:.2e}, fp32 "
          f"{worst[torch.float32]:.2e}")
    for e in sorted(tuner.table.values(), key=lambda e: e.key()):
        print(f"  tuned {e.op} {e.shape} {e.dtype} ratio {e.ratio}: {e.config} "
              f"(modeled {e.modeled_us:.2f} us)")
    print(f"  TPOT on {where}: default {rep['tpot_ms']:.2f} ms, tuned {rep_t['tpot_ms']:.2f} ms "
          f"(counters {rep_t['autotune']})")
    gemm_entries = sorted((e for e in tuner.table.values() if e.op == "splitk_gemm"),
                          key=lambda e: e.shape)
    agree, n = modeled_winner_agreement(tuner, gemm_entries, gen)
    print(f"  modeled-winner agreement on {where}: {agree}/{n} served GEMM shapes "
          f"(model vs card among split-K/whole K x window 1/2; printed, not gated)")
    # (c) --no-kernels, the reference oracle: exact tokens at 2 layers fp32,
    # then its TPOT at 32 layers beside the all-HBM run of the tiered engine
    cfg = dataclasses.replace(C.get("llama2_7b"), n_layers=2)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                           dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab, n).astype(np.int32) for n in (10, 16, 7, 14, 9)]
    toks, counts = {}, {}
    for kernels in (True, False):
        reset_launch_counts()
        eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.5,
                            page_size=4, use_kernels=kernels, device="cuda")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        toks[kernels], counts[kernels] = [r.out_tokens for r in reqs], launch_counts()
        del eng
    check(toks[True] == toks[False] and counts[True]["splitk_gemm"] > 0
          and not any(counts[False].values()),
          f"--no-kernels engine (2 layers, fp32) emits the tiered engine's tokens "
          f"({sum(map(len, toks[True]))}) and launches no kernel ({counts[False]})")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rep_n, runs_n = serve_cli([*SURFACE_ARGS, "--no-kernels", "--bench-json",
                               str(out / "bench_no_kernels.json")])
    check(rep_n["served"] == 8 and not any(runs_n.values()) and not rep_n["compile"]["jit"],
          f"--no-kernels served 8/8 at 32 layers bf16 and launched no kernel ({runs_n})")
    gc.collect()
    torch.cuda.empty_cache()
    # the all-HBM comparison: the same engine, kernels and graphs at offload 0
    rep_h, runs_h = serve_cli([*SURFACE_ARGS, "--offload-ratio", "0", "--bench-json",
                               str(out / "bench_hbm.json")])
    check(rep_h["served"] == 8 and rep_h["compile"]["jit"] and runs_h["paged_splitk_flashattn"] > 0,
          f"the tiered engine at --offload-ratio 0 served 8/8 at 32 layers bf16, graphed "
          f"({runs_h})")
    print(f"  TPOT on {where}: all-HBM (tiered engine at --offload-ratio 0) "
          f"{rep_h['tpot_ms']:.2f} ms, tiered at offload 0.5 {rep['tpot_ms']:.2f} ms, reference "
          f"oracle (--no-kernels: eager plain PyTorch, no graph) {rep_n['tpot_ms']:.2f} ms; "
          f"{rep_h['tokens_per_s']:.2f} / {rep['tokens_per_s']:.2f} / "
          f"{rep_n['tokens_per_s']:.2f} tokens/s")
    gc.collect()
    torch.cuda.empty_cache()
    # (d) the lints
    surface_lints(tuner, card)


# ---------------------------------------------------------------------------
# Phase 31: the serving mesh, each part in spawned ranks
# ---------------------------------------------------------------------------
MESH_PROMPT, MESH_NEW, MESH_SHARED_LAYERS = 32, 8, 8


def mesh_requests(cfg):
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(31)
    return [Request(rid=i, prompt=rng.integers(3, cfg.vocab, MESH_PROMPT).astype(np.int32),
                    max_new_tokens=MESH_NEW) for i in range(DECODE_BATCH)]


def mesh_serve(cfg, mesh) -> dict:
    """Build llama2-7b (seed 0, bf16, layer by layer) with or without `mesh`,
    serve phase 31's traffic graphed, and return what the checks compare:
    tokens, launches per engine step, modeled remote bytes per step (the
    trace's link counters), TPOT, peak device memory, the mesh figures.
    The launch counts are zeroed just before the engine serves."""
    from repro_torch.models import model as M
    from repro_torch.obs.trace import ChromeTraceRecorder
    from repro_torch.serving.engine import ServingEngine

    t0 = time.time()
    rec = ChromeTraceRecorder()
    eng = ServingEngine(
        cfg, M.layer_source(cfg, torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.bfloat16, device="cuda"),
        max_batch=DECODE_BATCH, max_len=MESH_PROMPT + MESH_NEW, global_offload_ratio=0.5,
        page_size=16, recorder=rec, device="cuda", mesh=mesh)
    built = time.time() - t0
    reqs = mesh_requests(cfg)
    if mesh is not None:
        mesh.reset_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    per_step = serve_counting(eng, reqs)
    torch.cuda.synchronize()
    link_steps = [sum(e["args"].values()) for e in rec.events
                  if e.get("ph") == "C" and e.get("name") == "link_bytes"]
    out = {"tokens": [r.out_tokens for r in reqs], "steps": per_step, "link_steps": link_steps,
           "tpot_ms": eng.stats.tpot * 1e3, "peak": torch.cuda.max_memory_allocated(),
           "built_s": built, "w_remote": eng._weight_bytes[1],
           "per_link_bytes": eng.mesh_traffic_report()["per_link_bytes"],
           "plan_mesh": eng.plan.mesh is not None, "mesh_shape": eng.mesh_shape}
    if mesh is not None:
        out.update(link_bytes=dict(mesh.link_bytes), fetches=mesh.fetches)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank: int, n: int, n_layers: int, plain_ranks: tuple[int, ...],
              out_dir: str) -> None:
    """One rank of phase 31: the engine without a mesh (on `plain_ranks`,
    before the mesh exists), then the mesh engine; results to out_dir as
    JSON."""
    import repro_torch.configs as C
    from repro_torch.launch.mesh import make_dev_mesh

    cfg = dataclasses.replace(C.get("llama2_7b"), n_layers=n_layers)
    res = {"plain": mesh_serve(cfg, None)} if rank in plain_ranks else {}
    res["mesh"] = mesh_serve(cfg, make_dev_mesh(1, n))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res, default=float))


def run_mesh_part(n: int, backend: str, n_layers: int, plain_ranks: tuple[int, ...],
                  label: str) -> list[dict] | None:
    """Spawn phase 31's ranks for one part; returns each rank's results, or
    None (a failed check) when a rank raised."""
    import shutil

    from repro_torch.launch.mesh import run_ranks

    out = REPO / "build" / "phase31" / label
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.time()
    try:
        run_ranks(mesh_rank, n, backend=backend, init_method=f"file://{out / 'store'}",
                  args=(n, n_layers, plain_ranks, str(out)))
    except Exception as e:                 # a rank raised: the part fails, it is not skipped
        check(False, f"phase 31 ({label}): a rank failed: {type(e).__name__}: {e}")
        return None
    print(f"  {label}: {n} rank(s) over {backend} ran in {time.time() - t0:.1f} s")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]


def phase_mesh() -> None:
    """Phase 31 (see the module docstring): (a) P = 1 over NCCL at 32 layers
    beside the engine without a mesh, (b) P = 2 over gloo sharing the card
    at 8 layers."""
    from repro_torch.core import multicast

    ov = multicast.GRANULARITY_OVERHEAD
    ranks = run_mesh_part(1, "nccl", 32, (0,), "p1_nccl")
    if ranks is not None:
        plain, mesh = ranks[0]["plain"], ranks[0]["mesh"]
        decode = [s for s in mesh["steps"] if s["paged_splitk_flashattn"]]
        last = decode[-1] if decode else {"splitk_gemm": 0, "paged_splitk_flashattn": 0}
        check(mesh["tokens"] == plain["tokens"]
              and all(len(t) == MESH_NEW for t in mesh["tokens"]),
              f"(a) P=1 over NCCL, 32 layers: tokens equal the engine without a mesh for all "
              f"{DECODE_BATCH} requests")
        check(mesh["steps"] == plain["steps"] and bool(decode)
              and all(s["splitk_gemm"] for s in decode),
              f"(a) launches equal in all {len(mesh['steps'])} engine steps; a decode step "
              f"launches {last['splitk_gemm']} splitk_gemm and "
              f"{last['paged_splitk_flashattn']} paged attention")
        check(mesh["link_steps"] == plain["link_steps"] and mesh["link_steps"],
              f"(a) modeled remote bytes equal in all {len(mesh['link_steps'])} steps "
              f"({mesh['link_steps'][-1] / 1e9:.4f} GB in the last)")
        check(mesh["plan_mesh"] and mesh["mesh_shape"] == [1],
              "(a) the plan carries the mesh, mesh_shape [1]")
        print(f"  (a) TPOT without a mesh {plain['tpot_ms']:.2f} ms, P=1 mesh "
              f"{mesh['tpot_ms']:.2f} ms | peak device memory {plain['peak'] / 1e9:.3f} GB "
              f"vs {mesh['peak'] / 1e9:.3f} GB | weights fetched up the link "
              f"{mesh['link_bytes']['weights'] / mesh['fetches'] / 1e9:.4f} GB a fetch, "
              f"kv {mesh['link_bytes']['kv'] / 1e9:.4f} GB in all | built in "
              f"{plain['built_s']:.1f} s and {mesh['built_s']:.1f} s")
    ranks = run_mesh_part(2, "gloo", MESH_SHARED_LAYERS, (0,), "p2_gloo")
    if ranks is not None:
        plain = ranks[0]["plain"]
        for rank, res in enumerate(ranks):
            mesh = res["mesh"]
            per_fetch = mesh["link_bytes"]["weights"] / max(1, mesh["fetches"])
            check(mesh["tokens"] == plain["tokens"],
                  f"(b) P=2 over gloo, {MESH_SHARED_LAYERS} layers, rank {rank}: tokens equal "
                  f"the engine without a mesh")
            check(math.isclose(per_fetch, plain["w_remote"] / 2, rel_tol=0.01)
                  and math.isclose(per_fetch * ov, mesh["per_link_bytes"][rank], rel_tol=0.01),
                  f"(b) rank {rank}: {per_fetch / 1e9:.4f} GB of weights up its host link a "
                  f"fetch, half the single-link {plain['w_remote'] / 1e9:.4f} GB and its report "
                  f"link's {mesh['per_link_bytes'][rank] / ov / 1e9:.4f} GB (payload)")
            check(mesh["plan_mesh"] and mesh["mesh_shape"] == [2],
                  f"(b) rank {rank}: the plan carries the mesh, mesh_shape [2]")
            print(f"  (b) rank {rank}: TPOT {mesh['tpot_ms']:.2f} ms (without a mesh "
                  f"{plain['tpot_ms']:.2f} ms) | peak device memory {mesh['peak'] / 1e9:.3f} GB "
                  f"| kv up the link {mesh['link_bytes']['kv'] / 1e6:.3f} MB over "
                  f"{mesh['fetches']} fetches | built in {mesh['built_s']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 32: the materialization lint on the card
# ---------------------------------------------------------------------------
LINT_LAYERS, LINT_PROMPT, LINT_NEW = 2, 32, 4


def lint_engine_steps(mesh=None) -> dict:
    """Build llama2-7b at full width and LINT_LAYERS layers (bf16, offload
    0.5, page 16, remote tiers pinned, layer by layer as phase 4; eager
    steps), submit DECODE_BATCH requests and run two engine steps under the
    materialization lint: the first admits them (their prefills) and
    decodes once, the second decodes.  Returns the findings, the aten ops
    walked, the direct-access entry points run and their launches."""
    import repro_torch.configs as C
    from repro_torch.analysis import materialization as MZ
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = dataclasses.replace(C.get("llama2_7b"), n_layers=LINT_LAYERS)
    eng = ServingEngine(
        cfg, M.layer_source(cfg, torch.Generator(device="cuda").manual_seed(0),
                            dtype=torch.bfloat16, device="cuda"),
        max_batch=DECODE_BATCH, max_len=LINT_PROMPT + LINT_NEW, global_offload_ratio=0.5,
        page_size=16, jit_step=False, device="cuda", mesh=mesh)
    rng = np.random.default_rng(32)
    for i in range(DECODE_BATCH):
        eng.submit(Request(rid=i, prompt=rng.integers(3, cfg.vocab, LINT_PROMPT)
                           .astype(np.int32), max_new_tokens=LINT_NEW))
    out = {"findings": [], "ops": 0, "sinks": 0, "pinned": 0}
    seeds = MZ.engine_remote_tensors(eng)
    out["pinned"] = sum(t.is_pinned() for t in seeds)
    before = launch_counts()
    for rule, where in (("DAK002", "prefill+decode"), ("DAK001", "decode")):
        with MZ.MaterializationLint(rule=rule, where=where) as lint:
            lint.seed(seeds)
            eng.step()
        torch.cuda.synchronize()
        out["findings"] += [f"{f.rule} [{f.where}] {f.detail}" for f in lint.findings]
        out["ops"] += lint.ops
        out["sinks"] += lint.sinks
    out["launches"] = {k: v - before[k] for k, v in launch_counts().items()}
    out["fetches"] = mesh.fetches if mesh is not None else 0
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_lint(card: dict) -> None:
    """Phase 32 (see the module docstring): the materialization lint over
    (a) the engine's admitted prefill and eager decode steps with pinned
    tiers, (b) phase 5's prefetch yardstick, (c) a one-rank mesh step."""
    import torch.distributed as dist

    from repro_torch.analysis import materialization as MZ
    from repro_torch.kernels.splitk_gemm import splitk_gemm
    from repro_torch.launch.mesh import init_rank, make_dev_mesh

    t0 = time.time()
    res = lint_engine_steps()
    check(res["pinned"] > 0, f"(a) {res['pinned']} of the lint's remote seeds are pinned host "
                             f"memory (the remote weight tiers and KV pools)")
    check(not res["findings"] and res["launches"]["splitk_gemm"] > 0
          and res["launches"]["paged_splitk_flashattn"] > 0,
          f"(a) llama2-7b ({LINT_LAYERS} layers, bf16, offload 0.5, pinned tiers): "
          f"{DECODE_BATCH} admitted prefills and two eager decode steps under the lint: "
          f"{len(res['findings'])} findings over {res['ops']} aten ops walked, "
          f"{res['sinks']} direct-access entry points run ({res['launches']['splitk_gemm']} "
          f"splitk_gemm and {res['launches']['paged_splitk_flashattn']} paged attention "
          f"launches)")
    for f in res["findings"]:
        print(f"    {f}")
    print(f"  (a) {time.time() - t0:.1f} s")

    t1 = time.time()
    k, n_loc, n_rem = GEMM_SHAPES["wq"]
    gen = torch.Generator(device="cuda").manual_seed(32)
    wl, wr, wr_dev = make_tier_pair(k, n_loc, n_rem, torch.bfloat16, gen)
    x = torch.randn((DECODE_BATCH, k), generator=gen, device="cuda").to(torch.bfloat16)
    found = {}
    for label, fn in (("prefetch+cuBLAS", lambda: prefetch_cublas(x, wl, wr, wr_dev)),
                      ("splitk_gemm", lambda: splitk_gemm(x, wl, wr))):
        with MZ.MaterializationLint(rule="DAK001", where=label) as lint:
            lint.seed([wr])
            y = fn()
        torch.cuda.synchronize()
        found[label] = (lint.findings, lint.ops, y)
    fs, n_ops, y_pre = found["prefetch+cuBLAS"]
    check([(f.rule, f.context["kind"]) for f in fs] == [("DAK001", "device-move")],
          f"(b) phase 5's prefetch yardstick at wq's split (M={DECODE_BATCH} K={k} "
          f"N={n_loc}|{n_rem} bf16) under the lint: {[f.rule for f in fs]} over {n_ops} aten "
          f"ops: {fs[0].detail if fs else 'nothing fired'}")
    fs, n_ops, y_dak = found["splitk_gemm"]
    rel, _ = rel_err(y_dak, y_pre)
    check(not fs and rel < TOL[torch.bfloat16],
          f"(b) splitk_gemm on the same operands under the lint: {len(fs)} findings over "
          f"{n_ops} aten ops, max rel err against the yardstick {rel:.2e}")
    del wl, wr, wr_dev, x, found
    print(f"  (b) {time.time() - t1:.1f} s")

    t2 = time.time()
    out = REPO / "build" / "phase32"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # this process joins a one-rank group here and leaves it after
    init_rank(0, 1, backend="nccl", init_method=f"file://{out / 'store'}")
    try:
        res = lint_engine_steps(make_dev_mesh(1, 1))
    except Exception as e:                 # the part fails, it is not skipped
        check(False, f"phase 32 (c): the mesh step failed: {type(e).__name__}: {e}")
        return
    finally:
        dist.destroy_process_group()
    check(not res["findings"] and res["fetches"] > 0 and res["launches"]["splitk_gemm"] > 0,
          f"(c) a P=1 mesh over NCCL (this process, one rank), the same engine and steps "
          f"under the lint: "
          f"{len(res['findings'])} findings over {res['ops']} aten ops walked, "
          f"{res['sinks']} direct-access entry points run, {res['fetches']} fetch-once "
          f"gathers (gather_shards)")
    for f in res["findings"]:
        print(f"    {f}")
    print(f"  (c) {time.time() - t2:.1f} s | phase 32 {time.time() - t0:.1f} s on "
          f"{card['name']} at {card['power']}")


# ---------------------------------------------------------------------------
# Phase 33: the training stack
# ---------------------------------------------------------------------------
TRAIN_ARCH = "starcoder2_3b"  # the train driver's default, and one H100 holds it whole
TRAIN_BATCH = 2
TRAIN_SEQ = 4096              # train_4k's sequence: attention takes its q-chunked path
TRAIN_SHORT_SEQ = 256         # parts (a), (b), (d) and (e)
TRAIN_STEPS = 4               # full-size steps of part (c)


def tree_rel_err(got, want) -> tuple[float, str]:
    """The worst leaf's max |got - want| / max |want|, computed on `want`'s
    device (the card's, where one tree is on the CPU), and its path."""
    from repro_torch.tree import flatten

    worst = (0.0, "")
    for (key, a), (_, b) in zip(flatten(got), flatten(want), strict=True):
        a, b = a.to(b.device).float(), b.float()
        err = float((a - b).abs().max() / (b.abs().max() + 1e-9)) if b.numel() else 0.0
        worst = max(worst, (err, key))
    return worst


def train_batch(cfg, seq: int, device, step: int = 0) -> dict:
    """Batch `step` of the synthetic pipeline (seed 0) on `device`."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline

    pipe = SyntheticPipeline(cfg, ShapeConfig("phase33", seq, TRAIN_BATCH, "train"))
    return {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(step).items()}


def train_gradients_part(cfg) -> None:
    """(a) and (b): gradients on the card against the CPU, remat on against
    off, `adamw.update` on both devices from the same gradients; then 8
    steps on one batch."""
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    tol = TOL[torch.float32]
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(33), device="cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    batch = train_batch(cfg, TRAIN_SHORT_SEQ, "cuda")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    loss, grads = S.make_loss_and_grads(cfg)(params, batch)
    t0 = time.time()
    cpu_loss, cpu_grads = S.make_loss_and_grads(cfg)(cpu_params, cpu_batch)
    cpu_s = time.time() - t0
    lrel = abs(float(loss) - float(cpu_loss)) / abs(float(cpu_loss))
    err, where = tree_rel_err(cpu_grads, grads)
    check(lrel < tol and err < tol,
          f"(a) loss and gradients, 2 layers fp32, batch {TRAIN_BATCH} x {TRAIN_SHORT_SEQ}, remat: "
          f"card {float(loss):.6f} vs CPU {float(cpu_loss):.6f} (rel {lrel:.2e}); worst "
          f"gradient leaf {where} at {err:.2e} of its max (CPU pass {cpu_s:.1f} s)")
    _, grads_nr = S.make_loss_and_grads(cfg, remat=False)(params, batch)
    err, where = tree_rel_err(grads_nr, grads)
    check(err < tol, f"(a) remat off against remat on, on the card: worst leaf {where} at "
                     f"{err:.2e} of its max")
    del grads_nr, cpu_grads
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=8)
    new, state, gnorm = adamw.update(tree_map(torch.clone, params), grads, adamw.init(params),
                                     opt_cfg)
    cpu_new, cpu_state, cpu_gnorm = adamw.update(
        tree_map(torch.clone, cpu_params), tree_map(lambda t: t.cpu(), grads),
        adamw.init(cpu_params), opt_cfg)
    errs = {name: tree_rel_err(a, b) for name, a, b in (
        ("params", cpu_new, new), ("m", cpu_state["m"], state["m"]),
        ("v", cpu_state["v"], state["v"]))}
    nrel = abs(float(gnorm) - float(cpu_gnorm)) / float(cpu_gnorm)
    check(all(e < tol for e, _ in errs.values()) and nrel < tol
          and state["step"].device.type == "cuda" and int(state["step"]) == 1,
          f"(a) adamw.update from the same gradients, card against CPU: gnorm rel {nrel:.2e}; "
          + ", ".join(f"{n} worst {w} at {e:.2e}" for n, (e, w) in errs.items()))
    del new, state, cpu_new, cpu_state, grads, cpu_params, cpu_batch

    step = S.make_train_step(cfg, opt_cfg)
    opt = adamw.init(params)
    losses = []
    for _ in range(8):
        loss, params, opt, _ = step(params, opt, batch)
        losses.append(float(loss))
    check(losses[-1] < losses[0] and all(math.isfinite(v) for v in losses),
          f"(b) 8 steps on one batch (lr 1e-3, no warmup): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, a drop of {losses[0] - losses[-1]:.4f} "
          f"({', '.join(f'{v:.4f}' for v in losses)})")


def train_peak(cfg, params, batch, remat: bool) -> int:
    """Peak device bytes of one loss-and-gradient pass beyond what was held
    before it."""
    from repro_torch.launch import steps as S

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = S.make_loss_and_grads(cfg, remat=remat)(params, batch)
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


def train_full_part(card: dict, cfg) -> None:
    """(c): all layers, bf16, remat, train_4k's sequence; before it, the
    remat and no-remat peaks at 2 layers and the same batch."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    gen = torch.Generator(device="cuda").manual_seed(33)
    cut = dataclasses.replace(cfg, n_layers=2)
    params = M.init_params(cut, gen, dtype=torch.bfloat16, device="cuda")
    batch = train_batch(cut, TRAIN_SEQ, "cuda")
    peaks = {remat: train_peak(cut, params, batch, remat) for remat in (True, False)}
    print(f"  (c) 2 layers, bf16, batch {TRAIN_BATCH} x {TRAIN_SEQ}: a loss-and-gradient pass "
          f"peaks {peaks[True] / 1e9:.3f} GB above the weights with remat, "
          f"{peaks[False] / 1e9:.3f} GB without (attention's q-chunk checkpoint on in both)")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.time()
    params = M.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")
    opt = adamw.init(params)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    print(f"  (c) {cfg.name}: {cfg.n_layers} layers, bf16 weights and fp32 moments "
          f"{held / 1e9:.3f} GB on the card, made in {time.time() - t0:.1f} s")
    step = S.make_train_step(cfg, adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                                    total_steps=TRAIN_STEPS))
    pipe = SyntheticPipeline(cfg, ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train"))
    torch.cuda.reset_peak_memory_stats()
    times, losses, norms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in pipe.batch_at(i).items()}
        torch.cuda.synchronize()
        t = time.time()
        loss, params, opt, gnorm = step(params, opt, batch)
        losses.append(float(loss))
        norms.append(float(gnorm))
        times.append(time.time() - t)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    step_s = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.param_count()
    share = 6 * n * tokens / (step_s * BF16_PEAK)
    check(all(math.isfinite(v) for v in losses + norms) and peak < total,
          f"(c) {cfg.name} trained at all {cfg.n_layers} layers, bf16, remat, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}, gnorm {', '.join(f'{v:.3f}' for v in norms)}; "
          f"peak device memory {peak / 1e9:.3f} GB of the card's {total / 1e9:.3f} GB")
    print(f"  (c) step ms {', '.join(f'{t * 1e3:.1f}' for t in times)} (the first with "
          f"warm-up); median of the rest {step_s * 1e3:.1f} ms, {tokens / step_s:.1f} tokens/s; "
          f"6ND share {share:.4f} (N {n / 1e9:.4f} G from cfg.param_count(), D {tokens} tokens a "
          f"step, against {BF16_PEAK / 1e12:.0f} TFLOP/s bf16 at {card['power']})")


def phase_train_trace(card: dict) -> None:
    """Phase 34, only when asked: one torch.profiler trace of phase 33 (c)'s
    train step after one untraced step (tracing a step of ~15k kernels adds
    ~20 s of trace processing, so the default run leaves it out)."""
    import repro_torch.configs as C
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = C.get(TRAIN_ARCH)
    state = {"params": M.init_params(cfg, torch.Generator(device="cuda").manual_seed(33),
                                     dtype=torch.bfloat16, device="cuda")}
    state["opt"] = adamw.init(state["params"])
    step = S.make_train_step(cfg, adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                                    total_steps=TRAIN_STEPS))
    batch = train_batch(cfg, TRAIN_SEQ, "cuda")

    def one_step():
        _, state["params"], state["opt"], _ = step(state["params"], state["opt"], batch)

    one_step()
    trace_device(one_step, 1, f"{cfg.name} train step ({cfg.n_layers} layers, bf16, remat, "
                              f"{TRAIN_BATCH} x {TRAIN_SEQ}) on {card['name']} at "
                              f"{card['power']}")


def train_driver_part(cfg, out: Path) -> None:
    """(d): `launch.train` at 2 layers, bf16, with a restart from a
    checkpoint; the last checkpoint restored against the final state."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.tree import flatten

    ckpt_dir = out / "ckpt"
    args = train.parse_args(["--arch", TRAIN_ARCH, "--dtype", "bfloat16", "--steps", "6",
                             "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SHORT_SEQ),
                             "--ckpt-every", "2", "--fail-at", "3", "--log-every", "1",
                             "--ckpt-dir", str(ckpt_dir)])
    t0 = time.time()
    res = train.run(cfg, args)
    run_s = time.time() - t0
    for s in res["saves"]:
        print(f"  (d) save of step {s.step}: {s.seconds:.2f} s, {s.bytes / 1e9:.3f} GB "
              f"({s.bytes / s.seconds / 1e9:.2f} GB/s, on a thread beside the steps)")
    for r in res["restores"]:
        print(f"  (d) restore of step {r['step']}: {r['seconds']:.2f} s, {r['bytes'] / 1e9:.3f} "
              f"GB onto the card, each file's sha256 verified")
    t1 = time.time()
    tree, _ = CheckpointManager(ckpt_dir).restore(6, like=res["state"], verify=True)
    torch.cuda.synchronize()
    restore_s = time.time() - t1
    same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
               for (_, a), (_, b) in zip(flatten(tree), flatten(res["state"]), strict=True))
    check(res["final_step"] == 6 and res["restarts"] == 1 and same
          and [s.step for s in res["saves"]] == [2, 4, 6],
          f"(d) launch.train, 2 layers bf16, 6 steps, checkpoint every 2, failure at 3: final "
          f"step {res['final_step']}, {res['restarts']} restart, saves at "
          f"{[s.step for s in res['saves']]}; step 6 restored (files verified, "
          f"{restore_s:.2f} s) equals the final state bit for bit: {same} ({run_s:.1f} s)")
    del tree, res
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def train_dp_part(cfg, out: Path) -> None:
    """(e): the compressed data-parallel step at P = 1 over NCCL (this
    process joins a one-rank group and leaves it) beside the plain step."""
    import torch.distributed as dist

    from repro_torch.distributed.collectives import ErrorFeedback
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import init_rank, make_dev_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map

    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=20)
    plain_params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(33),
                                 dtype=torch.bfloat16, device="cuda")
    params = tree_map(torch.clone, plain_params)
    init_rank(0, 1, backend="nccl", init_method=f"file://{out / 'store'}")
    try:
        comp = S.make_dp_train_step_compressed(cfg, make_dev_mesh(1, 1), opt_cfg)
        plain = S.make_train_step(cfg, opt_cfg)
        opt, plain_opt = adamw.init(params), adamw.init(plain_params)
        residual = ErrorFeedback.init(params)
        pairs = []
        for i in range(4):
            batch = train_batch(cfg, TRAIN_SHORT_SEQ, "cuda", step=i)
            lc, params, opt, residual, _ = comp(params, opt, residual, batch)
            lp, plain_params, plain_opt, _ = plain(plain_params, plain_opt, batch)
            pairs.append((float(lc), float(lp)))
    except Exception as e:                 # the part fails, it is not skipped
        check(False, f"phase 33 (e): the compressed step failed: {type(e).__name__}: {e}")
        return
    finally:
        dist.destroy_process_group()
    worst = max(abs(c - p) / abs(p) for c, p in pairs)
    check(worst < 0.03,
          f"(e) make_dp_train_step_compressed at P=1 over NCCL, 2 layers bf16, 4 steps: losses "
          f"{', '.join(f'{c:.4f}' for c, _ in pairs)} against the plain step's "
          f"{', '.join(f'{p:.4f}' for _, p in pairs)}: worst {worst:.2e} (bound 3e-2)")


def phase_train(card: dict) -> None:
    """Phase 33 (see the module docstring): the training stack at
    StarCoder2-3B's published widths."""
    import repro_torch.configs as C

    t0 = time.time()
    cfg = C.get(TRAIN_ARCH)
    cut = dataclasses.replace(cfg, n_layers=2)
    out = REPO / "build" / "phase33"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    parts = (("a, b", lambda: train_gradients_part(cut)),
             ("c", lambda: train_full_part(card, cfg)),
             ("d", lambda: train_driver_part(cut, out)),
             ("e", lambda: train_dp_part(cut, out)))
    for name, part in parts:
        t = time.time()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"  ({name}) {time.time() - t:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    print(f"  phase 33 {time.time() - t0:.1f} s on {card['name']} at {card['power']}")


def add_launches(launches: dict, path: dict) -> None:
    """Keep each kernel's count from the first path run that launched it: the
    paged served run (phase 4) for the kernels of the main path, the MoE
    served run (phase 12) for `splitk_gemm_grouped`."""
    for name, n in path.items():
        if n:
            launches.setdefault(name, n)


DRYRUN_CELLS = (("qwen2p5_14b", "decode_32k"), ("chatglm3_6b", "prefill_32k"),
                (TRAIN_ARCH, "train_4k"))


def phase_dryrun() -> None:
    """Phase 35, only when asked: `launch.dryrun` is the one entry point
    that needs no card.  Each cell runs as ``python -X importtime -m
    repro_torch.launch.dryrun`` (the import log shows whether JAX came in);
    the card's allocated memory is read before and after."""
    out = REPO / "build" / "phase35"
    shutil.rmtree(out, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    for arch, shape in DRYRUN_CELLS:
        before = torch.cuda.memory_allocated()
        t0 = time.time()
        run = subprocess.run([sys.executable, "-X", "importtime", "-m", "repro_torch.launch.dryrun",
                              "--arch", arch, "--shape", shape, "--mesh", "single",
                              "--out", str(out)], capture_output=True, text=True, env=env,
                             timeout=600)
        wall = time.time() - t0
        jax = sorted({ln.rsplit("|", 1)[-1].strip() for ln in run.stderr.splitlines()
                      if ln.startswith("import time:")
                      and ln.rsplit("|", 1)[-1].strip().split(".")[0] in ("jax", "jaxlib")})
        lines = [ln for ln in run.stdout.splitlines() if ln.startswith("[")]
        for ln in lines:
            print(f"  {ln}")
        path = out / f"{arch}__{shape}__pod16x16.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        check(run.returncode == 0 and "dry-run done: ok=1 skip=0 err=0" in run.stdout
              and rec.get("status") == "ok",
              f"{arch} {shape}: exit {run.returncode}, {rec.get('status')} in {wall:.1f} s")
        if rec.get("status") == "error":
            print(f"    {rec['error']}\n    " + rec["trace"][-1500:].replace("\n", "\n    "))
        check(torch.cuda.memory_allocated() == before,
              f"{arch} {shape}: the card's allocated memory {before} B before, "
              f"{torch.cuda.memory_allocated()} B after")
        check(not jax, f"{arch} {shape}: no JAX module imported ({jax[:3] or 'none'})")
        if rec.get("status") == "ok":
            print(f"    flops/device {rec['flops_per_device']:.4g}, hbm bytes/device "
                  f"{rec['hbm_bytes_per_device']:.4g} ({rec['hbm_bytes_basis'].split(':')[0]}), "
                  f"collective bytes/device {rec['collective_bytes_per_device']:.4g} "
                  f"{rec['collective_counts']}; t_compute {rec['t_compute']:.4g} s, t_memory "
                  f"{rec['t_memory']:.4g} s, t_collective {rec['t_collective']:.4g} s at "
                  f"{rec['link_bw'] / 1e9:.0f} GB/s; layers traced {rec['layers_traced']}, "
                  f"trace {rec['trace_s']} s, replicated {list(rec['replicated_ops'])}")
    shutil.rmtree(out, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,11,12,13,14,15,16,17,18,19,20,21,22,23,24,25,26,"
                            "27,28,29,30,31,32,33",
                    help="comma-separated subset of phases 1-35 (default: 1-8 and 11-33; 9 "
                         "is the host-link read probe, 34 a traced train step, 35 the dry "
                         "run)")
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
    stats = {n: {"max_abs_err": None, "max_rel_err": None} for n in KERNELS}
    launches: dict[str, int] = {}
    step = {}
    begun: dict[int, float] = {}          # phase -> time it started

    def start(n: int, title: str) -> bool:
        """Whether phase `n` runs; if so, free what earlier phases left and
        print its title with the pinned host bytes still held."""
        if n not in phases:
            return False
        gc.collect()
        torch.cuda.empty_cache()
        begun[n] = time.time()
        print(f"phase {n}: {title} [pinned host bytes at start: {_build.pinned_bytes()}]")
        return True

    if start(2, "kernels against their plain versions on the card"):
        stats = phase_kernels()
    if start(3, "token parity, 2-layer full-width llama2-7b, fp32, offload 0.5, page 4"):
        phase_parity()
    if start(4, "served run, llama2-7b (32 layers, bf16), offload 0.5, page 16"):
        add_launches(launches, phase_serve()["launches"])
    if start(5, "timing"):
        step = phase_timing(card, window=1)
    if start(6, "batch-split token parity, 2-layer full-width llama2-7b, fp32, offload 0.5"):
        phase_batch_split_parity()
    if start(7, "batch-split served run, llama2-7b (32 layers, bf16), offload 0.5"):
        add_launches(launches, phase_batch_split_serve()["launches"])
    if start(8, "flash_prefill at llama2-7b prefill shape (off the serving path)"):
        add_launches(launches, phase_flash_prefill()["launches"])
    if start(9, "host-link read probe (copy form x CTAs x bytes in flight x row width)"):
        cap = phase_probe(card)
        for name in ("paged_attention", "splitk_flashattn"):
            if name in step:
                rate = step[name]["remote_bytes"] / (step[name]["ms"] * 1e-3) / 1e9
                print(f"  {name} at the served shape reads its remote tier at {rate:.2f} GB/s, "
                      f"{rate / cap:.2f}x the probe's best kernel read ({cap:.2f} GB/s)")
    if start(11, "MoE token parity, 2-layer full-width Qwen3-30B-A3B, fp32, dropless, "
                 "offload 0.5, page 4"):
        phase_parity("qwen3_moe_30b_a3b", n_layers=2, dropless=True)
    if start(12, "MoE served run, Qwen3-30B-A3B (48 layers, bf16), offload 0.5, page 16"):
        add_launches(launches, phase_serve("qwen3_moe_30b_a3b")["launches"])
        gc.collect()
        torch.cuda.empty_cache()
        long_prompt_request()
    if start(13, "MLA token parity, 1-layer full-width DeepSeek-V2, fp32, dropless, "
                 "offload 0.5, page 4"):
        phase_parity("deepseek_v2_236b", n_layers=1, dropless=True)
    if start(14, "MLA served run, DeepSeek-V2 (2 of 60 layers, bf16), offload 0.5, page 16"):
        add_launches(launches, phase_serve("deepseek_v2_236b", n_layers=2)["launches"])
    if start(15, "OPT token parity, 2-layer full-width OPT-30B, fp32, offload 0.5, page 4"):
        phase_parity("opt_30b", n_layers=2)
    if start(16, "served run, OPT-6.7B (32 layers, bf16), offload 0.5, page 16"):
        add_launches(launches, phase_serve("opt_6p7b")["launches"])
    if start(17, "served run, OPT-30B (48 layers, bf16), offload 0.5, page 16, 4 requests of "
                 "128 + 16 tokens"):
        add_launches(launches, phase_serve("opt_30b", n_req=DECODE_BATCH, new_tokens=16,
                                           peak_limit=OPT30B_PEAK_LIMIT)["launches"])
    if start(18, "SSM token parity, 2-layer full-width Mamba2-370M, fp32, offload 0.5"):
        phase_parity("mamba2_370m", n_layers=2)
    if start(19, "SSM served run, Mamba2-370M (48 layers, bf16), offload 0.5"):
        add_launches(launches, phase_serve("mamba2_370m")["launches"])
    if start(20, f"hybrid token parity, {ZAMBA2_PARITY_LAYERS}-layer full-width Zamba2-2.7B "
                 f"(both shared blocks), fp32, offload 0.5, page 4"):
        phase_parity("zamba2_2p7b", n_layers=ZAMBA2_PARITY_LAYERS)
    if start(21, "hybrid served run, Zamba2-2.7B (54 layers, bf16), offload 0.5, page 16"):
        add_launches(launches, phase_serve("zamba2_2p7b")["launches"])
    if start(22, "frontend token parity: SLO scheduler, chunks of 4, every decoder family at "
                 "full width and cut depth, fp32, offload 0.5; priority preemption"):
        phase_frontend_parity()
    if start(23, "served burst under the frontend, llama2-7b (32 layers, bf16), offload 0.5, "
                 "page 16: FCFS whole prompts, then SLO with chunks of 128"):
        phase_frontend_serve()
    if start(24, "encoder, HuBERT-XLarge: 2-layer fp32 parity, then 48 layers bf16 on "
                 "4 x 500 frames"):
        phase_encoder()
    if start(25, "VLM parity, 2-layer full-width LLaVA-NeXT-34B, fp32, offload 0.5, page 4"):
        phase_vlm_parity()
    if start(26, "VLM served run, LLaVA-NeXT-34B (60 layers, bf16), offload 0.5, page 16, "
                 "4 requests of 128 + 16 tokens, then 576 patches + 128 tokens"):
        served = phase_serve("llava_next_34b", n_req=DECODE_BATCH, new_tokens=16,
                             peak_limit=LLAVA_PEAK_LIMIT)
        add_launches(launches, served["launches"])
        vlm_patch_prefill(served.pop("engine"))
        del served
    if start(27, "elastic parity, 2-layer full-width llama2-7b, fp32, offload 0.5, page 4: "
                 "static, adaptive, shrink, zero-budget runtime + shrink, on the card and the CPU"):
        phase_elastic_parity()
    if start(28, "adaptive runtime, llama2-7b (32 layers, bf16), offload 0.5, page 16: static, "
                 "AIMD on CUDA-event bandwidth, and a shrink to 20% at decode step 2"):
        phase_elastic_serve()
    if start(29, "compiled decode step: graphed vs eager, fp32 parity at cut depth, then "
                 "llama2-7b (16 of 32 layers) and Mamba2-370M (48 layers) at full width, "
                 "bf16"):
        phase_compiled_parity()
        phase_compiled_serve()
    if start(30, "measurement surface and autotuner, llama2-7b (32 layers, bf16), offload 0.5, "
                 "page 16: --bench-json, --autotune, --no-kernels, kernel lints"):
        phase_surface(card)
    if start(31, "serving mesh, llama2-7b bf16, offload 0.5, page 16, 4 requests of 32 + 8 "
                 "tokens: P=1 over NCCL (32 layers), P=2 over gloo sharing the card (8 layers)"):
        phase_mesh()
    if start(32, "materialization lint on the card, llama2-7b (2 layers, bf16), offload 0.5, "
                 "page 16: engine steps, the prefetch yardstick, a P=1 mesh step"):
        phase_lint(card)
    if start(33, "training stack, StarCoder2-3B at published widths: gradients card vs CPU, "
                 "learning, 30 layers bf16 at 2 x 4096, the train driver with a restart, the "
                 "compressed step at P=1 over NCCL"):
        phase_train(card)
    if start(34, "a traced train step, StarCoder2-3B (30 layers, bf16, remat), 2 x 4096"):
        phase_train_trace(card)
    if start(35, "the dry run on the card's machine: a decode, a prefill and a train cell on "
                 "the fake 16 x 16 mesh, no device"):
        phase_dryrun()
    ends = sorted(begun.values())[1:] + [time.time()]
    print("phase seconds: " + ", ".join(f"{n} {end - t:.1f}" for (n, t), end
                                        in zip(sorted(begun.items(), key=lambda kv: kv[1]), ends))
          + f" | whole run {time.time() - t0:.1f} s, the build included")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print(f"  {f}", file=sys.stderr)
        return 1
    replaces = {
        "splitk_gemm": ("src/repro_torch/kernels/csrc/splitk_gemm.cu",
                        "src/repro/kernels/splitk_gemm.py:37"),
        # no Pallas kernel: the reference's XLA einsum over the remote experts
        "splitk_gemm_grouped": ("src/repro_torch/kernels/csrc/splitk_gemm.cu",
                                "src/repro/models/layers.py:440"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_flashattn.cu",
                            "src/repro/kernels/splitk_flashattn.py:236"),
        "splitk_flashattn": ("src/repro_torch/kernels/csrc/splitk_flashattn.cu",
                             "src/repro/kernels/splitk_flashattn.py:33"),
        "flash_prefill": ("src/repro_torch/kernels/csrc/flash_prefill.cu",
                          "src/repro/kernels/flash_prefill.py:30"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        s = step.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": launches.get(name),
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": s.get("ms"), "plain_ms": s.get("plain_ms"), "bound_ms": s.get("bound_ms"),
            "bound_by": (None if not s else
                         "bytes" if s["t_bytes"] >= s["t_ops"] else "operations"),
            "library_ms": s.get("library_ms"),
        })
    print("kernel times: splitk_gemm and paged_attention per decode step of the served run "
          "(batch 4, 32 layers + lm_head), splitk_gemm_grouped per Qwen3-30B-A3B decode step "
          f"(48 layers, {QWEN3_ACTIVE} of 64 remote experts active), splitk_flashattn per "
          "batch-split decode step (32 layers, kv_len 288), flash_prefill per call at B=4 "
          "T=2048 causal; launches: the first path run that launched each kernel "
          "(splitk_gemm and paged_attention in phase 4, splitk_gemm_grouped in phase 12, or "
          "the first other served phase that ran; splitk_flashattn in phase 7, flash_prefill "
          "in phase 8); "
          "max_abs_err is over the bf16 full-width shape checks")
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
