"""Kernel lints (DAK101-103): static checks on the port's CUDA launch geometry.

Counterpart of ``src/repro/analysis/kernel_lints.py`` for the Hopper
kernels.  The direct-access kernels read remote tiles straight into a
shared-memory ring through tensor maps, so three things must hold
statically for every (family, offload ratio) the engine can serve:

- DAK101: a launch's dynamic shared memory fits the per-CTA opt-in limit
  of sm_90, 227 KiB (`SMEM_OPTIN_BYTES`), not the profile's
  ``vmem_bytes`` (the whole chip's shared memory on the H100 profile,
  which no single CTA could reach).  The footprints are the kernels' own
  arithmetic (``kernels.*.smem_footprint_bytes``), and a requested ring
  depth that a kernel silently cuts for lack of shared memory (the
  split-K ring's DSMEM_MAX, the whole-K and attention rings' cap of 8
  loads, the attention ring's RING_MAX) is a finding that names the cut.
  A ring cut to the loads a CTA has is no finding: it loses nothing.
- DAK102: the TMA rules the kernels assume where they read through tensor
  maps: 16-byte aligned bases, row strides of 16-byte multiples, box
  extents of at most 256 elements, a ``k_split`` that is a multiple of
  DECODE_BK, M <= 16 for the split-K design (`splitk_gemm.decode_shapes_ok`,
  the precondition `_decode_operands_ok` checks on tensors), and tiers
  that conserve the split dimension.
- DAK103: grid coverage: the split-K grid ``(n_rem_tiles + n_loc_tiles) x
  splits`` covers N and K exactly, the host-first CTA order is a
  permutation of the tiles and splits, and so is the paged kernel's
  host-first slot order.

Checks take plain launch descriptors, so seeded-violation fixtures can
feed broken geometry without a card.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any

import numpy as np

from repro_torch.analysis.findings import Finding
from repro_torch.core import tiering
from repro_torch.core.engine import TieringPlan
from repro_torch.core.hardware import H100_SXM, HardwareSpec
from repro_torch.kernels import splitk_flashattn, splitk_gemm

# `repro_torch.kernels.__init__` re-exports the `flash_prefill` function,
# which shadows the submodule on attribute import; resolve the module.
flash_prefill = importlib.import_module("repro_torch.kernels.flash_prefill")

SMEM_OPTIN_BYTES = 232448   # dynamic shared memory one CTA may opt into on sm_90 (227 KiB)


@dataclasses.dataclass(frozen=True)
class GemmLaunch:
    """Geometry of one ``splitk_gemm`` launch.  ``k_split`` > 0 is the
    split-K decode design (rows of K per CTA), 0 whole K.  ``aligned``
    says the operands' bases are 16-byte aligned; ``box_n`` x ``box_k``
    is the weight box a split-K load reads; ``grid`` is a recorded CTA
    count (None: the kernel's own)."""
    name: str
    m: int
    k: int
    n_loc: int
    n_rem: int
    k_split: int = 0
    window: int = splitk_gemm.DEFAULT_WINDOW
    dtype_bytes: int = 4
    aligned: bool = True
    box_n: int = splitk_gemm.DECODE_BN
    box_k: int = splitk_gemm.DECODE_BK
    grid: int | None = None


@dataclasses.dataclass(frozen=True)
class AttnLaunch:
    """Geometry of one decode-attention launch.

    ``kind`` is "paged" (``chunk`` = page size, ``n_chunks`` = max pages a
    slot, ``batch`` slots) or "batch" (batch-split caches; ``chunk`` =
    CHUNK rows, ``n_chunks`` = chunks of the attended length).  ``tma``
    says the launch reads through tensor maps (None: as the kernel
    decides from the shapes, with aligned bases)."""
    name: str
    kind: str
    h: int
    kh: int
    hd: int
    chunk: int
    n_chunks: int
    window: int
    dtype_bytes: int = 4
    batch: int = 4
    tma: bool | None = None


@dataclasses.dataclass(frozen=True)
class PrefillLaunch:
    """Geometry of one ``flash_prefill`` launch (its tiles are compiled in:
    128 x 64 in bf16, 64 x 64 in fp32)."""
    name: str
    hd: int
    tq: int
    tk: int
    block_q: int | None = None
    block_k: int | None = None
    dtype_bytes: int = 4


def _dtype_name(dtype_bytes: int) -> str:
    return {2: "bfloat16", 4: "float32", 8: "float64"}.get(dtype_bytes, "float32")


def _smem_finding(site: str, fp: int, hw: HardwareSpec) -> list[Finding]:
    if fp <= SMEM_OPTIN_BYTES:
        return []
    return [Finding("DAK101", site,
                    f"per-CTA shared memory {fp} B exceeds the {SMEM_OPTIN_BYTES} B "
                    f"(227 KiB) a CTA may opt into on {hw.name}",
                    context={"footprint_bytes": fp, "smem_bytes": SMEM_OPTIN_BYTES})]


def _clamp_finding(site: str, window: int, wanted: int, stages: int,
                   cut: str | None) -> list[Finding]:
    """DAK101 for a ring the kernel cuts for lack of shared memory: ``wanted``
    stages at ``window`` loads in flight, ``stages`` run."""
    if cut in (None, "loads", "chunks"):
        return []
    return [Finding("DAK101", site,
                    f"window {window} asks for a ring of {wanted} stages, which the kernel's "
                    f"{cut} clamp cuts to {stages}: the loads in flight it asks for never run",
                    context={"window": window, "stages": stages, "clamp": cut})]


def check_gemm_launch(launch: GemmLaunch, hw: HardwareSpec, *,
                      where: str = "kernel") -> list[Finding]:
    site = f"{where}.gemm[{launch.name}]"
    m, k, n_loc, n_rem, ks = launch.m, launch.k, launch.n_loc, launch.n_rem, launch.k_split
    if min(m, k, launch.window) < 1 or min(n_loc, n_rem) < 0 or n_loc + n_rem < 1:
        return [Finding("DAK102", site,
                        f"degenerate launch (M={m}, K={k}, N_loc={n_loc}, N_rem={n_rem}, "
                        f"window={launch.window})")]
    if ks < 0 or ks % splitk_gemm.DECODE_BK:
        return [Finding("DAK102", site,
                        f"k_split={ks} is not 0 or a multiple of DECODE_BK="
                        f"{splitk_gemm.DECODE_BK}: splits start at load boundaries")]
    out: list[Finding] = []
    if ks > 0:
        # DAK102: the split-K design reads every operand through a tensor map
        db = launch.dtype_bytes
        bad = [f"{lbl}={v} elements ({v * db} B)" for lbl, v in
               (("K", k), ("N_loc", n_loc), ("N_rem", n_rem)) if v * db % 16]
        if m > splitk_gemm.DECODE_MAX_M:
            bad.append(f"M={m} > {splitk_gemm.DECODE_MAX_M}")
        if not launch.aligned:
            bad.append("a base not 16-byte aligned")
        if max(launch.box_n, launch.box_k) > splitk_gemm.TMA_BOX_MAX or \
                min(launch.box_n, launch.box_k) < 1:
            bad.append(f"box {launch.box_n} x {launch.box_k} beyond "
                       f"{splitk_gemm.TMA_BOX_MAX} elements a side")
        if bad:
            out.append(Finding(
                "DAK102", site,
                f"the split-K design's tensor maps cannot take {', '.join(bad)}: rows must "
                "be 16-byte multiples on 16-byte aligned bases, boxes at most 256 a side"))
            return out
    # DAK101: the launch's shared memory, and a ring cut for lack of it
    db = launch.dtype_bytes
    fp = splitk_gemm.smem_footprint_bytes(m, k, n_loc, n_rem, window=launch.window,
                                          k_split=ks, dtype=db)
    out.extend(_smem_finding(site, fp, hw))
    stages, cut = splitk_gemm.ring_stages(m, k, window=launch.window, k_split=ks, dtype=db)
    out.extend(_clamp_finding(site, launch.window, launch.window, stages, cut))
    # DAK103: the grid covers N and K exactly, in a host-first permutation
    bn = splitk_gemm.DECODE_BN
    n_loc_tiles, n_rem_tiles = -(-n_loc // bn), -(-n_rem // bn)
    splits = -(-k // ks) if ks > 0 else 1
    m_tiles = 1 if ks > 0 else -(-m // splitk_gemm._whole_k_bm(m))
    want = (n_loc_tiles + n_rem_tiles) * splits * m_tiles
    grid = want if launch.grid is None else launch.grid
    k_cover = splits * ks if ks > 0 else k
    if grid != want or (ks > 0 and not (k_cover >= k > (splits - 1) * ks)):
        out.append(Finding(
            "DAK103", site,
            f"grid of {grid} CTAs does not cover N={n_loc}+{n_rem} in tiles of {bn} x K={k} "
            f"in {splits} split(s) of {ks or k} rows x {m_tiles} M tile(s) exactly "
            f"(want {want}: OOB or dead blocks)"))
    order = splitk_gemm.host_first_order(n_loc_tiles, n_rem_tiles, splits)
    out.extend(check_order_permutation(order, (n_loc_tiles + n_rem_tiles) * splits, where=site))
    return out


def _attn_tma(launch: AttnLaunch) -> bool:
    """Whether the kernel reads this launch through tensor maps (aligned
    bases assumed): rows of 16-byte multiples and hd within a box."""
    ok = launch.hd * launch.dtype_bytes % 16 == 0 and launch.hd <= splitk_gemm.TMA_BOX_MAX
    if launch.kind == "paged":
        ok = ok and launch.chunk <= splitk_gemm.TMA_BOX_MAX
    return ok


def check_attn_launch(launch: AttnLaunch, hw: HardwareSpec, *,
                      where: str = "kernel") -> list[Finding]:
    site = f"{where}.attn[{launch.name}]"
    out: list[Finding] = []
    if launch.chunk < 1 or launch.window < 1 or launch.n_chunks < 1 or launch.batch < 1:
        out.append(Finding("DAK102", site,
                           f"degenerate launch (chunk={launch.chunk}, "
                           f"window={launch.window}, n_chunks={launch.n_chunks})"))
        return out
    if launch.kh < 1 or launch.h % launch.kh:
        out.append(Finding("DAK102", site,
                           f"q heads {launch.h} not divisible by kv heads "
                           f"{launch.kh} (group-major GQA)"))
        return out
    if not 1 <= launch.hd <= splitk_flashattn.MAX_HEAD_DIM:
        out.append(Finding("DAK102", site,
                           f"hd={launch.hd} outside the kernels' 1..{splitk_flashattn.MAX_HEAD_DIM}"))
        return out
    if launch.tma and not _attn_tma(launch):
        out.append(Finding(
            "DAK102", site,
            f"a tensor map cannot read {launch.chunk} x {launch.hd} boxes of "
            f"{launch.dtype_bytes}-byte elements: rows must be 16-byte multiples and a box "
            f"at most {splitk_gemm.TMA_BOX_MAX} a side"))
        return out
    db = launch.dtype_bytes
    if launch.kind == "paged":
        fp = splitk_flashattn.paged_smem_footprint_bytes(
            launch.batch, launch.h, launch.kh, launch.hd, launch.chunk, launch.n_chunks,
            window=launch.window, dtype=db)
    else:
        fp = splitk_flashattn.smem_footprint_bytes(
            launch.h, launch.kh, launch.hd, launch.chunk * launch.n_chunks,
            window=launch.window, dtype=db)
    out.extend(_smem_finding(site, fp, hw))
    box = splitk_flashattn._box_bytes(launch.chunk, launch.hd, launch.dtype_bytes)
    stages, cut = splitk_flashattn.ring_stages(launch.window, 2 * box, launch.n_chunks)
    out.extend(_clamp_finding(site, launch.window, launch.window + 1, stages, cut))
    return out


def check_prefill_launch(launch: PrefillLaunch, hw: HardwareSpec, *,
                         where: str = "kernel") -> list[Finding]:
    site = f"{where}.prefill[{launch.name}]"
    out: list[Finding] = []
    dt = _dtype_name(launch.dtype_bytes)
    tiles = flash_prefill.tiles(dt)
    given = (launch.block_q or tiles[0], launch.block_k or tiles[1])
    if launch.tq < 1 or launch.tk < 1 or not 1 <= launch.hd <= 256:
        out.append(Finding("DAK102", site,
                           f"T={launch.tq}/{launch.tk}, hd={launch.hd}: the kernel takes "
                           "T >= 1 and hd <= 256"))
        return out
    if given != tiles:
        out.append(Finding(
            "DAK102", site,
            f"tiles {given[0]} x {given[1]} are not the {tiles[0]} x {tiles[1]} the {dt} "
            "kernel is compiled with"))
        return out
    out.extend(_smem_finding(site, flash_prefill.smem_footprint_bytes(launch.hd, dtype=dt), hw))
    # DAK103: the q-tile axis of the grid (blockIdx.z) reaches every tile
    if -(-launch.tq // tiles[0]) > 65535:
        out.append(Finding("DAK103", site,
                           f"{-(-launch.tq // tiles[0])} q tiles exceed the grid's 65535"))
    return out


def check_order_permutation(order: np.ndarray, n: int, *,
                            where: str = "kernel") -> list[Finding]:
    """DAK103 core: a schedule array must be a permutation of range(n):
    a duplicate computes one tile twice and leaves another dead."""
    order = np.asarray(order)
    if order.shape != (n,) or sorted(order.tolist()) != list(range(n)):
        return [Finding(
            "DAK103", f"{where}.order",
            f"schedule {order.tolist()} is not a permutation of 0..{n - 1} "
            "(dead or doubly-written tiles)")]
    return []


def check_paged_slot_order(tier: np.ndarray, lens: np.ndarray,
                           page_size: int, *, where: str = "kernel") -> list[Finding]:
    """DAK103 for the paged attention schedule: the host-first slot order
    the kernel derives must permute the slot ids for any tier/lens state."""
    order = splitk_flashattn.host_first_slot_order(tier, lens, page_size)
    return check_order_permutation(order, tier.shape[0],
                                   where=f"{where}.paged_slot_order")


def check_autotune_table(
        entries: list[dict[str, Any]], hw: HardwareSpec | None = None, *,
        where: str = "autotune", default_window: int = 2,
        batch: int = 4) -> list[Finding]:
    """DAK101-103 over a persisted autotune table (the JSON cache written
    by `kernels.autotune.Autotuner.save`): rebuild each tuned winner's
    launch descriptor from its (op, shape, config) entry and run the same
    lints the engine's launches get, so a hand-edited or stale cache cannot
    smuggle a launch past them.

    ``hw`` overrides the per-entry hardware profile; by default each entry
    is linted against the profile it was tuned for.  Entries with
    ``config: null`` are negative-cache markers (nothing is launched for
    them) and are skipped.  ``default_window`` is the ring depth for an
    attention entry whose config carries none; ``batch`` the slots of a
    paged launch (its page list is in shared memory)."""
    from repro_torch.core.hardware import SYSTEMS

    out: list[Finding] = []
    for i, d in enumerate(entries):
        op = d.get("op")
        config = d.get("config")
        if config is None:
            continue
        site = f"{where}.table[{i}:{op}]"
        ehw = hw if hw is not None else SYSTEMS.get(str(d.get("hw")))
        if ehw is None:
            out.append(Finding("DAK102", site,
                               f"unknown hardware profile {d.get('hw')!r}"))
            continue
        try:
            shape = [int(s) for s in d["shape"]]
            db = splitk_gemm.elem_bytes(d.get("dtype", "float32"))
            if op == "splitk_gemm":
                m, k, n_loc, n_rem = shape
                out.extend(check_gemm_launch(GemmLaunch(
                    name=str(op), m=m, k=k, n_loc=n_loc, n_rem=n_rem,
                    k_split=int(config["k_split"]), window=int(config["window"]),
                    dtype_bytes=db), ehw, where=site))
            elif op == "splitk_flashattn":
                h, kh, hd, s = shape
                out.extend(check_attn_launch(AttnLaunch(
                    name=str(op), kind="batch", h=h, kh=kh, hd=hd,
                    chunk=splitk_flashattn.CHUNK,
                    n_chunks=max(1, -(-s // splitk_flashattn.CHUNK)),
                    window=int(config.get("slots", default_window)), dtype_bytes=db),
                    ehw, where=site))
            elif op == "paged_splitk_flashattn":
                h, kh, hd, page_size, max_pages = shape
                out.extend(check_attn_launch(AttnLaunch(
                    name=str(op), kind="paged", h=h, kh=kh, hd=hd,
                    chunk=page_size, n_chunks=max_pages,
                    window=int(config.get("slots", default_window)), dtype_bytes=db,
                    batch=batch), ehw, where=site))
            elif op == "flash_prefill":
                hd, tq, tk = shape
                out.extend(check_prefill_launch(PrefillLaunch(
                    name=str(op), hd=hd, tq=tq, tk=tk, block_q=int(config["block_q"]),
                    block_k=int(config["block_k"]), dtype_bytes=db), ehw, where=site))
            else:
                out.append(Finding("DAK102", site, f"unknown op {op!r}"))
        except (KeyError, ValueError, TypeError) as exc:
            out.append(Finding("DAK102", site, f"malformed entry: {exc!r}"))
    return out


# --------------------------------------------------------------------------
# Building launch descriptors from a plan + abstract operand shapes
# --------------------------------------------------------------------------
def operand_shapes(cfg) -> dict[str, tuple[int, ...]]:
    """Registry ``path_str`` -> full (unsplit) leaf shape, from the meta
    device: the reference's ``analysis.surface.operand_shapes``."""
    from repro_torch.models import model as M
    from repro_torch.models.registry import operand_registry, resolve

    src = M.layer_source(cfg, None, device="meta")
    params = {**src.top, "layers": {k: (src.n_layers, *v.shape) for k, v in src.shapes.items()}}
    shapes: dict[str, tuple[int, ...]] = {}
    for od in operand_registry(cfg):
        try:
            leaf = resolve(params, od.path)
        except KeyError:
            continue  # registry names an optional leaf this config lacks
        shapes[od.path_str] = tuple(leaf if isinstance(leaf, tuple) else leaf.shape)
    return shapes


def check_alignment_invariants(
        plan: TieringPlan, shapes: dict[str, tuple[int, ...]], *,
        align: int, where: str = "plan") -> list[Finding]:
    """DAK102 over the partitioner's postconditions: every realized remote
    extent is a multiple of ``lcm(align, P)`` ("execution-wave alignment",
    paper §4.1) and the tiers conserve the dimension exactly."""
    out: list[Finding] = []
    mesh_div = (plan.mesh.n_devices
                if plan.mesh is not None and plan.mesh.n_devices > 1 else 1)
    for od in plan.registry:
        ratio = plan.op_ratios.get(od.op, 0.0)
        if ratio <= 0.0 or od.path_str not in shapes:
            continue
        dim = shapes[od.path_str][od.axis]
        align_eff = od.align if od.align is not None else align
        align_eff = math.lcm(align_eff, mesh_div)
        n_local, n_remote = tiering.split_sizes(dim, ratio, align_eff)
        site = f"{where}.split[{od.path_str}]"
        if n_local + n_remote != dim:
            out.append(Finding("DAK102", site,
                               f"tiers leak the dimension: {n_local} + "
                               f"{n_remote} != {dim}"))
        if n_remote % align_eff:
            out.append(Finding(
                "DAK102", site,
                f"remote extent {n_remote} not a multiple of the effective "
                f"alignment {align_eff} (align={od.align or align}, "
                f"P={mesh_div})"))
        if not 0 <= n_remote <= dim:
            out.append(Finding("DAK102", site,
                               f"remote extent {n_remote} outside [0, {dim}]"))
    return out


def _attention_shape(cfg) -> tuple[int, int, int]:
    """(query heads, kv heads, head dim) of a decode-attention launch as the
    engine makes it: MLA's latent pages are one kv head of rank + rd under
    every query head; GQA's query heads are the padded ones."""
    if getattr(cfg, "use_mla", False):
        return cfg.n_heads, 1, cfg.kv_lora_rank + cfg.rope_head_dim
    return cfg.padded_heads, cfg.n_kv_heads, cfg.resolved_head_dim


def describe_launches(
        cfg, plan: TieringPlan, shapes: dict[str, tuple[int, ...]], *,
        align: int, batch: int, max_len: int,
        dtype_bytes: int = 4, tuner: Any = None, hw: HardwareSpec = H100_SXM,
) -> tuple[list[GemmLaunch], list[AttnLaunch], list[PrefillLaunch]]:
    """Replay the serving engine's kernel launches statically: every
    column-split operand the plan tiers reaches ``splitk_gemm`` (M =
    ``batch``, the decode step's rows; either tier may be empty), in the
    wrapper's own design (its split from ``hw``'s SM count) or, with a
    ``tuner``, the tuned one; plus the
    paged decode attention and, for GQA, the batch-split attention and
    flash_prefill launches implied by the KV page plan.  Expert stacks
    split along the expert axis run the grouped entry, which takes no
    tuned knob, and are not described."""
    window = max(1, plan.window.n_inflight)
    dt = _dtype_name(dtype_bytes)
    gemms: list[GemmLaunch] = []
    mesh_div = (plan.mesh.n_devices
                if plan.mesh is not None and plan.mesh.n_devices > 1 else 1)
    for od in plan.registry:
        ratio = plan.op_ratios.get(od.op, 0.0)
        if ratio <= 0.0 or od.path_str not in shapes:
            continue
        shape = shapes[od.path_str]
        if od.axis % len(shape) != len(shape) - 1:
            continue  # expert-stack splits run the grouped entry
        dim, k = shape[-1], shape[-2]
        align_eff = math.lcm(od.align if od.align is not None else align, mesh_div)
        n_loc, n_rem = tiering.split_sizes(dim, ratio, align_eff)
        if n_rem == 0:
            continue  # untiered: a plain product
        k_split = splitk_gemm.default_k_split(batch, k, n_loc, n_rem, dtype_bytes,
                                              splitk_gemm.sm_count(hw))
        gwin = window
        if tuner is not None and n_loc and n_rem:
            tuned = tuner.best_gemm(batch, k, n_loc, n_rem, dt)
            if tuned is not None:
                k_split, gwin = tuned["k_split"], tuned["window"]
        gemms.append(GemmLaunch(name=od.path_str, m=batch, k=k, n_loc=n_loc, n_rem=n_rem,
                                k_split=k_split, window=gwin, dtype_bytes=dtype_bytes))

    attns: list[AttnLaunch] = []
    prefills: list[PrefillLaunch] = []
    kp = plan.kv_pages
    if kp is not None and getattr(cfg, "has_decoder", True):
        h, kh, hd = _attention_shape(cfg)
        max_pages = -(-max_len // kp.page_size)
        paged_window = window
        if tuner is not None:
            tuned = tuner.best_paged(h, kh, hd, kp.page_size, max_pages, 0.5, dt)
            if tuned is not None:
                paged_window = max(1, min(window, tuned["slots"]))
        attns.append(AttnLaunch(
            name="paged_decode", kind="paged", h=h, kh=kh, hd=hd,
            chunk=kp.page_size, n_chunks=max_pages, window=paged_window,
            dtype_bytes=dtype_bytes, batch=batch))
        if not getattr(cfg, "use_mla", False):
            batch_window = window
            if tuner is not None:
                tuned = tuner.best_attn(h, kh, hd, max_len, 0.5, dt)
                if tuned is not None:
                    batch_window = max(1, min(window, tuned["slots"]))
            attns.append(AttnLaunch(
                name="batch_decode", kind="batch", h=h, kh=kh, hd=hd,
                chunk=splitk_flashattn.CHUNK,
                n_chunks=-(-max_len // splitk_flashattn.CHUNK), window=batch_window,
                dtype_bytes=dtype_bytes, batch=batch))
        bq = bk = None
        if tuner is not None:
            tuned = tuner.best_prefill(cfg.resolved_head_dim, max_len, max_len, dt)
            if tuned is not None:
                bq, bk = tuned["block_q"], tuned["block_k"]
        prefills.append(PrefillLaunch(name="flash_prefill", hd=cfg.resolved_head_dim,
                                      tq=max_len, tk=max_len, block_q=bq, block_k=bk,
                                      dtype_bytes=dtype_bytes))
    return gemms, attns, prefills


def check_kernels(cfg, plan: TieringPlan, hw: HardwareSpec,
                  shapes: dict[str, tuple[int, ...]], *,
                  align: int, batch: int = 4, max_len: int = 256,
                  where: str = "kernel", tuner: Any = None,
                  dtype_bytes: int = 4) -> list[Finding]:
    """All kernel lints for one (cfg, plan) point of the matrix.  With a
    ``tuner`` the launch descriptors carry its tuned knobs."""
    out = check_alignment_invariants(plan, shapes, align=align, where=where)
    gemms, attns, prefills = describe_launches(
        cfg, plan, shapes, align=align, batch=batch, max_len=max_len,
        dtype_bytes=dtype_bytes, tuner=tuner, hw=hw)
    for g in gemms:
        out.extend(check_gemm_launch(g, hw, where=where))
    for a in attns:
        out.extend(check_attn_launch(a, hw, where=where))
    for p in prefills:
        out.extend(check_prefill_launch(p, hw, where=where))
    if plan.kv_pages is not None:
        # Representative ragged page-table states: all-local, all-remote,
        # mixed; the schedule must permute the slots in every one.
        ps = plan.kv_pages.page_size
        mp = max(1, -(-max_len // ps))
        lens = np.arange(1, batch + 1) * ps // 2
        for tag, tier in (("local", np.zeros((batch, mp), np.int32)),
                          ("remote", np.ones((batch, mp), np.int32)),
                          ("mixed", np.arange(batch * mp).reshape(batch, mp) % 2)):
            out.extend(check_paged_slot_order(
                tier, lens, ps, where=f"{where}[{tag}]"))
    return out
