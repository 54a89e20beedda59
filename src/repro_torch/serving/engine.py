"""Batched serving engine with DAK tiered offloading, static path.

Counterpart of ``src/repro/serving/engine.py`` for every decoder family
(dense, VLM, MoE, MLA, SSM and hybrid): ragged continuous batching over
``max_batch`` slots and greedy sampling.  Offloading is planned once at
startup (`core.engine.plan`) and realized layer by layer by
``TieringPlan.partition_source``: on a CUDA device every remote tier goes
to pinned, device-mapped host memory and every local tier stays on the
card, so a model whose weights do not fit in HBM can be served.

Admission and prefill slicing belong to a pluggable scheduler
(`frontend.scheduler`), as in the reference.  The FCFS default prefills
each prompt whole in arrival order.  The priority and SLO schedulers add
chunked prefill, prompts split into per-step token budgets
(`models.prefill_chunk` into a private batch-1 cache, committed to the
slot with the last chunk) between decode steps, and tier-demotion
preemption: under local page pressure a victim's coldest local KV pages
move to the remote pool (`PagedTieredCache.demote_slot_pages`) and it
keeps decoding through the paged kernel, its tokens unchanged.  Per-request
queue delay, TTFT, end-to-end latency and per-class SLO attainment
(`frontend.metrics`) fold into `EngineStats`; a `ModeledClock` prices each
step analytically, so trace replays and scheduler comparisons are
deterministic.

* Prefill runs `models.prefill` (a continuation chunk `prefill_chunk`)
  with the kernel-backed tiered matmul as ``mm``, so the remote weights
  (remote MoE experts included, one at a time) are read in place over the
  host link and never copied into HBM; prefill attention is plain PyTorch.
* Each decode step is `serving.tiered_decode.paged_tiered_decode_step`:
  the tiered GEMM for every tiered weight plus the paged tiered attention
  kernel over `serving.paged_cache.PagedTieredCache`.  MLA caches its
  latent ``[ckv | k_rope]`` as one kv head of width rank + rd, K only.
  A pure SSM has no page cache: its step is `tiered_ssm_decode_step` over
  the per-slot conv window and SSD state in HBM.  A hybrid pages the K/V
  of its shared blocks, one cache layer per group, and keeps the SSM state
  beside it (`tiered_hybrid_decode_step`).

The encoder has no decode step and is refused (`models.require_served`);
it runs through `models.forward`.  Not ported yet: the adaptive runtime,
elastic degradation (a ``CacheFull`` surfaces; the scheduler's admission
quota always sees the health state ``healthy``), the mesh, the compiled
step and observability.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine as offload_engine
from repro_torch.core.ebmodel import WorkloadSpec
from repro_torch.core.hardware import H100_SXM, HardwareSpec
from repro_torch.frontend.metrics import (
    Clock,
    ModeledClock,
    RequestRecord,
    WallClock,
    modeled_step_cost,
    percentile,
    slo_report,
)
from repro_torch.frontend.scheduler import Scheduler, get_scheduler
from repro_torch.models import model as M
from repro_torch.runtime.telemetry import weight_tier_bytes
from repro_torch.serving import tiered_decode as TD
from repro_torch.serving.paged_cache import PagedTieredCache


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is the default everywhere;
    asking for it without a card raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch path on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                     # [T] int32
    max_new_tokens: int = 16
    eos_id: int = -1                       # -1: never stop early
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    # -- scheduling metadata (frontend) --------------------------------
    cls: str = "default"                   # tenant / priority class name
    priority: int = 0                      # higher = more urgent
    arrival_s: float | None = None         # trace arrival (clock seconds);
    #                                        None = ready at submit
    slo_ttft_s: float | None = None        # TTFT SLO (None = best effort)
    t_admit: float = 0.0                   # first prefill chunk scheduled
    preemptions: int = 0                   # tier-demotion preemptions suffered


@dataclasses.dataclass
class PrefillState:
    """An in-flight prefill: a split prompt fills a private batch-1 cache
    chunk by chunk (`models.prefill_chunk`); the last chunk commits it to
    the slot and the request joins the decode batch."""
    req: Request
    cache: dict[str, torch.Tensor] | None = None   # made by a split prompt's first chunk
    pos: int = 0                           # prompt tokens processed so far
    logits: torch.Tensor | None = None     # last chunk's final-position logits


@dataclasses.dataclass
class EngineStats:
    served: int = 0
    generated_tokens: int = 0              # tokens actually emitted (all reqs)
    decode_steps: int = 0
    decode_time: float = 0.0
    prefill_time: float = 0.0
    local_pages_hwm: int = 0               # peak pages resident per tier
    remote_pages_hwm: int = 0
    spills: int = 0                        # pressure-driven local->remote moves
    prefill_chunks: int = 0                # continuation chunks (beyond the first)
    prefill_passes: list[int] = dataclasses.field(default_factory=list)
    # prompt rows of each prefill pass (a whole prompt or one chunk)
    preemptions: int = 0                   # tier-demotion preemption events
    preempt_demoted_pages: int = 0         # pages demoted by preemptions
    ttfts: list[float] = dataclasses.field(default_factory=list)
    queue_delays: list[float] = dataclasses.field(default_factory=list)
    e2e_latencies: list[float] = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)

    @property
    def tpot(self) -> float:
        return self.decode_time / max(1, self.decode_steps)

    @property
    def ttft_p50(self) -> float:
        return percentile(self.ttfts, 50)

    @property
    def ttft_p95(self) -> float:
        return percentile(self.ttfts, 95)

    @property
    def queue_delay_p50(self) -> float:
        return percentile(self.queue_delays, 50)

    @property
    def queue_delay_p95(self) -> float:
        return percentile(self.queue_delays, 95)

    @property
    def e2e_p50(self) -> float:
        return percentile(self.e2e_latencies, 50)

    @property
    def e2e_p95(self) -> float:
        return percentile(self.e2e_latencies, 95)

    def slo_report(self) -> dict:
        """Per-tenant-class SLO attainment and latency percentiles
        (`frontend.metrics.slo_report` over the request records)."""
        return slo_report(self.requests)


class ServingEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict[str, Any] | M.LayerSource,
        *,
        max_batch: int = 4,
        max_len: int = 128,
        hw: HardwareSpec = H100_SXM,
        hbm_budget_bytes: float | None = None,
        global_offload_ratio: float | None = None,
        page_size: int = 8,
        scheduler: str | Scheduler | None = None,
        prefill_chunk: int | None = None,
        clock: Clock | None = None,
        device="cuda",
    ):
        """``scheduler`` is the frontend policy: a name ('fcfs' | 'priority'
        | 'slo'), a `frontend.scheduler.Scheduler`, or None for FCFS with
        whole prompts.  ``prefill_chunk`` caps the prompt tokens prefilled
        per step when a name is given (an instance carries its own budget).
        ``clock`` stamps the request lifecycle: wall time by default, or a
        `frontend.metrics.ModeledClock` that the engine advances by each
        step's analytical cost.

        ``params`` is the unpartitioned stacked tree (`models.init_params`
        or `bridge.params_from_numpy`) or a `models.model.LayerSource`
        (`models.layer_source`), on ``device``.  Either is partitioned one
        layer at a time (`TieringPlan.partition_source`): the device then
        holds the local tiers and the untiered leaves, every remote tier
        is pinned host memory, and a source never has the unsplit model
        whole on the device.  The engine keeps only the partitioned tree;
        a caller that drops its own reference lets the unsplit weights be
        freed."""
        self.device = resolve_device(device)
        M.require_served(cfg)
        self.cfg = cfg
        self.hw = hw
        self.max_batch = max_batch
        self.max_len = max_len
        self.page_size = page_size
        self.clock = clock if clock is not None else WallClock()
        if isinstance(scheduler, Scheduler):
            self.scheduler = scheduler
        else:
            kw = {"chunk_tokens": prefill_chunk} if prefill_chunk else {}
            self.scheduler = get_scheduler(scheduler or "fcfs", **kw)
        wl = WorkloadSpec(batch=max_batch, seq_len=max_len, phase="decode")
        self.plan = offload_engine.plan(
            cfg, wl, hw, hbm_budget_bytes=hbm_budget_bytes,
            global_ratio=global_offload_ratio, kv_page_size=page_size)
        self.window = self.plan.window.n_inflight
        self._mm = TD.kernel_mm(self.window)   # prefill's GEMMs, as decode's
        self._align = 32 if cfg.d_model < 1024 else 128
        source = params if isinstance(params, M.LayerSource) else M.LayerSource.from_tree(params)
        self.params = self.plan.partition_source(source, align=self._align)
        self._weight_bytes = weight_tier_bytes(self.params)
        self._dtype = source.dtype
        self.pcache: PagedTieredCache | None = None
        self.cache: dict[str, torch.Tensor] | None = None
        if cfg.family in ("ssm", "hybrid"):
            # the recurrent conv window and SSD state of every layer, one row
            # per slot, in HBM (a hybrid's K/V goes to the page cache)
            self.cache = {k: v for k, v in M.init_cache(cfg, max_batch, max_len, self._dtype,
                                                        self.device).items()
                          if k in ("conv", "state")}
        if cfg.family != "ssm":
            self.pcache = self._make_pcache()
        self._t0 = self.clock.now()
        self.lens = np.zeros(max_batch, dtype=np.int32)     # per-slot kv length
        self.active: list[Request | None] = [None] * max_batch
        self.prefilling: dict[int, PrefillState] = {}   # slot -> in-flight prefill
        self.stats = EngineStats()
        self._next_tok = np.zeros((max_batch, 1), dtype=np.int32)

    def _make_pcache(self) -> PagedTieredCache:
        """The paged tiered KV cache at the plan's page budget: one layer
        per decoder layer, or per shared-block group for a hybrid."""
        cfg = self.cfg
        n_layers = cfg.n_layers
        if cfg.family == "hybrid":
            n_layers //= cfg.hybrid_attn_every
        if cfg.use_mla:
            # MLA pages carry the latent [ckv | k_rope] as one kv head,
            # stored once (K-only; the V read aliases the K pool): pool
            # bytes match the planner's per-token KV accounting.
            kv_heads, head_dim = 1, cfg.kv_lora_rank + cfg.rope_head_dim
        else:
            kv_heads, head_dim = cfg.n_kv_heads, cfg.resolved_head_dim
        pp = self.plan.kv_pages
        return PagedTieredCache(
            n_layers, kv_heads, head_dim,
            page_size=self.page_size,
            local_pages=pp.local_pages,
            remote_pages=pp.remote_pages,
            max_slots=self.max_batch,
            max_pages_per_slot=-(-self.max_len // self.page_size),
            dtype=self._dtype,
            store_v=not cfg.use_mla,
            device=self.device)

    @property
    def queue(self) -> deque[Request]:
        """Admissible requests, in arrival order."""
        return self.scheduler.ready

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Hand a request to the scheduler (``arrival_s`` is an offset from
        engine start)."""
        now = self.clock.now()
        if req.arrival_s is not None:
            req.arrival_s = self._t0 + req.arrival_s
        req.t_submit = now
        self.scheduler.submit(req, now)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active)
                if r is None and i not in self.prefilling]

    def _admit(self) -> int:
        """One scheduling round: continue in-flight chunked prefills in the
        scheduler's order, then admit ready requests into free slots, all
        within the scheduler's per-step prompt-token budget (None: whole
        prompts).  Returns the prompt tokens prefilled.  A request whose
        first token is EOS (or whose budget is one token) finishes at its
        last chunk without occupying a slot."""
        prefill_tokens = 0
        sched = self.scheduler
        now = self.clock.now()
        sched.release(now)
        # the queue-depth estimate with no runtime attached, as in the reference
        left = sched.chunk_budget(float(len(sched.ready)))
        for slot in sched.order_prefilling([(s, ps.req) for s, ps in self.prefilling.items()]):
            if left is not None and left <= 0:
                break
            ps = self.prefilling[slot]
            n = len(ps.req.prompt) - ps.pos
            if left is not None:
                n = min(n, left)
                left -= n
            prefill_tokens += n
            self._run_prefill_chunk(slot, ps, n)
        # The elastic health ladder is not ported: the quota sees "healthy".
        # An idle engine always admits.
        quota = sched.admission_quota("healthy")
        if (quota == 0 and not self.prefilling
                and not any(r is not None for r in self.active)):
            quota = 1
        while sched.ready and (left is None or left > 0):
            if quota is not None and quota <= 0:
                break
            free = self._free_slots()
            if not free:
                break
            req = sched.select(now)
            slot = free[0]
            req.t_admit = now
            self.stats.queue_delays.append(req.t_admit - req.t_submit)
            if quota is not None:
                quota -= 1
            if self.pcache is not None and sched.preemptive:
                self._maybe_preempt(req)
            ps = PrefillState(req=req)
            self.prefilling[slot] = ps
            n = len(req.prompt)
            if left is not None:
                n = min(n, left)
                left -= n
            prefill_tokens += n
            self._run_prefill_chunk(slot, ps, n)
        return prefill_tokens

    def _run_prefill_chunk(self, slot: int, ps: PrefillState, n: int) -> None:
        """Prefill `n` prompt tokens of the slot's in-flight prefill.  A
        whole prompt in one chunk runs `models.prefill`; otherwise each
        chunk runs `models.prefill_chunk` on the request's private cache.
        The last chunk commits: the first token is sampled from its final
        logits, the cache written to the slot, and the request joins the
        decode batch."""
        req = ps.req
        t0 = time.time()
        chunk = torch.as_tensor(req.prompt[ps.pos:ps.pos + n], dtype=torch.int32,
                                device=self.device)[None, :]
        if ps.pos == 0 and n == len(req.prompt):
            ps.logits, ps.cache = M.prefill(self.cfg, self.params, {"tokens": chunk},
                                            max_len=self.max_len, mm=self._mm)
        else:
            if ps.cache is None:           # first chunk of a split prompt
                ps.cache = M.init_cache(self.cfg, 1, self.max_len, self._dtype, self.device)
            ps.logits, ps.cache = M.prefill_chunk(self.cfg, self.params, ps.cache, chunk,
                                                  ps.pos, mm=self._mm)
            self.stats.prefill_chunks += 1
        ps.pos += n
        if self.clock.kind == "wall" and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the chunk's time, not its launch's
        self.stats.prefill_time += time.time() - t0
        self.stats.prefill_passes.append(n)
        self._clock_tick_prefill(n)
        if ps.pos < len(req.prompt):
            return
        del self.prefilling[slot]
        nxt = int(torch.argmax(ps.logits[0, -1]))
        req.out_tokens.append(nxt)
        self.stats.generated_tokens += 1
        req.t_first = self.clock.now()
        self.stats.ttfts.append(req.t_first - req.t_submit)
        if nxt == req.eos_id or req.max_new_tokens <= 1:
            self._finish_request(req)      # slot stays free for the next
            return
        if self.pcache is not None and self.scheduler.preemptive:
            # The shortfall was demoted at admission, but a split prompt
            # allocates its pages only now, steps later: other slots' decode
            # growth may have taken the freed pages in between.  (A no-op for
            # a whole prompt: nothing allocated since the admission check.)
            self._maybe_preempt(req)
        self._write_slot_cache(slot, ps.cache, len(req.prompt))
        self.lens[slot] = len(req.prompt)
        self._next_tok[slot, 0] = nxt
        self.active[slot] = req
        self._note_occupancy()

    def _finish_request(self, req: Request) -> None:
        req.t_done = self.clock.now()
        self.stats.served += 1
        self.stats.e2e_latencies.append(req.t_done - req.t_submit)
        self.stats.requests.append(RequestRecord(
            rid=req.rid, cls=req.cls, priority=req.priority,
            prompt_tokens=len(req.prompt), output_tokens=len(req.out_tokens),
            queue_delay=req.t_admit - req.t_submit,
            ttft=req.t_first - req.t_submit,
            e2e=req.t_done - req.t_submit,
            preemptions=req.preemptions, slo_ttft_s=req.slo_ttft_s))

    def _preempt_shortfall(self, incoming: Request) -> int:
        """Local pages the incoming prompt (and its next decode token)
        still lacks beyond the local free pages.  The reference adds the
        live migrator's headroom when it runs; the port has no migrator."""
        need = -(-(len(incoming.prompt) + 1) // self.page_size)
        return need - self.pcache.local_free

    def _maybe_preempt(self, incoming: Request) -> None:
        """Tier-demotion preemption: while the incoming prompt's pages
        exceed the local free pages, ask the scheduler for a victim and
        demote the shortfall of its local KV pages to the remote pool.  The
        victim keeps decoding through the paged kernel (its tokens
        unchanged, nothing recomputed) and the freed local pages take the
        incoming prompt.  Each candidate is tried once."""
        shortfall = self._preempt_shortfall(incoming)
        tried: set[int] = set()
        while shortfall > 0:
            candidates = [(slot, r) for slot, r in enumerate(self.active)
                          if r is not None and slot not in tried]
            victim = self.scheduler.pick_victim(candidates, incoming)
            if victim is None:
                return
            tried.add(victim)
            moved = self.pcache.demote_slot_pages(victim, max_pages=shortfall)
            if not moved:
                continue               # the victim held no local page to demote
            shortfall -= moved
            self.active[victim].preemptions += 1
            self.stats.preemptions += 1
            self.stats.preempt_demoted_pages += moved

    # -- modeled clock ------------------------------------------------------
    def _clock_tick_prefill(self, n_tokens: int) -> None:
        """Advance a modeled clock by the analytical cost of one prefill
        chunk, before TTFT is stamped (a no-op on the wall clock)."""
        if n_tokens and isinstance(self.clock, ModeledClock):
            self.clock.advance(modeled_step_cost(self.cfg, self.hw, self.plan.op_ratios,
                                                 prefill_tokens=n_tokens).total)

    def _clock_tick_decode(self, active: np.ndarray) -> None:
        """Advance a modeled clock by the analytical cost of one decode step
        over the active slots, the KV read priced from the live page
        residency, so spills and preemption's demotions show in the modeled
        latencies.  No copy traffic is priced (``hbm_copy_bytes`` 0): the
        port's decode step writes each new K/V row into the pools in place,
        as the reference's default compiled step does."""
        n_active = int(active.sum())
        if not n_active or not isinstance(self.clock, ModeledClock):
            return
        kv_local = kv_remote = 0.0
        if self.pcache is not None:
            kv_local, kv_remote = self.pcache.attended_bytes(self.lens, active)
        self.clock.advance(modeled_step_cost(
            self.cfg, self.hw, self.plan.op_ratios, decode_slots=n_active,
            mean_kv_len=float(self.lens[active].mean()),
            kv_local_bytes=kv_local, kv_remote_bytes=kv_remote, hbm_copy_bytes=0.0).total)

    def _write_slot_cache(self, slot: int, cache1: dict[str, torch.Tensor],
                          prompt_len: int) -> None:
        if self.cache is not None:             # conv/state recurrent state
            for name, c in self.cache.items():
                c[:, slot] = cache1[name][:, 0]
        if self.pcache is None:
            return
        self.pcache.ensure_capacity(slot, prompt_len)
        if self.cfg.use_mla:
            ckv = cache1["ckv"][:, 0, :prompt_len]       # [L, T, rank]
            krope = cache1["krope"][:, 0, :prompt_len]   # [L, T, rd]
            self.pcache.write_prompt(slot, torch.cat([ckv, krope], dim=-1)[:, :, None, :])
            return
        self.pcache.write_prompt(
            slot, cache1["k"][:, 0, :prompt_len], cache1["v"][:, 0, :prompt_len])

    def _note_occupancy(self) -> None:
        if self.pcache is None:
            return
        self.stats.local_pages_hwm = max(
            self.stats.local_pages_hwm, self.pcache.local_in_use)
        self.stats.remote_pages_hwm = max(
            self.stats.remote_pages_hwm, self.pcache.remote_in_use)
        self.stats.spills = self.pcache.spills

    # ------------------------------------------------------------------
    def step(self) -> None:
        """One engine step: the scheduler's prefill round (chunks and
        admissions), then one ragged decode step for all active slots."""
        prefill_tokens = self._admit()
        if not any(r is not None for r in self.active):
            if not prefill_tokens and not self.prefilling and self.scheduler.waiting:
                # Idle with an arrival pending: fast-forward the modeled clock
                # to it (a no-op on the wall clock, which polls until then).
                nxt = self.scheduler.next_arrival()
                if nxt is not None:
                    self.clock.advance(max(0.0, nxt - self.clock.now()))
            return
        active = np.array([r is not None for r in self.active])
        dev = self.device
        tokens = torch.tensor(self._next_tok, device=dev)
        t0 = time.time()
        if self.pcache is None:
            # pure SSM: the recurrent tiered step, no KV pages
            logits, self.cache = TD.tiered_ssm_decode_step(
                self.cfg, self.params, self.cache, tokens, window=self.window)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()   # waits for the step
        else:
            self.pcache.touch_step(self.lens, active)
            positions = np.where(active, self.lens, 0).astype(np.int32)
            for slot in np.nonzero(active)[0]:
                self.pcache.ensure_capacity(int(slot), int(self.lens[slot]) + 1)
            self._note_occupancy()
            wr_tier, wr_idx, wr_off = self.pcache.write_targets(self.lens, active)
            table, tier = self.pcache.device_tables()
            attn_lens = np.where(active, self.lens + 1, 0).astype(np.int32)
            paged_args = (tokens, torch.tensor(positions, device=dev),
                          torch.tensor(attn_lens, device=dev), table, tier, wr_tier, wr_idx,
                          wr_off)
            sinks = dict(sink_local=self.pcache.sink_local,
                         sink_remote=self.pcache.sink_remote)
            if self.cfg.family == "hybrid":
                logits, self.cache, pools_out = TD.tiered_hybrid_decode_step(
                    self.cfg, self.params, self.cache, self.pcache.pools, *paged_args,
                    **sinks, window=self.window)
            else:
                logits, pools_out = TD.paged_tiered_decode_step(
                    self.cfg, self.params, self.pcache.pools, *paged_args, **sinks,
                    window=self.window)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()   # waits for the step
            self.pcache.commit_pools(pools_out)
        self.stats.decode_time += time.time() - t0
        self.stats.decode_steps += 1
        self._clock_tick_decode(active)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self.stats.generated_tokens += 1
            self.lens[slot] += 1
            done = (len(req.out_tokens) >= req.max_new_tokens
                    or tok == req.eos_id
                    or self.lens[slot] >= self.max_len - 1)
            if done:
                self._finish_request(req)
                self.active[slot] = None
                self.lens[slot] = 0
                if self.pcache is not None:
                    self.pcache.free_slot(slot)
            else:
                self._next_tok[slot, 0] = tok

    def run(self, max_steps: int = 10_000) -> EngineStats:
        """Drive the engine until every submitted request is served."""
        steps = 0
        while (self.scheduler.waiting or self.prefilling
               or any(r is not None for r in self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return self.stats
