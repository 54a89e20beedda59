"""Batched serving engine with DAK tiered offloading, static path.

Counterpart of ``src/repro/serving/engine.py`` for dense, MoE, MLA, SSM and
hybrid decoders:
ragged continuous batching over ``max_batch`` slots, FCFS admission,
whole-prompt prefill and greedy sampling.  Offloading is planned once at
startup (`core.engine.plan`) and realized layer by layer by
``TieringPlan.partition_source``: on a CUDA device every remote tier goes
to pinned, device-mapped host memory and every local tier stays on the
card, so a model whose weights do not fit in HBM can be served.

* Prefill runs `models.prefill` with the kernel-backed tiered matmul as
  ``mm``, so the remote weights (remote MoE experts included, one at a
  time) are read in place over the host link and never copied into HBM;
  prefill attention is plain PyTorch.
* Each decode step is `serving.tiered_decode.paged_tiered_decode_step`:
  the tiered GEMM for every tiered weight plus the paged tiered attention
  kernel over `serving.paged_cache.PagedTieredCache`.  MLA caches its
  latent ``[ckv | k_rope]`` as one kv head of width rank + rd, K only.
  A pure SSM has no page cache: its step is `tiered_ssm_decode_step` over
  the per-slot conv window and SSD state in HBM.  A hybrid pages the K/V
  of its shared blocks, one cache layer per group, and keeps the SSM state
  beside it (`tiered_hybrid_decode_step`).

Not ported yet: chunked prefill and preemption (the scheduler's other
policies), the adaptive runtime, elastic degradation (a ``CacheFull``
surfaces), the mesh, the compiled step, observability, and the modeled
clock's step pricing.
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
from repro_torch.frontend.metrics import RequestRecord, WallClock, percentile
from repro_torch.frontend.scheduler import Scheduler
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
    arrival_s: float | None = None         # None = ready at submit
    slo_ttft_s: float | None = None        # TTFT SLO (None = best effort)
    t_admit: float = 0.0                   # prefill scheduled
    preemptions: int = 0                   # always 0 on the static path


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
    def e2e_p95(self) -> float:
        return percentile(self.e2e_latencies, 95)


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
        device="cuda",
    ):
        """``params`` is the unpartitioned stacked tree (`models.init_params`
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
        self.clock = WallClock()
        self.scheduler = Scheduler()          # FCFS, whole prompts, no preemption
        wl = WorkloadSpec(batch=max_batch, seq_len=max_len, phase="decode")
        self.plan = offload_engine.plan(
            cfg, wl, hw, hbm_budget_bytes=hbm_budget_bytes,
            global_ratio=global_offload_ratio, kv_page_size=page_size)
        self.window = self.plan.window.n_inflight
        self._align = 32 if cfg.d_model < 1024 else 128
        source = params if isinstance(params, M.LayerSource) else M.LayerSource.from_tree(params)
        self.params = self.plan.partition_source(source, align=self._align)
        self._weight_bytes = weight_tier_bytes(self.params)
        self._dtype = source.top["embed"].dtype
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
        return [i for i, r in enumerate(self.active) if r is None]

    def _admit(self) -> int:
        """Admit ready requests into free slots, prefilling each whole
        prompt.  Returns the number of prompt tokens prefilled."""
        prefill_tokens = 0
        sched = self.scheduler
        now = self.clock.now()
        sched.release(now)
        while sched.ready:
            free = self._free_slots()
            if not free:
                break
            req = sched.select(now)
            req.t_admit = now
            self.stats.queue_delays.append(req.t_admit - req.t_submit)
            prefill_tokens += len(req.prompt)
            self._run_prefill(free[0], req)
        return prefill_tokens

    def _run_prefill(self, slot: int, req: Request) -> None:
        """Prefill one whole prompt, sample its first token, and (unless
        that already finishes it) write its cache into the slot's pages."""
        t0 = time.time()
        prompt = torch.as_tensor(req.prompt, dtype=torch.int32, device=self.device)[None, :]
        # the direct-access GEMM for tiered weights, as in decode
        logits, cache = M.prefill(self.cfg, self.params, {"tokens": prompt},
                                  max_len=self.max_len,
                                  mm=lambda a, w: TD._mm(a, w, self.window))
        nxt = int(torch.argmax(logits[0, -1]))
        self.stats.prefill_time += time.time() - t0
        req.out_tokens.append(nxt)
        self.stats.generated_tokens += 1
        req.t_first = self.clock.now()
        self.stats.ttfts.append(req.t_first - req.t_submit)
        if nxt == req.eos_id or req.max_new_tokens <= 1:
            self._finish_request(req)      # slot stays free for the next
            return
        self._write_slot_cache(slot, cache, len(req.prompt))
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
        """One engine step: admissions (with their prefills), then one
        ragged decode step for all active slots."""
        self._admit()
        if not any(r is not None for r in self.active):
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
        while (self.scheduler.waiting
               or any(r is not None for r in self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return self.stats
