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
  (remote MoE experts included, through the grouped GEMM) are read in
  place over the host link and never copied into HBM; prefill attention is
  plain PyTorch.
* Each decode step is `serving.tiered_decode.paged_tiered_decode_step`:
  the tiered GEMM for every tiered weight plus the paged tiered attention
  kernel over `serving.paged_cache.PagedTieredCache`.  MLA caches its
  latent ``[ckv | k_rope]`` as one kv head of width rank + rd, K only.
  A pure SSM has no page cache: its step is `tiered_ssm_decode_step` over
  the per-slot conv window and SSD state in HBM.  A hybrid pages the K/V
  of its shared blocks, one cache layer per group, and keeps the SSM state
  beside it (`tiered_hybrid_decode_step`).

With ``adaptive=True`` (or a ``runtime``) the engine closes the loop
through the adaptive runtime (`repro_torch.runtime`): every step it reports
a telemetry sample (bytes per tier, queue depth, prefill/decode token mix)
to a `RuntimeController`, reads back the AIMD-controlled in-flight window
(threaded into the next step's kernels, prefill's GEMMs included), lets the
budgeted migrator move KV pages between tiers and, when the observed
workload mix drifts, swaps in incrementally repartitioned params.  The
default measurement source is the analytical model, as in the reference; a
`runtime.telemetry.CudaEventSource` closes the loop over each decode step's
bandwidth, timed on the card.  With every runtime budget at zero the
adaptive engine emits the static engine's tokens.

Elastic degradation (never-OOM) is the reference's: a ``CacheFull`` grows
the remote pool, demotes the coldest pages and asks the runtime for a
re-plan at a higher offload ratio; a local-budget shrink
(`schedule_hbm_shrink`) is drained the same way, under the health ladder
``healthy -> spilling -> recovering`` that gates the scheduler's admission
quota.

The decode step is compiled by default (``jit_step``): one CUDA graph per
(kind, window bucket, pool shape) bucket, the reference's jit key
(`serving.compiled_step`).  Its int32 inputs reach fixed device buffers by
one staged copy and its greedy tokens come back by one, on the graphed and
the eager path alike.  A graph holds the addresses it was captured with,
so a re-plan that moves weights or a grown remote pool drops the graphs,
and the next step of a bucket captures again (``recaptures``).  Every
family is graphed, MoE and MLA + MoE included: their remote experts run
through one grouped launch per matrix whose expert counts stay on the
device.

``check_invariants`` audits the page table after every step
(`repro_torch.analysis.page_table`, DAK301-305): a graphed step reads the
table from fixed device buffers, staged from the host table that
demotion, migration, pool growth and preemption rewrite.  The audit reads
host state only and raises `InvariantViolation` on the first finding.

Observability is the reference's (`repro_torch.obs`): a trace recorder
(request lifecycle, admission, prefill, decode and compile spans, counter
tracks, health, elastic and runtime instants), a flight recorder that dumps
the last steps' state on an error or an SLO breach, and an attribution
profiler over the modeled step cost.  All default off, and off they leave
tokens and stats bit-identical.

A ``tuner`` (`kernels.autotune.Autotuner`) gives every decode step's
kernels their tuned knobs (the GEMM's design and ring depth, a cap on the
attention's window), looked up as the reference's jitted step does: a
graphed bucket asks while it first runs, and its replays ask nothing.
``use_kernels=False`` is the reference's oracle path: the untiered tree on
the device, the dense cache, `models.prefill` and `models.decode_step`,
no graph; the plan still prices the modeled clock.

With a ``mesh`` (`launch.mesh.Mesh`) the engine serves one replica across
P ranks, one process each, every rank running the same engine on the same
requests (scheduling is deterministic, so every rank emits the same
tokens).  This is the reference's fetch-once serving mode (paper §4.3.2):
the plan is solved on the aggregate of the P host links, each rank builds
and pins only its 1/P slice of every remote partition and of every remote
KV page (`launch.sharding`, `PagedTieredCache`'s sharded mode), and each
step copies its slice up its own host link and one all-gather over the
mesh rebuilds the whole remote tier in fixed device buffers that the
kernels read (`tiered_decode.fetch_remote_shards`).  Each offloaded byte so
crosses one host link a step; the traffic accounting and the adaptive
runtime keep one figure and one congestion window per link.  The gathers
run before a graphed step and outside it, into buffers whose addresses
the graph holds.

The encoder has no decode step and is refused (`models.require_served`);
it runs through `models.forward`.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.page_table import InvariantViolation, check_page_table
from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine as offload_engine
from repro_torch.core import multicast
from repro_torch.core.ebmodel import WorkloadSpec
from repro_torch.core.hardware import H100_SXM, HardwareSpec, MeshSpec
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
from repro_torch.kernels.autotune import RecordedLookups
from repro_torch.models import model as M
from repro_torch.obs.attribution import NULL_PROFILER
from repro_torch.obs.trace import (
    ENGINE,
    HEALTH_LEVEL,
    LINKS,
    NULL_RECORDER,
    REQUESTS,
    PhaseLedger,
    TraceRecorder,
    recording,
    region,
)
from repro_torch.runtime.controller import RuntimeController
from repro_torch.runtime.health import HEALTHY, HealthMonitor
from repro_torch.runtime.telemetry import (
    CudaEventSource,
    StepSample,
    weight_link_bytes,
    weight_tier_bytes,
)
from repro_torch.serving import tiered_decode as TD
from repro_torch.serving.compiled_step import (
    PAGED_INPUTS,
    StepGraph,
    StepInputs,
    capture_stream,
    pointer_fingerprint,
)
from repro_torch.serving.paged_cache import REMOTE, CacheFull, PagedTieredCache


def _decode_step(cfg: ModelConfig, inputs: dict[str, torch.Tensor], kind: str, window: int,
                 sink_local: int, sink_remote: int, tuner: Any, params: dict[str, Any],
                 pools: dict[str, torch.Tensor] | None,
                 cache: dict[str, torch.Tensor] | None) -> torch.Tensor:
    """One decode step of `kind` ("paged", "hybrid" or "ssm") over the fixed
    input buffers at ``window`` (and ``tuner``, or None): the pools and the
    recurrent state are updated in place; returns the greedy tokens [B]
    int32 on the device."""
    if kind == "ssm":
        logits, _ = TD.tiered_ssm_decode_step(cfg, params, cache, inputs["tokens"],
                                              window=window, tuner=tuner)
    else:
        args = tuple(inputs[name] for name in PAGED_INPUTS)
        sinks = dict(sink_local=sink_local, sink_remote=sink_remote)
        if kind == "hybrid":
            logits, _, _ = TD.tiered_hybrid_decode_step(cfg, params, cache, pools, *args,
                                                        **sinks, window=window, tuner=tuner)
        else:
            logits, _ = TD.paged_tiered_decode_step(cfg, params, pools, *args, **sinks,
                                                    window=window, tuner=tuner)
    return torch.argmax(logits[:, 0], dim=-1).to(torch.int32)


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
    t_prefill: float = 0.0                 # start of its first prefill pass
    preemptions: int = 0                   # tier-demotion preemptions suffered
    admitted_degraded: bool = False        # admitted while health != healthy


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
    promoted_pages: int = 0                # migration: remote->local
    demoted_pages: int = 0                 # migration: local->remote
    replans: int = 0                       # re-plans fired (drift and forced)
    final_window: int = 0                  # in-flight window after the run
    prefill_chunks: int = 0                # continuation chunks (beyond the first)
    prefill_passes: list[int] = dataclasses.field(default_factory=list)
    # prompt rows of each prefill pass (a whole prompt or one chunk)
    preemptions: int = 0                   # tier-demotion preemption events
    preempt_demoted_pages: int = 0         # pages demoted by preemptions
    # -- elastic degradation (never-OOM): the engine catches CacheFull and
    # degrades, so failed_requests stays 0 by construction; the counter
    # exists so chaos runs can assert the guarantee.
    failed_requests: int = 0
    health: str = "healthy"                # final health state
    cache_full_caught: int = 0             # CacheFull converted to demotion
    elastic_demoted_pages: int = 0         # deficit-drain demotions
    remote_grown_pages: int = 0            # emergency host-pool growth
    shed_steps: int = 0                    # steps admissions were shed
    elastic_replans: int = 0               # forced higher-ratio re-plans
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

    def register_metrics(self, reg, *, global_ratio: float,
                         wall_s: float) -> None:
        """Register the serving counters into a
        `repro_torch.obs.metrics.MetricsRegistry`, in the reference's order
        (its JSON view is the reference's stats block)."""
        reg.counter("served", "requests finished").set_total(self.served)
        reg.gauge("global_ratio",
                  "planned global offload ratio").set(global_ratio)
        reg.gauge("wall_s", "run wall time").set(wall_s)
        reg.counter("generated_tokens",
                    "tokens actually emitted").set_total(self.generated_tokens)
        reg.gauge("tokens_per_s").set(
            self.generated_tokens / wall_s if wall_s > 0 else 0.0)
        reg.gauge("tpot_ms", "mean time per output token").set(self.tpot * 1e3)
        reg.gauge("ttft_p50_ms").set(self.ttft_p50 * 1e3)
        reg.gauge("ttft_p95_ms").set(self.ttft_p95 * 1e3)
        reg.gauge("queue_delay_p50_ms").set(self.queue_delay_p50 * 1e3)
        reg.gauge("queue_delay_p95_ms").set(self.queue_delay_p95 * 1e3)
        reg.gauge("e2e_p50_ms").set(self.e2e_p50 * 1e3)
        reg.gauge("e2e_p95_ms").set(self.e2e_p95 * 1e3)
        reg.counter("decode_steps").set_total(self.decode_steps)
        reg.counter("scheduling.prefill_chunks").set_total(self.prefill_chunks)
        reg.counter("scheduling.preemptions").set_total(self.preemptions)
        reg.counter("scheduling.preempt_demoted_pages").set_total(
            self.preempt_demoted_pages)
        reg.const("scheduling.slo", self.slo_report())
        reg.counter("kv.spills").set_total(self.spills)
        reg.gauge("kv.local_pages_hwm").set(self.local_pages_hwm)
        reg.gauge("kv.remote_pages_hwm").set(self.remote_pages_hwm)
        reg.counter("failed_requests").set_total(self.failed_requests)


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
        use_kernels: bool = True,
        page_size: int = 8,
        adaptive: bool = False,
        runtime: RuntimeController | None = None,
        scheduler: str | Scheduler | None = None,
        prefill_chunk: int | None = None,
        clock: Clock | None = None,
        recorder: TraceRecorder | None = None,
        flight=None,
        jit_step: bool = True,
        check_invariants: bool = False,
        tuner: Any = None,
        profiler=None,
        device="cuda",
        mesh=None,
        mesh_axis: str | None = None,
    ):
        """``scheduler`` is the frontend policy: a name ('fcfs' | 'priority'
        | 'slo'), a `frontend.scheduler.Scheduler`, or None for FCFS with
        whole prompts.  ``prefill_chunk`` caps the prompt tokens prefilled
        per step when a name is given (an instance carries its own budget).
        ``clock`` stamps the request lifecycle: wall time by default, or a
        `frontend.metrics.ModeledClock` that the engine advances by each
        step's analytical cost.  ``adaptive`` attaches the adaptive runtime
        with its default budgets and the analytical measurement source;
        ``runtime`` attaches a given `RuntimeController` (its own budgets and
        source, e.g. a `runtime.telemetry.CudaEventSource`).

        ``jit_step`` (the default) compiles the decode step, one CUDA graph
        per bucket (`serving.compiled_step`; on the CPU the same fixed-buffer
        step runs eagerly); ``False`` runs every step eagerly.
        ``check_invariants`` audits the paged cache's page-table invariants
        (`repro_torch.analysis.page_table`, DAK301-305) after every step and
        raises `InvariantViolation` on the first inconsistency; read-only
        host bookkeeping, so tokens and stats are unchanged.  ``recorder`` is an
        `obs.trace.TraceRecorder` (default: the no-op null recorder),
        ``flight`` an `obs.flight.FlightRecorder` (a ring of per-step state
        snapshots dumped on an error or the first SLO breach) and
        ``profiler`` an `obs.attribution.AttributionProfiler` fed the modeled
        cost of every step (default: the no-op null profiler); off, each
        leaves tokens and stats bit-identical.  ``tuner`` is a
        `kernels.autotune.Autotuner` whose winners every decode step's
        kernels run with (the reference's lookups: a graphed bucket asks
        while it is first run, so replays count no hit).

        ``use_kernels=False`` is the reference's oracle mode: no tier, no
        kernel, no graph.  The engine keeps the untiered tree on its
        device, serves from the dense cache of `models.init_cache` through
        `models.prefill` and `models.decode_step`, and still plans, so the
        modeled clock prices the plan's split.  It is the source of correct
        tokens, not a speed yardstick: eager plain PyTorch, host-bound on the
        card.  The all-HBM comparison is ``global_offload_ratio=0`` on the
        kernel path.

        ``params`` is the unpartitioned stacked tree (`models.init_params`
        or `bridge.params_from_numpy`) or a `models.model.LayerSource`
        (`models.layer_source`), on ``device``.  Either is partitioned one
        layer at a time (`TieringPlan.partition_source`): the device then
        holds the local tiers and the untiered leaves, every remote tier
        is pinned host memory, and a source never has the unsplit model
        whole on the device.  The engine keeps only the partitioned tree;
        a caller that drops its own reference lets the unsplit weights be
        freed.

        ``mesh`` (`launch.mesh.Mesh`, this process one of its ranks) serves
        the replica across the ranks of ``mesh_axis`` (default: its last
        axis): every rank builds the engine with the same arguments and
        runs the same requests.  Each remote partition and remote KV page
        is pinned as this rank's 1/P slice and gathered whole every step;
        ``device`` is this rank's (ranks may share one card under gloo)."""
        # Observability: all off by default, every emission site guarded.
        # The phase regions' ledger is always on (`obs.trace.region`); their
        # spans go to the recorder's host phases track on a wall clock only.
        self.clock = clock if clock is not None else WallClock()
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.phases = PhaseLedger()
        self._phase_spans = self.recorder if self.clock.kind == "wall" else None
        with recording(self.phases, self._phase_spans), region("dak.build"):
            self.device = resolve_device(device)
            M.require_served(cfg)
            self.cfg = cfg
            self.hw = hw
            self.max_batch = max_batch
            self.max_len = max_len
            self.page_size = page_size
            if isinstance(scheduler, Scheduler):
                self.scheduler = scheduler
            else:
                kw = {"chunk_tokens": prefill_chunk} if prefill_chunk else {}
                self.scheduler = get_scheduler(scheduler or "fcfs", **kw)
            self.mesh = mesh
            self.mesh_axis = (mesh_axis or mesh.axis_names[-1]) if mesh is not None else None
            self.n_links = int(mesh.shape[self.mesh_axis]) if mesh is not None else 1
            wl = WorkloadSpec(batch=max_batch, seq_len=max_len, phase="decode")
            self.plan = offload_engine.plan(
                cfg, wl, hw, hbm_budget_bytes=hbm_budget_bytes,
                global_ratio=global_offload_ratio, kv_page_size=page_size,
                mesh=(MeshSpec(n_devices=self.n_links, axis_name=self.mesh_axis)
                      if mesh is not None else None))
            self.window = self.plan.window.n_inflight
            self._align = 32 if cfg.d_model < 1024 else 128
            self.tiered = bool(use_kernels)
            source = (params if isinstance(params, M.LayerSource)
                      else M.LayerSource.from_tree(params))
            if self.tiered:
                self.params = self.plan.partition_source(source, align=self._align, mesh=mesh)
            else:
                self.params = params if isinstance(params, dict) else M.stack_source(source)
            # Adaptive runtime: seeded from the static plan; pass `runtime` to
            # choose the budgets and the measurement source.
            self.runtime: RuntimeController | None = runtime
            if adaptive and self.runtime is None:
                self.runtime = RuntimeController(cfg, self.plan, hw, align=self._align)
            self._weight_bytes = weight_tier_bytes(self.params)
            self._weight_link_bytes = weight_link_bytes(self.params, self.n_links)
            self._step_params: dict[str, Any] | None = None   # the step's fetched tree
            self._dtype = source.dtype
            self.pcache: PagedTieredCache | None = None
            self.cache: dict[str, torch.Tensor] | None = None
            if not self.tiered:
                # the reference path: one dense cache, K/V included, in HBM
                self.cache = M.init_cache(cfg, max_batch, max_len, self._dtype, self.device)
            elif cfg.family in ("ssm", "hybrid"):
                # the recurrent conv window and SSD state of every layer, one row
                # per slot, in HBM (a hybrid's K/V goes to the page cache)
                self.cache = {k: v for k, v in M.init_cache(cfg, max_batch, max_len, self._dtype,
                                                            self.device).items()
                              if k in ("conv", "state")}
            if self.tiered and cfg.family != "ssm":
                self.pcache = self._make_pcache()
            self._t0 = self.clock.now()
            self.lens = np.zeros(max_batch, dtype=np.int32)     # per-slot kv length
            self.active: list[Request | None] = [None] * max_batch
            self.prefilling: dict[int, PrefillState] = {}   # slot -> in-flight prefill
            self.stats = EngineStats()
            self.stats.final_window = self.window
            self._next_tok = np.zeros((max_batch, 1), dtype=np.int32)
            self._prefill_calls_step = 0       # prefill passes in the last _admit
            self._preempt_moved_step = 0       # preemption and elastic demotions this step
            # Elastic degradation: the engine always owns a health monitor
            # (runtime attached or not); with no pressure it never leaves
            # `healthy` and every counter stays zero.
            self.health = HealthMonitor()
            self._pending_shrink: tuple[int, float] | None = None
            # Compiled decode step: one CUDA graph per (kind, window bucket, pool
            # shape) bucket, on fixed input buffers filled by one staged copy.
            # The untiered reference path stays eager (it is the oracle).
            self.tuner = tuner
            self._jit = bool(jit_step) and self.tiered
            self.check_invariants = check_invariants
            self._compiled: dict[tuple, StepGraph] = {}
            self.compile_count = 0             # fresh buckets (one graph each)
            self.compile_cache_hits = 0        # steps served by an existing bucket
            self._params_fp = pointer_fingerprint(self.params)
            self._inputs = StepInputs(max_batch, -(-max_len // page_size), self.device,
                                      paged=self.pcache is not None)
            self._graph_pool = None            # the memory pool every bucket's graph shares
            self._capture_stream = None        # the side stream captures run on
            self.flight = flight
            self.profiler = profiler if profiler is not None else NULL_PROFILER
            if self.profiler.enabled:
                # the optimality-fraction denominator: the plan's converged AIMD aggregate
                self.profiler.attach(clock_kind=self.clock.kind,
                                     optimal_bw=float(self.plan.window.aggregate_bw))
            self._slo_dumped = False
            if self.recorder.enabled:
                self._wire_observability()

    @property
    def graphed(self) -> bool:
        """Whether decode steps run as captured graphs (``jit_step``)."""
        return self._jit

    @property
    def recaptures(self) -> int:
        """Captures of a bucket after its first: graphs dropped because the
        addresses they hold moved (no counterpart in the reference)."""
        return sum(max(0, g.captures - 1) for g in self._compiled.values())

    @property
    def mesh_shape(self) -> list[int]:
        """Device-axis shape of the serving mesh (``[1]`` off-mesh)."""
        return [self.n_links]

    def mesh_traffic_report(self) -> dict:
        """Modeled host-link traffic for one full read of the offloaded
        weights, against the §4.3.2 read-amplification oracle.

        ``per_link_bytes`` is what the engine's own accounting says each
        rank's host link carries (realized shard extents, burst-granularity
        overhead applied); the oracle figures come from
        `core.multicast.sharded_fetch_report` on the same host footprint.
        On the fetch-once path the two agree and sit at ~1/P of the naive
        figure; operands that fell back to whole remotes push
        ``per_link_bytes`` toward the naive bound."""
        _, w_remote = self._weight_bytes
        rep = multicast.sharded_fetch_report(w_remote, self.n_links)
        ov = multicast.GRANULARITY_OVERHEAD
        return {
            "n_devices": self.n_links,
            "host_bytes": w_remote,
            "per_link_bytes": [b * ov for b in self._weight_link_bytes],
            "oracle_per_link_multicast": rep.traffic_multicast / self.n_links,
            "oracle_per_link_naive": rep.traffic_no_multicast / self.n_links,
        }

    def _fetched_params(self) -> dict[str, Any]:
        """The params with every mesh-sharded remote tier gathered whole
        into its device buffer (`tiered_decode.fetch_remote_shards`;
        identity off-mesh), once a step: a step that prefills and decodes
        gathers each operand once."""
        if self._step_params is None:
            self._step_params = TD.fetch_remote_shards(self.params, self.mesh, self.mesh_axis)
        return self._step_params

    def _wire_observability(self) -> None:
        """Point the health monitor's and runtime controller's event hooks
        at the trace recorder.  The hooks default to None, so with tracing
        off neither component ever makes a call."""
        rec = self.recorder
        rec.name_thread(ENGINE, 0, "step")

        def on_health(event: str, **info) -> None:
            t = self.clock.now()
            if event == "transition":
                rec.instant(ENGINE, 0, f"health:{info['src']}->{info['dst']}",
                            t, cat="health")
            else:
                rec.instant(ENGINE, 0, f"pressure:{info['kind']}", t,
                            cat="elastic", pages=info.get("pages", 0))

        self.health.listener = on_health
        if self.runtime is not None:
            def on_runtime(name: str, **args) -> None:
                rec.instant(ENGINE, 0, name, self.clock.now(),
                            cat="runtime", **args)

            self.runtime.on_event = on_runtime

    def _audit_page_table(self) -> None:
        """Debug hook: fail fast on page-table corruption (DAK301-305)."""
        if not self.check_invariants or self.pcache is None:
            return
        findings = check_page_table(
            self.pcache, where=f"engine.step[{self.stats.decode_steps}]")
        if findings:
            raise InvariantViolation(findings)

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
            device=self.device,
            mesh=self.mesh,
            mesh_axis=self.mesh_axis)

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
        if self.recorder.enabled:
            self.recorder.name_thread(REQUESTS, req.rid, f"req{req.rid}")
            self.recorder.instant(
                REQUESTS, req.rid, "submit",
                req.arrival_s if req.arrival_s is not None else now,
                cat="lifecycle", cls=req.cls, prompt=len(req.prompt))
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
        self._prefill_calls_step = 0
        sched = self.scheduler
        now = self.clock.now()
        sched.release(now)
        qd_ema = (self.runtime.telemetry.queue_depth
                  if self.runtime is not None else float(len(sched.ready)))
        left = sched.chunk_budget(qd_ema)
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
        # Admit within the health quota (elastic backoff: shed while
        # spilling, trickle while recovering).  An idle engine always
        # admits: nothing active means no pressure a prompt could worsen.
        quota = sched.admission_quota(self.health.state)
        if (quota == 0 and not self.prefilling
                and not any(r is not None for r in self.active)):
            quota = 1
        shed = False
        while sched.ready and (left is None or left > 0):
            if quota is not None and quota <= 0:
                shed = True
                break
            free = self._free_slots()
            if not free:
                break
            req = sched.select(now)
            slot = free[0]
            req.t_admit = now
            req.admitted_degraded = self.health.state != HEALTHY
            self.stats.queue_delays.append(req.t_admit - req.t_submit)
            if self.recorder.enabled:
                self.recorder.span(REQUESTS, req.rid, "queued",
                                   req.t_submit, now, cat="lifecycle")
                if req.admitted_degraded:
                    self.recorder.instant(
                        REQUESTS, req.rid, "admitted_degraded", now,
                        cat="lifecycle", health=self.health.state)
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
        if shed and sched.ready:
            self.health.shed()
        return prefill_tokens

    def _run_prefill_chunk(self, slot: int, ps: PrefillState, n: int) -> None:
        """Prefill `n` prompt tokens of the slot's in-flight prefill, one
        `dak.prefill` region; a request's first pass stamps its
        ``t_prefill``."""
        req = ps.req
        with region("dak.prefill", rid=req.rid, tokens=n, pos=ps.pos,
                    t_submit=req.t_submit) as reg:
            if ps.pos == 0:
                req.t_prefill = reg.t0 if self.clock.kind == "wall" else self.clock.now()
            reg.args["t_prefill"] = req.t_prefill
            self._prefill_pass(slot, ps, n, reg.t0)

    def _prefill_pass(self, slot: int, ps: PrefillState, n: int, t0: float) -> None:
        """The pass itself, begun at wall time `t0`.  A whole prompt in one
        chunk runs `models.prefill`; otherwise each chunk runs
        `models.prefill_chunk` on the request's private cache.  The last
        chunk commits: the first token is sampled from its final logits,
        the cache written to the slot, and the request joins the decode
        batch."""
        req = ps.req
        self._prefill_calls_step += 1
        mm = TD.kernel_mm(self.window)     # prefill's GEMMs at the live window, as decode's
        tc0 = self.clock.now() if self.recorder.enabled else 0.0
        chunk = torch.as_tensor(req.prompt[ps.pos:ps.pos + n], dtype=torch.int32,
                                device=self.device)[None, :]
        if ps.pos == 0 and n == len(req.prompt):
            ps.logits, ps.cache = M.prefill(self.cfg, self._fetched_params(), {"tokens": chunk},
                                            max_len=self.max_len, mm=mm)
        else:
            if ps.cache is None:           # first chunk of a split prompt
                ps.cache = M.init_cache(self.cfg, 1, self.max_len, self._dtype, self.device)
            ps.logits, ps.cache = M.prefill_chunk(self.cfg, self._fetched_params(), ps.cache, chunk,
                                                  ps.pos, mm=mm)
            self.stats.prefill_chunks += 1
        ps.pos += n
        if self.clock.kind == "wall" and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the chunk's time, not its launch's
        self.stats.prefill_time += time.time() - t0
        self.stats.prefill_passes.append(n)
        self._clock_tick_prefill(n)
        if self.recorder.enabled:
            self.recorder.span(ENGINE, 0, f"prefill[{req.rid}]", tc0,
                               self.clock.now(), cat="prefill", slot=slot,
                               tokens=n, pos=ps.pos)
        if ps.pos < len(req.prompt):
            return
        del self.prefilling[slot]
        with region("dak.first_token", rid=req.rid):
            nxt = int(torch.argmax(ps.logits[0, -1]))
        req.out_tokens.append(nxt)
        self.stats.generated_tokens += 1
        req.t_first = self.clock.now()
        self.stats.ttfts.append(req.t_first - req.t_submit)
        if self.recorder.enabled:
            self.recorder.instant(REQUESTS, req.rid, "first_token",
                                  req.t_first, cat="lifecycle",
                                  ttft_s=req.t_first - req.t_submit)
        if (self.flight is not None and not self._slo_dumped
                and self.flight.breached(req.t_first - req.t_submit)):
            # one post-mortem a run: the first breach captures its window
            self._slo_dumped = True
            self.flight.dump("slo_breach",
                             final_snapshot=self._flight_snapshot(),
                             recorder=self.recorder)
        if nxt == req.eos_id or req.max_new_tokens <= 1:
            self._finish_request(req)      # slot stays free for the next
            return
        if self.pcache is not None and self.scheduler.preemptive:
            # The shortfall was demoted at admission, but a split prompt
            # allocates its pages only now, steps later: other slots' decode
            # growth may have taken the freed pages in between.  (A no-op for
            # a whole prompt: nothing allocated since the admission check.)
            self._maybe_preempt(req)
        with region("dak.prompt_write", rid=req.rid) as reg:
            reg.args["local_bytes"], reg.args["remote_bytes"] = self._write_slot_cache(
                slot, ps.cache, len(req.prompt))
        self.lens[slot] = len(req.prompt)
        self._next_tok[slot, 0] = nxt
        self.active[slot] = req
        self._note_occupancy()

    def _finish_request(self, req: Request) -> None:
        req.t_done = self.clock.now()
        if self.recorder.enabled:
            self.recorder.span(REQUESTS, req.rid, "active", req.t_admit,
                               req.t_done, cat="lifecycle",
                               tokens=len(req.out_tokens),
                               preemptions=req.preemptions)
        self.stats.served += 1
        self.stats.e2e_latencies.append(req.t_done - req.t_submit)
        self.stats.requests.append(RequestRecord(
            rid=req.rid, cls=req.cls, priority=req.priority,
            prompt_tokens=len(req.prompt), output_tokens=len(req.out_tokens),
            queue_delay=req.t_admit - req.t_submit,
            ttft=req.t_first - req.t_submit,
            e2e=req.t_done - req.t_submit,
            preemptions=req.preemptions, slo_ttft_s=req.slo_ttft_s,
            admitted_degraded=req.admitted_degraded))

    def _preempt_shortfall(self, incoming: Request) -> int:
        """Local pages the incoming prompt still lacks: its pages (and its
        next decode token's) beyond the elastic free count, plus the live
        migrator's allocation headroom when the migrator runs (budget > 0),
        or its very next demote-for-headroom pass would fire again."""
        need = -(-(len(incoming.prompt) + 1) // self.page_size)
        if self.runtime is not None and self.runtime.migrator.pages_per_step > 0:
            need += self.runtime.migrator.headroom
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
            self._preempt_moved_step += moved
            if self.recorder.enabled:
                self.recorder.instant(
                    REQUESTS, self.active[victim].rid, "preempted",
                    self.clock.now(), cat="lifecycle", pages=moved,
                    by=incoming.rid)

    # -- elastic degradation (never-OOM) ------------------------------------
    def schedule_hbm_shrink(self, step: int, fraction: float) -> None:
        """Chaos hook (`--hbm-shrink STEP:FRAC`): at decode step `step`,
        shrink the modeled HBM page budget to `fraction` of the local
        pool.  The engine degrades (demotes the deficit, re-plans to a
        higher offload ratio, sheds admissions while spilling) instead of
        failing a request."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"shrink fraction must be in [0, 1], got {fraction}")
        self._pending_shrink = (int(step), float(fraction))

    def shrink_local_budget(self, fraction: float) -> int:
        """Apply an elastic local-budget shrink now: cap the cache's local
        limit at ``fraction`` of the pool, mark the engine spilling, and
        ask the runtime (when attached) for a higher-offload re-plan.
        Returns the resulting page deficit (drained by `_elastic_step`)."""
        if self.pcache is None:
            return 0
        deficit = self.pcache.set_local_limit(int(self.pcache.n_local * fraction))
        self.health.pressure("shrink", pages=deficit)
        self._elastic_replan()
        return deficit

    def _elastic_replan(self) -> None:
        """Ask the re-planner for a higher offload ratio matching the
        shrunken local budget (`runtime.replan.repartition` realizes it);
        no-op without the adaptive runtime."""
        if self.runtime is None or self.pcache is None:
            return
        frac = self.pcache.local_limit / max(1, self.pcache.n_local)
        self._fetched_params()             # a re-split reads the whole remote tiers
        new_params = self.runtime.elastic_replan(frac, self.params)
        if new_params is not None and new_params is not self.params:
            self.health.pressure("replan")
            self._install_params(new_params)

    def _install_params(self, new_params: dict[str, Any]) -> None:
        """Swap in a repartitioned params tree (re-plan paths): re-shard it
        under a mesh, drop the step's fetched tree, refresh the traffic
        accounting.  The stream is synchronised first: a kernel may still
        read the old tiers, and a pinned tier's memory is freed as soon as
        its last tensor is dropped.  Captured steps hold the old tiers'
        addresses, so when any leaf moved they are dropped before the old
        tiers can go (a re-plan that moves nothing keeps them)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        if self.mesh is not None:
            from repro_torch.launch.sharding import shard_tiered_params

            new_params = shard_tiered_params(new_params, self.mesh, self.mesh_axis)
        self._step_params = None
        fingerprint = pointer_fingerprint(new_params)
        if fingerprint != self._params_fp:
            self._drop_graphs()
            self._params_fp = fingerprint
        self.params = new_params
        self._weight_bytes = weight_tier_bytes(self.params)
        self._weight_link_bytes = weight_link_bytes(self.params, self.n_links)

    def _grow_remote(self, pages: int) -> None:
        """`PagedTieredCache.grow_remote`, which replaces the remote pools:
        the captured steps that read the old ones are dropped (their bucket
        keys name the old pool shape and do not come back)."""
        self.pcache.grow_remote(pages)
        self._drop_graphs()

    def _drop_graphs(self) -> None:
        for graph in self._compiled.values():
            graph.drop()

    def _elastic_recover(self, need_pages: int = 1) -> None:
        """Convert a ``CacheFull`` into degradation: grow the elastic
        remote (host) pool so the blocked allocation can land (capacity
        pressure becomes host-bandwidth pressure, the trade the
        direct-access path exists to make), then drain any local deficit
        and re-plan toward a higher offload ratio."""
        self.health.pressure("cache_full")
        # Grow by at least one full sequence's pages so a long-context
        # burst recovers in one growth, not one page at a time.
        grow = max(need_pages, self.pcache.max_pages)
        self._grow_remote(grow)
        self.health.pressure("grow", pages=grow)
        deficit = self.pcache.local_deficit
        if deficit > 0:
            moved = self.pcache.demote_coldest(deficit)
            if moved:
                self.health.pressure("demote", pages=moved)
                self._preempt_moved_step += moved
        self._elastic_replan()

    def _ensure_capacity_elastic(self, slot: int, length: int) -> None:
        """`ensure_capacity` with the never-OOM guarantee: a CacheFull is
        caught, converted into remote growth and demotion, and the
        allocation retried.  A second failure is a real bug (max_pages
        overflow) and surfaces."""
        try:
            self.pcache.ensure_capacity(slot, length)
        except CacheFull:
            need = -(-length // self.page_size) - int(self.pcache.n_pages[slot])
            self._elastic_recover(max(1, need))
            self.pcache.ensure_capacity(slot, length)

    def _elastic_step(self) -> None:
        """Per-step elastic drain: demote the deficit a shrunken local
        budget left behind (globally coldest pages first), growing the
        remote pool when it cannot absorb them.  Movement draws down the
        shared per-step migration budget via `_preempt_moved_step`."""
        if self.pcache is None:
            return
        deficit = self.pcache.local_deficit
        if deficit <= 0:
            return
        short = deficit - len(self.pcache.free[REMOTE])
        if short > 0:
            self._grow_remote(short)
            self.health.pressure("grow", pages=short)
        moved = self.pcache.demote_coldest(deficit)
        if moved:
            self.health.pressure("demote", pages=moved)
            self._preempt_moved_step += moved

    def _finish_step_health(self) -> None:
        """End-of-step health update: walk the recovery ladder against the
        cache's current deficit and sync the counters into EngineStats."""
        deficit = self.pcache.local_deficit if self.pcache is not None else 0
        self.health.observe(deficit)
        self._note_health()

    def _note_health(self) -> None:
        """Fold the health monitor's state and counters into EngineStats."""
        c = self.health.counters
        self.stats.health = self.health.state
        self.stats.cache_full_caught = c.cache_full_caught
        self.stats.elastic_demoted_pages = c.elastic_demoted_pages
        self.stats.remote_grown_pages = c.remote_grown_pages
        self.stats.shed_steps = c.shed_steps
        self.stats.elastic_replans = c.elastic_replans

    # -- modeled clock ------------------------------------------------------
    def _clock_tick_prefill(self, n_tokens: int) -> None:
        """Advance a modeled clock by the analytical cost of one prefill
        chunk, before TTFT is stamped (a no-op on the wall clock).  The
        attribution profiler records the same decomposition (on the wall
        clock as a modeled estimate)."""
        if not n_tokens:
            return
        modeled = isinstance(self.clock, ModeledClock)
        if not modeled and not self.profiler.enabled:
            return
        cost = modeled_step_cost(self.cfg, self.hw, self.plan.op_ratios,
                                 prefill_tokens=n_tokens)
        if modeled:
            self.clock.advance(cost.total)
        if self.profiler.enabled:
            self.profiler.on_tick(cost)

    def _clock_tick_decode(self, active: np.ndarray) -> None:
        """Advance a modeled clock by the analytical cost of one decode step
        over the active slots, the KV read priced from the live page
        residency, so spills and preemption's demotions show in the modeled
        latencies; the profiler records it as `_clock_tick_prefill` does.
        No copy traffic is priced (``hbm_copy_bytes`` 0), eager or graphed:
        the port's decode step writes each new K/V row into the pools in
        place, as the reference's compiled step does."""
        n_active = int(active.sum())
        if not n_active:
            return
        modeled = isinstance(self.clock, ModeledClock)
        if not modeled and not self.profiler.enabled:
            return
        kv_local = kv_remote = 0.0
        if self.pcache is not None:
            kv_local, kv_remote = self.pcache.attended_bytes(self.lens, active)
        cost = modeled_step_cost(
            self.cfg, self.hw, self.plan.op_ratios, decode_slots=n_active,
            mean_kv_len=float(self.lens[active].mean()),
            kv_local_bytes=kv_local, kv_remote_bytes=kv_remote, hbm_copy_bytes=0.0)
        if modeled:
            self.clock.advance(cost.total)
        if self.profiler.enabled:
            self.profiler.on_tick(cost)

    def _write_slot_cache(self, slot: int, cache1: dict[str, torch.Tensor],
                          prompt_len: int) -> tuple[int, int]:
        """Commit a prefilled batch-1 cache to `slot`.  Returns the bytes
        put into local and into remote KV pages: the prompt's, and those of
        the pages its allocation spilled."""
        if self.cache is not None:             # conv/state recurrent state
            for name, c in self.cache.items():
                c[:, slot] = cache1[name][:, 0]
        if self.pcache is None:
            return 0, 0
        before = tuple(self.pcache.written)
        # write_prompt's own ensure_capacity is the allocation edge: allocate
        # through the elastic guard first, so a full pool degrades instead.
        self._ensure_capacity_elastic(slot, prompt_len)
        if self.cfg.use_mla:
            ckv = cache1["ckv"][:, 0, :prompt_len]       # [L, T, rank]
            krope = cache1["krope"][:, 0, :prompt_len]   # [L, T, rd]
            self.pcache.write_prompt(slot, torch.cat([ckv, krope], dim=-1)[:, :, None, :])
        else:
            self.pcache.write_prompt(
                slot, cache1["k"][:, 0, :prompt_len], cache1["v"][:, 0, :prompt_len])
        return self.pcache.written[0] - before[0], self.pcache.written[1] - before[1]

    def _note_occupancy(self) -> None:
        if self.pcache is None:
            return
        self.stats.local_pages_hwm = max(
            self.stats.local_pages_hwm, self.pcache.local_in_use)
        self.stats.remote_pages_hwm = max(
            self.stats.remote_pages_hwm, self.pcache.remote_in_use)
        self.stats.spills = self.pcache.spills

    # ------------------------------------------------------------------
    @staticmethod
    def _bucket_window(w: int) -> int:
        """Round the AIMD window up to the next power of two.  The compiled
        step closes over the window (a static kernel parameter), so
        bucketing keeps the number of distinct compilations at O(log W)
        while the controller sweeps — safe because outputs are
        bitwise-independent of the window (it only paces DMA issue)."""
        return 1 << max(0, int(w) - 1).bit_length()

    def _compiled_step(self, kind: str) -> tuple[StepGraph, str | None]:
        """The captured decode step of the current (kind, window bucket,
        pool shape) bucket, the reference's key: made on the bucket's first
        step (captured as it runs), reused after.  Pool growth changes the
        remote pool's shape and so the key.  Returns ``(graph, bucket)``,
        ``bucket`` a label on a fresh bucket and None on a hit."""
        wb = self._bucket_window(self.window)
        if self.pcache is not None:
            sl, sr = self.pcache.sink_local, self.pcache.sink_remote
            key = (kind, wb, sl, sr,
                   tuple(self.pcache.pools["k_local"].shape),
                   tuple(self.pcache.pools["k_remote"].shape))
        else:
            sl = sr = 0
            key = (kind, wb)
        graph = self._compiled.get(key)
        if graph is not None:
            self.compile_cache_hits += 1
            return graph, None
        self.compile_count += 1
        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = capture_stream(self.device)
        lookups = RecordedLookups(self.tuner) if self.tuner is not None else None
        graph = StepGraph(self._decode_fn(kind, wb, sl, sr, lookups), self.device,
                          pool=self._graph_pool, stream=self._capture_stream,
                          after_first_run=lookups.seal if lookups is not None else None)
        self._compiled[key] = graph
        return graph, f"{kind}/w{wb}"

    def _decode_fn(self, kind: str, window: int, sink_local: int, sink_remote: int,
                   tuner: Any = None):
        """The decode step of one bucket, ``fn(params, pools, cache)``:
        bound to the fixed input buffers and its tuner view, not to the
        engine (so a cached graph keeps no reference back to it)."""
        return functools.partial(_decode_step, self.cfg, self._inputs.buffers, kind, window,
                                 sink_local, sink_remote, tuner)

    def _decode_state(self) -> tuple:
        """What a decode step reads besides its inputs: params, pools and
        recurrent state, updated in place (a capture bakes in their
        addresses).  Under a mesh the remote tiers and pools are gathered
        here, into the fixed buffers the step reads."""
        pools = self.pcache.compute_pools() if self.pcache is not None else None
        return self._fetched_params(), pools, self.cache

    def _decode_kind(self) -> str:
        if self.pcache is None:
            return "ssm"                   # pure SSM: the recurrent step, no KV pages
        return "hybrid" if self.cfg.family == "hybrid" else "paged"

    def step(self) -> None:
        """One engine step: the elastic drain, the scheduler's prefill round
        (chunks and admissions), then one ragged decode step for all active
        slots, graphed or eager.  With the adaptive runtime attached, the
        in-flight window is re-read from the controller every step and a
        telemetry sample is reported after the compute.  The step is one
        `dak.step` region, split into `dak.admit` (its passes `dak.prefill`),
        `dak.stage`, `dak.launch`, `dak.fetch` and `dak.finish`."""
        with recording(self.phases, self._phase_spans), \
                region("dak.step", step=self.phases.n_steps):
            self._step()

    def _step(self) -> None:
        t_step_clock = self.clock.now()    # engine-clock step origin (wall or modeled)
        self._preempt_moved_step = 0
        self._step_params = None           # a new step fetches the remote tiers again
        if self.runtime is not None:
            self.window = self.runtime.window
        if (self._pending_shrink is not None
                and self.stats.decode_steps >= self._pending_shrink[0]):
            _, frac = self._pending_shrink
            self._pending_shrink = None
            self.shrink_local_budget(frac)
        self._elastic_step()               # drain any local-budget deficit
        with region("dak.admit") as reg:
            t_admit0 = self.clock.now() if self.recorder.enabled else 0.0
            prefill_tokens = self._admit()
            if self.recorder.enabled:
                self.recorder.span(ENGINE, 0, "admission", t_admit0,
                                   self.clock.now(), cat="sched",
                                   prefill_tokens=prefill_tokens)
            reg.args.update(passes=self._prefill_calls_step, prompt_tokens=prefill_tokens)
        if not any(r is not None for r in self.active):
            with region("dak.finish"):
                if prefill_tokens:
                    self._runtime_step(t_step_clock, prefill_tokens,
                                       np.zeros(self.max_batch, dtype=bool))
                elif not self.prefilling and self.scheduler.waiting:
                    # Idle with an arrival pending: fast-forward the modeled clock
                    # to it (a no-op on the wall clock, which polls until then).
                    nxt = self.scheduler.next_arrival()
                    if nxt is not None:
                        self.clock.advance(max(0.0, nxt - self.clock.now()))
                self._finish_step_health()
                if self.flight is not None:
                    self.flight.record(self._flight_snapshot())
                self._audit_page_table()
            return
        active = np.array([r is not None for r in self.active])
        if not self.tiered:
            self._reference_decode(t_step_clock, prefill_tokens, active)
            return
        rows = None                        # the step's remote row writes (tier, page)
        with region("dak.stage"):
            if self.pcache is None:
                self._inputs.load(tokens=self._next_tok)
            else:
                self.pcache.touch_step(self.lens, active)
                for slot in np.nonzero(active)[0]:
                    self._ensure_capacity_elastic(int(slot), int(self.lens[slot]) + 1)
                self._note_occupancy()
                wr_tier, wr_idx, wr_off = self.pcache.write_target_arrays(self.lens, active)
                self._inputs.load(
                    tokens=self._next_tok, positions=np.where(active, self.lens, 0),
                    attn_lens=np.where(active, self.lens + 1, 0), table=self.pcache.table,
                    tier=self.pcache.tier, wr_tier=wr_tier, wr_idx=wr_idx, wr_off=wr_off)
                rows = (wr_tier, wr_idx)
        timer = self._step_timer()
        tc0 = self.clock.now() if self.recorder.enabled else 0.0
        bucket = None                      # compile-span label on a fresh bucket
        with region("dak.launch", captured=False) as launch:
            if timer is not None:
                timer.begin()
            state = self._decode_state()   # under a mesh: the step's gathers, timed with it
            if self._jit:
                graph, bucket = self._compiled_step(self._decode_kind())
                launch.args["captured"] = self.device.type == "cuda" and not graph.captured
                tok_dev = graph.run(*state)
            else:
                sinks = ((self.pcache.sink_local, self.pcache.sink_remote)
                         if self.pcache is not None else (0, 0))
                tok_dev = self._decode_fn(self._decode_kind(), self.window, *sinks,
                                          self.tuner)(*state)
            if timer is not None:
                timer.end()
        with region("dak.fetch") as fetch:
            nxt = self._inputs.fetch(tok_dev)  # the step's only host sync
        with region("dak.finish"):
            if self.pcache is not None:
                self.pcache.commit_pools(state[1], rows=rows)
            self._finish_decode(t_step_clock, prefill_tokens, active, nxt,
                                fetch.t1 - launch.t0, tc0, bucket)

    def _reference_decode(self, t_step_clock: float, prefill_tokens: int,
                          active: np.ndarray) -> None:
        """The untiered decode step (``use_kernels=False``): `models.decode_step`
        over the dense cache, every slot at its own position."""
        tc0 = self.clock.now() if self.recorder.enabled else 0.0
        with region("dak.launch", captured=False) as launch:
            tokens = torch.as_tensor(self._next_tok, dtype=torch.int32, device=self.device)
            positions = torch.as_tensor(np.where(active, self.lens, 0), dtype=torch.int32,
                                        device=self.device)
            logits, self.cache = M.decode_step(self.cfg, self.params, self.cache, tokens,
                                               positions)
            tok_dev = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        with region("dak.fetch") as fetch:
            nxt = tok_dev.cpu().numpy()
        with region("dak.finish"):
            self._finish_decode(t_step_clock, prefill_tokens, active, nxt,
                                fetch.t1 - launch.t0, tc0, None)

    def _finish_decode(self, t_step_clock: float, prefill_tokens: int, active: np.ndarray,
                       nxt: np.ndarray, decode_s: float, tc0: float,
                       bucket: str | None) -> None:
        """The rest of a decode step once its tokens are on the host: stats,
        the clock, spans, the runtime, health, and each slot's new token.
        ``decode_s`` is the step's launch and fetch, wall seconds."""
        self.stats.decode_time += decode_s
        self.stats.decode_steps += 1
        self._clock_tick_decode(active)
        if self.recorder.enabled:
            if bucket is not None:
                self.recorder.span(ENGINE, 0, f"compile[{bucket}]", tc0,
                                   self.clock.now(), cat="compile",
                                   wall_ms=decode_s * 1e3)
            self.recorder.span(ENGINE, 0, "decode", tc0, self.clock.now(),
                               cat="decode", slots=int(active.sum()),
                               step=self.stats.decode_steps)
        self._runtime_step(t_step_clock, prefill_tokens, active)
        self._finish_step_health()
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
        if self.flight is not None:
            self.flight.record(self._flight_snapshot())
        self._audit_page_table()

    def _step_timer(self) -> CudaEventSource | None:
        """The runtime's measurement source when it times decode steps on
        the card, else None."""
        src = self.runtime.source if self.runtime is not None else None
        return src if isinstance(src, CudaEventSource) else None

    def _runtime_step(self, t_step_clock: float, prefill_tokens: int,
                      active: np.ndarray) -> None:
        """Report one step to the adaptive runtime and apply its actions:
        window update (read back at the top of the next step), bounded page
        migration, and, on a re-plan, the repartitioned params tree.  With
        tracing on, the same accounting feeds the counter tracks (link
        bytes, window, queue depth, deficit, health), runtime attached or
        not; with the profiler on, it closes the step's ledger.

        Traffic accounting: decode reads every weight once per step, each
        prefill pass reads them once more; KV traffic follows the page
        table's tier map.  A `CudaEventSource` gets the decode pass's bytes
        to divide by its device time.  ``duration_s`` is engine-clock time
        (wall seconds, or modeled seconds on a ModeledClock replay)."""
        if (self.runtime is None and not self.recorder.enabled
                and not self.profiler.enabled):
            return
        n_active = int(active.sum())
        w_local, w_remote = self._weight_bytes
        kv_local = kv_remote = 0.0
        if self.pcache is not None and n_active:
            kv_local, kv_remote = self.pcache.attended_bytes(self.lens, active)
        timer = self._step_timer()
        if timer is not None and n_active:
            timer.observe(w_local + kv_local, w_remote + kv_remote)
        # Under a mesh each host link carries its 1/P slice of every sharded
        # partition and remote page (whole copies for the divisibility
        # fallback); remote_bytes is the sum over links.
        passes = (1 if n_active else 0) + self._prefill_calls_step
        link_b = [b * passes for b in self._weight_link_bytes]
        if self.pcache is not None and n_active:
            kv_links = self.pcache.attended_link_bytes(self.lens, active, self.n_links)
            link_b = [a + b for a, b in zip(link_b, kv_links)]
        sample = StepSample(
            step=self.stats.decode_steps,
            duration_s=max(self.clock.now() - t_step_clock, 1e-9),
            prefill_tokens=prefill_tokens,
            decode_tokens=n_active,
            queue_depth=len(self.queue),
            active_slots=n_active,
            mean_kv_len=float(self.lens[active].mean()) if n_active else 0.0,
            local_bytes=w_local * passes + kv_local,
            remote_bytes=sum(link_b),
            window=self.window,
            remote_bytes_per_link=tuple(link_b) if self.n_links > 1 else None,
            health=self.health.state,
            local_deficit=self.pcache.local_deficit if self.pcache is not None else 0)
        if self.recorder.enabled:
            rec, t = self.recorder, self.clock.now()
            rec.counter(LINKS, "link_bytes", t,
                        {f"link{i}": b for i, b in enumerate(link_b)})
            rec.counter(LINKS, "window", t, {"slots": self.window})
            rec.counter(LINKS, "queue_depth", t,
                        {"requests": sample.queue_depth})
            rec.counter(LINKS, "local_deficit", t,
                        {"pages": sample.local_deficit})
            rec.counter(LINKS, "health", t,
                        {"level": HEALTH_LEVEL.get(self.health.state, -1)})
        if self.profiler.enabled:
            # close this step's ledger and put it on the trace: seconds per
            # component and bandwidth optimality as counters, label changes
            # as instants
            ledger = self.profiler.close_step(sample, t_start=t_step_clock)
            if self.recorder.enabled:
                rec, t = self.recorder, self.clock.now()
                rec.counter(LINKS, "attribution", t, ledger.components())
                rec.counter(LINKS, "bw.optimal_fraction", t,
                            {"fraction": ledger.optimal_fraction})
                tr = self.profiler.last_transition
                if tr is not None:
                    rec.instant(ENGINE, 0, f"bottleneck:{tr[1]}->{tr[2]}", t,
                                cat="bottleneck", step=tr[0])
        if self.runtime is None:
            return
        self._fetched_params()             # a re-split reads the whole remote tiers
        new_params = self.runtime.on_step(
            sample, cache=self.pcache, params=self.params,
            migration_used=self._preempt_moved_step)
        if new_params is not None and new_params is not self.params:
            self._install_params(new_params)
        rs = self.runtime.stats
        self.stats.replans = rs.replans
        self.stats.promoted_pages = rs.promoted_pages
        self.stats.demoted_pages = rs.demoted_pages
        self.stats.final_window = self.runtime.window
        self._note_occupancy()

    def _flight_snapshot(self) -> dict:
        """One step's engine state for the flight-recorder ring (plain
        JSON-serializable host values, no tensors)."""
        snap: dict[str, Any] = {
            "step": self.stats.decode_steps,
            "clock_s": self.clock.now(),
            "health": self.health.state,
            "window": self.window,
            "waiting": self.scheduler.waiting,
            "prefilling": sorted(self.prefilling),
            "active": [r.rid if r is not None else None for r in self.active],
            "lens": self.lens.tolist(),
            "served": self.stats.served,
            "generated_tokens": self.stats.generated_tokens,
        }
        if self.pcache is not None:
            snap["pages"] = {
                "local_in_use": self.pcache.local_in_use,
                "remote_in_use": self.pcache.remote_in_use,
                "local_free": self.pcache.local_free,
                "remote_free": len(self.pcache.free[REMOTE]),
                "local_deficit": self.pcache.local_deficit,
                "spills": self.pcache.spills,
            }
        led = self.profiler.last_ledger if self.profiler.enabled else None
        if led is not None:
            # where the dying run's time was going: the last closed ledger
            snap["attribution"] = {
                "step": led.step,
                "label": led.label,
                "components": led.components(),
                "unattributed_s": led.unattributed(),
                "optimal_fraction": led.optimal_fraction,
            }
        return snap

    def run(self, max_steps: int = 10_000, *, step_hook=None) -> EngineStats:
        """Drive the engine until every submitted request is served.
        ``step_hook(steps)``, when given, runs after every engine step (the
        serve command's periodic metrics flush), inside the guard that dumps the
        flight ring when a step raises."""
        steps = 0
        try:
            while (self.scheduler.waiting or self.prefilling
                   or any(r is not None for r in self.active)) and steps < max_steps:
                self.step()
                steps += 1
                if step_hook is not None:
                    step_hook(steps)
        except Exception as e:
            if self.flight is not None:
                self.flight.dump(type(e).__name__, error=str(e),
                                 final_snapshot=self._flight_snapshot(),
                                 recorder=self.recorder)
            raise
        return self.stats
