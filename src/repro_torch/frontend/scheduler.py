"""Pluggable serving schedulers — admission, slot assignment, chunked
prefill budgets, and tier-demotion preemption policy.

The scheduler owns the request queues (`pending` future arrivals from a
trace, `ready` admissible requests) and answers four questions for
`serving.engine.ServingEngine` each step:

1. **which request next** (:meth:`Scheduler.select`) — FCFS arrival
   order, strict priority, or SLO-aware earliest-deadline-first;
2. **how much prefill this step** (:meth:`Scheduler.chunk_budget`) — a
   per-step prompt-token budget.  ``None`` (the FCFS default) is classic
   whole-prompt prefill; a finite budget splits long prompts into chunks
   interleaved with decode steps, so the telemetry plane / AIMD
   controller see a smooth prefill/decode mix instead of prefill spikes
   and a long prompt can no longer head-of-line-block a latency-sensitive
   arrival.  The SLO scheduler *consumes the runtime's queue-depth EMA*:
   when the queue backs up past ``queue_depth_shrink``, it halves the
   chunk so admissions start sooner.
3. **in what order in-flight chunked prefills continue**
   (:meth:`Scheduler.order_prefilling`);
4. **whom to preempt** (:meth:`Scheduler.pick_victim`) — on KV page
   pressure the engine demotes the victim's local pages to the remote
   pool (`PagedTieredCache.demote_slot_pages`) and keeps decoding it
   through the direct-access kernel: exact tokens, no recompute, no
   stall.  This is the scheduling trick tiering enables — flat-memory
   engines must stall or evict-and-recompute.

Scheduling decisions never change the tokens a request produces (per-slot
computation is independent; pinned by the parity suite in
``tests/test_frontend.py``) — only *when* each request's tokens are
produced, which is what the SLO metrics measure.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Iterable

Request = Any   # serving.engine.Request, duck-typed to avoid the import cycle


def _deadline(req: Request) -> float:
    """EDF key: submit time + TTFT SLO; best-effort requests sort last."""
    if getattr(req, "slo_ttft_s", None) is None:
        return float("inf")
    return req.t_submit + req.slo_ttft_s


class Scheduler:
    """FCFS base scheduler: arrival order, whole-prompt prefill, no
    preemption — exactly the pre-frontend engine behaviour."""

    name = "fcfs"

    def __init__(self, *, chunk_tokens: int | None = None,
                 preemptive: bool = False,
                 queue_depth_shrink: float = 4.0,
                 min_chunk_tokens: int = 8):
        if chunk_tokens is not None and chunk_tokens < 1:
            raise ValueError(f"chunk_tokens must be >= 1, got {chunk_tokens}")
        self.chunk_tokens = chunk_tokens
        self.preemptive = preemptive
        self.queue_depth_shrink = queue_depth_shrink
        self.min_chunk_tokens = max(1, min_chunk_tokens)
        self.ready: deque[Request] = deque()
        self._pending: list[tuple[float, int, Request]] = []   # arrival heap
        self._seq = 0
        # Queue-flow accounting (Prometheus-only observability; never in
        # the BENCH JSON schema): requests accepted, trace arrivals
        # released, admissions popped, preemption victims picked.
        self.flow = {"submitted": 0, "released": 0,
                     "selected": 0, "victims": 0}

    # -- queue plumbing ----------------------------------------------------
    def submit(self, req: Request, now: float) -> None:
        """Accept a request: future trace arrivals wait in the pending
        heap until the clock reaches them, everything else is ready."""
        self.flow["submitted"] += 1
        arrival = getattr(req, "arrival_s", None)
        if arrival is not None and arrival > now:
            self._seq += 1
            heapq.heappush(self._pending, (float(arrival), self._seq, req))
        else:
            if arrival is not None:
                req.t_submit = float(arrival)
            self.ready.append(req)

    def release(self, now: float) -> int:
        """Move pending requests whose arrival time has come into the
        ready queue (in arrival order).  Returns how many arrived."""
        n = 0
        while self._pending and self._pending[0][0] <= now:
            arrival, _, req = heapq.heappop(self._pending)
            req.t_submit = arrival
            self.ready.append(req)
            n += 1
        self.flow["released"] += n
        return n

    @property
    def waiting(self) -> int:
        """Requests not yet admitted (ready + future arrivals)."""
        return len(self.ready) + len(self._pending)

    def next_arrival(self) -> float | None:
        """Arrival time of the earliest pending request (idle fast-forward
        target for the modeled clock)."""
        return self._pending[0][0] if self._pending else None

    # -- policy ------------------------------------------------------------
    def select(self, now: float) -> Request:
        """Pop the next request to admit (FCFS: head of the queue)."""
        self.flow["selected"] += 1
        return self.ready.popleft()

    def order_prefilling(
            self, items: list[tuple[int, Request]]) -> list[int]:
        """Order in which in-flight chunked prefills continue this step
        (items: (slot, request)).  FCFS: admission order."""
        return [slot for slot, _ in items]

    def chunk_budget(self, queue_depth_ema: float = 0.0) -> int | None:
        """Per-step prefill token budget (None = whole prompts)."""
        return self.chunk_tokens

    def admission_quota(self, health: str) -> int | None:
        """Max *new* admissions this step under the engine health state
        (elastic-degradation backoff, every policy): ``spilling`` sheds
        (0 — the engine is demoting pages to recover headroom and a new
        prompt would allocate straight into the pressure), ``recovering``
        trickles (1 per step), ``healthy`` is unbounded (None).  In-flight
        chunked prefills always continue — backoff gates admission, not
        work already holding pages."""
        if health == "spilling":
            return 0
        if health == "recovering":
            return 1
        return None

    def pick_victim(self, candidates: list[tuple[int, Request]],
                    incoming: Request) -> int | None:
        """Slot whose KV pages should be demoted to admit ``incoming``
        (None = nobody; FCFS never preempts)."""
        return None

    def register_metrics(self, reg) -> None:
        """Register queue-flow counters into a
        `repro.obs.metrics.MetricsRegistry`.  All Prometheus-only
        (``in_json=False``): the BENCH JSON schema stays frozen."""
        for name, total in self.flow.items():
            reg.counter(f"scheduler.{name}",
                        help=f"scheduler queue flow: {name}",
                        in_json=False).set_total(total)
        reg.gauge("scheduler.ready", "requests awaiting admission",
                  in_json=False).set(len(self.ready))
        reg.gauge("scheduler.pending", "future trace arrivals",
                  in_json=False).set(len(self._pending))


class PriorityScheduler(Scheduler):
    """Strict priority (higher ``Request.priority`` first), FIFO within a
    level.  Preempts: demotes the lowest-priority active victim strictly
    below the incoming request."""

    name = "priority"

    def __init__(self, *, chunk_tokens: int | None = None,
                 preemptive: bool = True, **kw):
        super().__init__(chunk_tokens=chunk_tokens, preemptive=preemptive,
                         **kw)

    def _select_key(self, req: Request) -> tuple:
        return (-req.priority, req.t_submit, req.rid)

    def select(self, now: float) -> Request:
        self.flow["selected"] += 1
        best = min(self.ready, key=self._select_key)
        self.ready.remove(best)
        return best

    def order_prefilling(
            self, items: list[tuple[int, Request]]) -> list[int]:
        return [slot for slot, _ in
                sorted(items, key=lambda it: self._select_key(it[1]))]

    def pick_victim(self, candidates: list[tuple[int, Request]],
                    incoming: Request) -> int | None:
        victims = [(slot, r) for slot, r in candidates
                   if r.priority < incoming.priority]
        if not victims:
            return None
        # Lowest priority first; ties → the latest-submitted (it has lost
        # the least work and its tail pages are the ones heat will reload).
        slot, _ = min(victims,
                      key=lambda sr: (sr[1].priority, -sr[1].t_submit))
        self.flow["victims"] += 1
        return slot


class SLOScheduler(PriorityScheduler):
    """SLO-aware earliest-deadline-first.

    Deadline = submit time + the request's TTFT SLO (best-effort requests
    sort after every deadline-bearing one, then by priority/arrival).
    Defaults to chunked prefill (``chunk_tokens=32``) — EDF without
    chunking still head-of-line-blocks on long prompts — and shrinks the
    chunk when the telemetry queue-depth EMA exceeds
    ``queue_depth_shrink`` so a backlog drains via faster admissions."""

    name = "slo"

    def __init__(self, *, chunk_tokens: int | None = 32,
                 preemptive: bool = True, **kw):
        super().__init__(chunk_tokens=chunk_tokens, preemptive=preemptive,
                         **kw)

    def _select_key(self, req: Request) -> tuple:
        return (_deadline(req), -req.priority, req.t_submit, req.rid)

    def chunk_budget(self, queue_depth_ema: float = 0.0) -> int | None:
        if self.chunk_tokens is None:
            return None
        if queue_depth_ema > self.queue_depth_shrink:
            return max(self.min_chunk_tokens, self.chunk_tokens // 2)
        return self.chunk_tokens

    def pick_victim(self, candidates: list[tuple[int, Request]],
                    incoming: Request) -> int | None:
        victims = [(slot, r) for slot, r in candidates
                   if r.priority < incoming.priority
                   or _deadline(r) > _deadline(incoming)]
        if not victims:
            return None
        slot, _ = max(victims,
                      key=lambda sr: (_deadline(sr[1]), -sr[1].priority,
                                      sr[1].t_submit))
        self.flow["victims"] += 1
        return slot


SCHEDULERS: dict[str, type[Scheduler]] = {
    cls.name: cls for cls in (Scheduler, PriorityScheduler, SLOScheduler)
}


def get_scheduler(name: str, **kwargs) -> Scheduler:
    """Build a scheduler by name ('fcfs' | 'priority' | 'slo')."""
    try:
        cls = SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; choose from {sorted(SCHEDULERS)}"
        ) from None
    return cls(**kwargs)


def scheduler_names() -> Iterable[str]:
    return sorted(SCHEDULERS)
