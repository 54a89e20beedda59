"""Engine health state machine — elastic degradation, never-OOM.

A production engine must degrade, not die: capacity pressure on the local
(HBM) tier becomes *bandwidth* pressure on the direct-access path, never a
``CacheFull`` crash.  The ladder (grounded in the nomarr VRAM-budget →
CPU-spill → recovering design):

* ``healthy``    — no elastic events, full admission;
* ``spilling``   — an elastic event fired this step (a caught
  ``CacheFull``, a local-budget shrink leaving a deficit, an emergency
  remote-pool growth): the engine is actively demoting pages and the
  frontend sheds new admissions;
* ``recovering`` — the deficit is drained and no new events are firing:
  admissions trickle back (one per step) until ``recover_steps`` clean
  steps promote the engine back to ``healthy``.

Transitions are driven only by *elastic events*, never by occupancy: a
normal run legitimately fills the local pool (hottest-first placement
spills by design), so an occupancy trigger would break the zero-pressure
bitwise-identity guarantee.  With no pressure the monitor never leaves
``healthy`` and every counter stays zero — the same zero-budget no-op
discipline the adaptive runtime follows.

Pure stdlib, no jax/serving imports — sits below both `serving.engine`
(which always owns one monitor, runtime attached or not) and the runtime
controller.
"""
from __future__ import annotations

import dataclasses

HEALTHY = "healthy"
SPILLING = "spilling"
RECOVERING = "recovering"


@dataclasses.dataclass
class ElasticCounters:
    """Aggregated elastic-degradation activity for one serving run."""

    cache_full_caught: int = 0     # CacheFull converted into degradation
    elastic_demoted_pages: int = 0  # deficit-drain demotions (not preempt)
    remote_grown_pages: int = 0    # emergency host-pool growth
    shrink_events: int = 0         # local-budget shrinks applied
    shed_steps: int = 0            # steps the frontend shed admissions
    elastic_replans: int = 0       # forced higher-ratio re-plans

    @property
    def events(self) -> int:
        """Total elastic events (the spilling triggers)."""
        return (self.cache_full_caught + self.shrink_events
                + self.remote_grown_pages)


class HealthMonitor:
    """The ``healthy → spilling → recovering → healthy`` ladder.

    :meth:`pressure` records an elastic event (→ ``spilling``);
    :meth:`observe`, called once per engine step with the cache's current
    deficit, walks the ladder back down: no deficit and no fresh events
    → ``recovering``, then ``healthy`` after ``recover_steps`` clean
    steps.  ``transitions`` keeps the (step, from, to) history for
    reports.
    """

    def __init__(self, recover_steps: int = 3):
        if recover_steps < 1:
            raise ValueError("recover_steps must be >= 1")
        self.state = HEALTHY
        self.recover_steps = recover_steps
        self.counters = ElasticCounters()
        self.transitions: list[tuple[int, str, str]] = []
        # Observability hook: called as listener(event, **info) on every
        # elastic event ('pressure', kind=..., pages=...) and ladder move
        # ('transition', src=..., dst=...).  The serving engine points it
        # at the trace recorder; None (the default) keeps the monitor
        # pure-stdlib with zero overhead.
        self.listener = None
        self._clean = 0                # consecutive event-free steps
        self._step_events = 0          # events since the last observe()
        self._step = 0

    def _transition(self, state: str) -> None:
        if state != self.state:
            self.transitions.append((self._step, self.state, state))
            if self.listener is not None:
                self.listener("transition", src=self.state, dst=state)
            self.state = state

    # -- event ingestion ---------------------------------------------------
    def pressure(self, kind: str, pages: int = 0) -> None:
        """Record one elastic event; the engine enters ``spilling``.

        ``kind``: 'cache_full' (a caught allocation failure), 'shrink'
        (local budget reduced, `pages` = resulting deficit), 'demote'
        (deficit-drain pages moved), 'grow' (remote pool grown by
        `pages`), or 'replan' (forced higher-ratio re-plan)."""
        c = self.counters
        if kind == "cache_full":
            c.cache_full_caught += 1
        elif kind == "shrink":
            c.shrink_events += 1
        elif kind == "demote":
            c.elastic_demoted_pages += pages
        elif kind == "grow":
            c.remote_grown_pages += pages
        elif kind == "replan":
            c.elastic_replans += 1
        else:
            raise ValueError(f"unknown pressure kind {kind!r}")
        if self.listener is not None:
            self.listener("pressure", kind=kind, pages=pages)
        if kind != "replan":           # replans are a response, not pressure
            self._step_events += 1
            self._clean = 0
            self._transition(SPILLING)

    def shed(self) -> None:
        """The frontend shed admissions this step (backoff accounting)."""
        self.counters.shed_steps += 1

    # -- per-step recovery -------------------------------------------------
    def observe(self, deficit: int) -> str:
        """One engine step's health update: `deficit` is the cache's
        current over-budget page count.  Returns the (possibly new)
        state."""
        self._step += 1
        fresh, self._step_events = self._step_events, 0
        if self.state == HEALTHY:
            return self.state
        if deficit > 0 or fresh > 0:
            self._clean = 0
            self._transition(SPILLING)
            return self.state
        if self.state == SPILLING:
            self._clean = 1
            self._transition(RECOVERING)
            return self.state
        self._clean += 1
        if self._clean >= self.recover_steps:
            self._transition(HEALTHY)
        return self.state

    def report(self) -> dict:
        """Machine-readable health summary (BENCH_serving.json key)."""
        c = self.counters
        return {
            "state": self.state,
            "cache_full_caught": c.cache_full_caught,
            "elastic_demoted_pages": c.elastic_demoted_pages,
            "remote_grown_pages": c.remote_grown_pages,
            "shrink_events": c.shrink_events,
            "shed_steps": c.shed_steps,
            "elastic_replans": c.elastic_replans,
            "transitions": [list(t) for t in self.transitions],
        }

    def register_metrics(self, reg, prefix: str = "elastic") -> None:
        """Register the elastic counters into a
        `repro_torch.obs.metrics.MetricsRegistry` — field order mirrors
        :meth:`report` so the registry's JSON view is byte-identical to
        the hand-built ``elastic`` block it replaces."""
        c = self.counters
        reg.const(f"{prefix}.state", self.state, "final health state")
        for name, total in (
                ("cache_full_caught", c.cache_full_caught),
                ("elastic_demoted_pages", c.elastic_demoted_pages),
                ("remote_grown_pages", c.remote_grown_pages),
                ("shrink_events", c.shrink_events),
                ("shed_steps", c.shed_steps),
                ("elastic_replans", c.elastic_replans)):
            reg.counter(f"{prefix}.{name}").set_total(total)
        reg.const(f"{prefix}.transitions",
                  [list(t) for t in self.transitions])
