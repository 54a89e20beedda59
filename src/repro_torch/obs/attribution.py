"""Per-step time/byte attribution — explain every modeled second.

The modeled clock prices each engine step with
`frontend.metrics.modeled_step_cost`; this module keeps the *parts*.  A
:class:`StepLedger` holds the step's `StepCost` ticks (one per prefill
chunk plus one decode tick) and attributes the step's ``duration_s`` to
the component taxonomy in :data:`COMPONENTS` — compute per phase, HBM
streams, host-link streams per tier, eager pool-copy traffic.

**Exactness contract.**  On a modeled-clock replay the ledger does not
re-derive the step time: :meth:`StepLedger.attributed_seconds` *replays*
the clock arithmetic (``t = t_start; t += tick.total; ...``), which is
bit-for-bit the sequence of additions `ModeledClock.advance` performed,
so ``attributed_seconds() == StepSample.duration_s`` exactly and
:meth:`StepLedger.unattributed` is exactly ``0.0``
(`tests/test_attribution.py` pins this across families × offload ratios
× mesh widths).  The per-component dict (:meth:`StepLedger.components`)
re-associates the same float terms into buckets, so bucket sums are
ULP-approximate — reporting-level only; the identity lives on the replay.
On a wall clock the modeled decomposition is an *estimate* and the
residual against real wall time is the explicit ``unattributed`` term
(it may be negative when the model over-prices a step).

:data:`NULL_PROFILER` is the engine default: ``enabled`` is False and
every hook is a no-op, so serving with attribution off stays
bitwise-identical (same contract as `obs.trace.NULL_RECORDER`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

from repro_torch.frontend.metrics import OpCost, StepCost

# Canonical component order (trace counter args, metrics gauges, flight
# snapshots and the CLI all render in this order).
COMPONENTS = (
    "prefill_compute",
    "decode_compute",
    "kv_local_hbm",
    "kv_remote_link",
    "weight_local_hbm",
    "weight_remote_link",
    "pool_copy",
    "ici_broadcast",
    "unattributed",
)

# (op kind, binding term) -> component.  Attention ops stream KV pages,
# linear ops stream weight partitions; the binding term names the tier.
_TIER_BUCKET = {
    ("attention", "hbm"): "kv_local_hbm",
    ("attention", "host"): "kv_remote_link",
    ("linear", "hbm"): "weight_local_hbm",
    ("linear", "host"): "weight_remote_link",
}


def op_bucket(oc: OpCost) -> str:
    """Component an `OpCost` charges: compute time by phase, stream time
    by (kind, tier)."""
    if oc.bound == "compute":
        return "prefill_compute" if oc.phase == "prefill" else "decode_compute"
    bucket = _TIER_BUCKET.get((oc.kind, oc.bound))
    if bucket is None:                      # unknown kind: charge the tier
        bucket = "weight_local_hbm" if oc.bound == "hbm" else "weight_remote_link"
    return bucket


@dataclasses.dataclass
class StepLedger:
    """One step's attribution record: the ticks that priced it plus the
    byte/bandwidth context from its `StepSample`."""

    step: int
    t_start: float                          # engine-clock step origin
    duration_s: float                       # StepSample.duration_s
    ticks: tuple[StepCost, ...]
    clock_kind: str                         # "wall" | "modeled"
    prefill_tokens: int = 0
    decode_tokens: int = 0
    bytes_local: float = 0.0
    bytes_remote: float = 0.0
    bytes_per_link: tuple[float, ...] | None = None
    optimal_bw: float | None = None         # plan's optimal aggregate B/s
    label: str = "idle"                     # bottleneck label (set at close)

    # -- the exact identity -------------------------------------------------
    def attributed_seconds(self) -> float:
        """Replay of the clock arithmetic over this step's ticks.

        Performs the identical float additions `ModeledClock.advance` did
        (accumulate onto ``t_start``, subtract it back out), so on a
        modeled clock this equals ``duration_s`` bitwise."""
        t = self.t_start
        for tick in self.ticks:
            t += tick.total
        return t - self.t_start

    def unattributed(self) -> float:
        """Residual vs the recorded step duration: exactly 0.0 on modeled
        clocks (non-idle steps), real measurement residual on wall clocks
        (possibly negative when the model over-prices)."""
        return self.duration_s - self.attributed_seconds()

    # -- reporting-level decomposition --------------------------------------
    def components(self) -> dict[str, float]:
        """Per-component seconds in :data:`COMPONENTS` order.

        Bucket aggregation re-associates float additions, so the bucket
        sum can differ from ``attributed_seconds()`` by ULPs — the exact
        identity is the replay above, not this dict.  ``ici_broadcast``
        is reserved (0.0): the modeled clock does not price the fetch-once
        broadcast, which overlaps the host-link stream (docs/serving.md)."""
        out = dict.fromkeys(COMPONENTS, 0.0)
        for tick in self.ticks:
            for oc in tick.decode_ops:
                out[op_bucket(oc)] += oc.seconds
            out["kv_local_hbm"] += tick.kv_local
            out["kv_remote_link"] += tick.kv_remote
            out["pool_copy"] += tick.pool_copy
            for oc in tick.prefill_ops:
                out[op_bucket(oc)] += oc.seconds
        out["unattributed"] = self.unattributed()
        return out

    # -- bandwidth audit -----------------------------------------------------
    @property
    def achieved_bw(self) -> float:
        """Achieved aggregate bandwidth this step (both tiers), B/s."""
        return (self.bytes_local + self.bytes_remote) / max(self.duration_s,
                                                            1e-12)

    @property
    def optimal_fraction(self) -> float:
        """``achieved_aggregate_bw / optimal_aggregate_bw`` — the paper's
        optimality figure, against `core.congestion.optimal_window`'s
        converged aggregate for this plan."""
        from repro_torch.obs.bottleneck import optimality_fraction

        return optimality_fraction(self.achieved_bw, self.optimal_bw)

    @property
    def link_fractions(self) -> tuple[float, ...] | None:
        """Per-link optimality under a mesh: each host link's achieved
        bytes/s against its 1/P share of the optimal aggregate."""
        if not self.bytes_per_link or not self.optimal_bw:
            return None
        per_link_opt = self.optimal_bw / len(self.bytes_per_link)
        d = max(self.duration_s, 1e-12)
        return tuple((b / d) / per_link_opt for b in self.bytes_per_link)


class NullProfiler:
    """Default profiler: disabled, every hook a no-op (the engine calls
    these unconditionally-guarded by ``enabled``; the null object keeps
    them safe to call anyway)."""

    enabled = False
    optimal_bw: float | None = None
    clock_kind = "wall"
    last_ledger: StepLedger | None = None
    last_transition: tuple[int, str, str] | None = None

    def attach(self, *, clock_kind: str, optimal_bw: float) -> None:
        pass

    def on_tick(self, cost: StepCost) -> None:
        pass

    def close_step(self, sample: Any, *, t_start: float) -> StepLedger | None:
        return None

    def report(self) -> dict[str, Any]:
        return {}


NULL_PROFILER = NullProfiler()


class AttributionProfiler(NullProfiler):
    """Collects per-tick `StepCost`s from the engine and closes them into
    per-step :class:`StepLedger`s, feeding the bottleneck auditor.

    Lifecycle (mirrors the engine's step): `_clock_tick_prefill` /
    `_clock_tick_decode` call :meth:`on_tick` with the same `StepCost`
    the modeled clock advanced by; `_runtime_step` calls
    :meth:`close_step` with the step's `StepSample` — the ledger lands in
    a bounded ring (for the CLI/flight) and the running per-component
    totals + the auditor's label/optimality statistics update."""

    enabled = True

    def __init__(self, keep: int = 1024):
        from repro_torch.obs.bottleneck import BottleneckAuditor

        self.optimal_bw = None
        self.clock_kind = "wall"
        self.auditor = BottleneckAuditor()
        self.ledgers: collections.deque[StepLedger] = collections.deque(
            maxlen=keep)
        self.totals: dict[str, float] = dict.fromkeys(COMPONENTS, 0.0)
        self.steps = 0
        self.last_ledger = None
        self.last_transition = None
        self._pending: list[StepCost] = []

    # -- engine hooks --------------------------------------------------------
    def attach(self, *, clock_kind: str, optimal_bw: float) -> None:
        self.clock_kind = clock_kind
        self.optimal_bw = float(optimal_bw)

    def on_tick(self, cost: StepCost) -> None:
        self._pending.append(cost)

    def close_step(self, sample: Any, *, t_start: float) -> StepLedger:
        ledger = StepLedger(
            step=int(sample.step),
            t_start=float(t_start),
            duration_s=float(sample.duration_s),
            ticks=tuple(self._pending),
            clock_kind=self.clock_kind,
            prefill_tokens=int(sample.prefill_tokens),
            decode_tokens=int(sample.decode_tokens),
            bytes_local=float(sample.local_bytes),
            bytes_remote=float(sample.remote_bytes),
            bytes_per_link=sample.remote_bytes_per_link,
            optimal_bw=self.optimal_bw)
        self._pending = []
        label, prev = self.auditor.observe(ledger)
        ledger.label = label
        comps = ledger.components()
        for comp in COMPONENTS:
            self.totals[comp] += comps[comp]
        self.steps += 1
        self.ledgers.append(ledger)
        self.last_ledger = ledger
        self.last_transition = ((ledger.step, prev, label)
                                if prev is not None and prev != label else None)
        return ledger

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict[str, Any]:
        """JSON-serializable run summary (flight bundles, roofline rows)."""
        return {
            "steps": self.steps,
            "clock": self.clock_kind,
            "optimal_bw": self.optimal_bw,
            "seconds": dict(self.totals),
            "bottleneck": self.auditor.report(),
        }

    def register_metrics(self, reg) -> None:
        """Register the ``attribution.*`` / ``bottleneck.*`` gauges.

        Only called when the profiler is enabled, so the BENCH JSON schema
        and Prometheus exposition are unchanged for profiler-off runs."""
        from repro_torch.obs.bottleneck import CATEGORIES, LABELS

        reg.gauge("attribution.steps", "steps the ledger attributed").set(
            self.steps)
        for comp in COMPONENTS:
            reg.gauge(f"attribution.seconds.{comp}",
                      f"total {comp} seconds over the run").set(
                self.totals[comp])
        aud = self.auditor
        for lab in LABELS:
            reg.gauge(f"bottleneck.labels.{lab}",
                      f"steps labeled {lab}-bound").set(aud.labels[lab])
        reg.gauge("bottleneck.transitions",
                  "bottleneck label changes over the run").set(
            len(aud.transitions))
        util = aud.utilization()
        for cat in CATEGORIES:
            reg.gauge(f"bottleneck.utilization.{cat}",
                      f"fraction of attributed time on {cat}").set(util[cat])
        frac = aud.fraction_stats()
        reg.gauge("bottleneck.optimal_fraction.mean",
                  "mean achieved/optimal aggregate bandwidth").set(
            frac["mean"])
        reg.gauge("bottleneck.optimal_fraction.max").set(frac["max"])
        reg.gauge("bottleneck.optimal_fraction.last").set(frac["last"])
        reg.gauge("bottleneck.optimal_bw",
                  "plan-time optimal aggregate bandwidth (B/s)").set(
            self.optimal_bw or 0.0)
