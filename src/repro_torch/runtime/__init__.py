"""Adaptive runtime — the feedback loop the paper calls "active" (§4.3.1).

The planner (`core.planner`) and the static congestion window
(`core.congestion.optimal_window`) are one-shot offline computations; this
package closes the loop at serving time:

* `telemetry`  — per-step counters (bytes per tier, achieved vs predicted
  bandwidth, page touch histogram, queue depth, prefill/decode mix) with
  ring-buffer + EMA aggregation;
* `controller` — AIMD congestion-window controller adjusting the in-flight
  DMA window from observed bandwidth, seeded by `optimal_window`;
* `replan`     — phase-aware re-planner: re-runs the greedy allocator when
  the observed workload mix drifts, then incrementally repartitions only
  the operands whose ratios moved;
* `migration`  — bounded-budget live page migration for `PagedTieredCache`
  driven by the telemetry touch histogram.

`controller.RuntimeController` composes the four into the single hook
`serving.engine.ServingEngine` calls between steps.  Submodules are
imported directly (``from repro.runtime import telemetry``) — this package
init stays import-free so `serving.paged_cache` can depend on
`runtime.telemetry` while `runtime.migration` depends on
`serving.paged_cache` without a cycle.
"""
