"""Online congestion control — the "active" half of paper §4.3.1.

The static plan sizes the in-flight DMA window once, offline
(`core.congestion.optimal_window`).  :class:`AIMDController` closes the
loop: each engine step it reads the achieved per-tier bandwidth from a
pluggable :class:`~repro.core.congestion.MeasurementSource` and adjusts the
window —

* **additive increase** (+1 slot) while the host link is under-saturated
  (achieved host bandwidth below the link limit),
* **multiplicative decrease** (×``beta``) on a congestion signal: either
  the in-flight volume exceeds the bandwidth-delay product by more than
  ``excess_tol`` window slots (Vegas-style ``window − achieved·RTT/chunk``
  drain estimate), or local HBM bandwidth has degraded past ``hbm_tol``
  below the best it has seen (the paper's Fig. 7 interference signal),
* **hold** otherwise — the converged state.

Fed the analytical `CongestionModel` (`congestion.ModelSource`), the
controller provably converges to within one slot of
``optimal_window(...).n_inflight``: below the optimum the host link is
under-saturated so the window grows; more than ~one slot above it the
drain estimate exceeds ``excess_tol`` so the window shrinks; the only
fixed points are the one or two integer windows straddling the
bandwidth-delay product — exactly the static sweep's pick
(`tests/test_runtime.py` sweeps RTT/penalty/chunk sizes to pin this).

:class:`RuntimeController` composes the AIMD controller with the
telemetry plane, the phase-aware re-planner and the page migrator into
the single between-steps hook `serving.engine.ServingEngine` calls.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.core import congestion
from repro_torch.core import engine as offload_engine
from repro_torch.core.ebmodel import WorkloadSpec, total_latency
from repro_torch.core.hardware import HardwareSpec
from repro_torch.runtime import migration as migration_mod
from repro_torch.runtime import replan as replan_mod
from repro_torch.runtime.telemetry import StepSample, Telemetry
from repro_torch.serving.paged_cache import CacheFull


class AIMDController:
    """Additive-increase / multiplicative-decrease window controller."""

    def __init__(
        self,
        *,
        window: int,                  # seed (usually optimal_window's pick)
        host_bw_limit: float,         # nominal host-link bandwidth B_h
        rtt: float,                   # host-link round-trip (s)
        n_streams: int,
        chunk_bytes: int,
        min_window: int = 1,
        max_window: int = 256,
        beta: float = 0.5,
        sat_tol: float = 1e-3,        # host considered saturated above (1-tol)·B_h
        excess_tol: float = 1.5,      # congestion above this many excess slots
        hbm_tol: float = 0.05,        # congestion above this HBM degradation
        max_step: int | None = None,  # per-step window-change budget (0 = frozen)
    ):
        self.window = max(min_window, int(window))
        self.host_bw_limit = host_bw_limit
        self.rtt = rtt
        self.n_streams = max(1, n_streams)
        self.chunk_bytes = chunk_bytes
        self.min_window = min_window
        self.max_window = max_window
        self.beta = beta
        self.sat_tol = sat_tol
        self.excess_tol = excess_tol
        self.hbm_tol = hbm_tol
        self.max_step = max_step
        self.updates = 0
        self.increases = 0
        self.decreases = 0
        self.hold_streak = 0
        self._hbm_ref = 0.0           # best HBM bandwidth seen (≈ undisturbed B_g)
        self._agg: dict[int, float] = {}   # per-window aggregate-bw estimates

    @property
    def converged(self) -> bool:
        """Steady state: the last few updates all held the window."""
        return self.hold_streak >= 3

    def excess_slots(self, sample: congestion.BandwidthSample) -> float:
        """Vegas-style drain estimate: in-flight slots beyond what the
        achieved host bandwidth can keep busy (Little's law)."""
        per_slot = self.n_streams * self.chunk_bytes
        return self.window - sample.host_bw * self.rtt / per_slot

    def update(self, sample: congestion.BandwidthSample) -> int:
        """Ingest one bandwidth observation; returns the new window.

        Fast phase — classic AIMD: multiplicative decrease while congested
        (in-flight volume more than ``excess_tol`` slots past the BDP, or
        HBM bandwidth degraded vs the best seen), additive increase while
        the host link is clearly under-saturated.  Near the peak the
        controller remembers the aggregate bandwidth of each window it
        visits and settles on the *smallest* window within ``sat_tol`` of
        the best aggregate — the same criterion the static sweep
        (`optimal_window`) optimizes, which is what makes the fixed point
        match the sweep's pick to within one slot.
        """
        self.updates += 1
        agg = self._agg.get(self.window)
        self._agg[self.window] = sample.aggregate if agg is None \
            else 0.5 * (agg + sample.aggregate)
        self._hbm_ref = max(self._hbm_ref, sample.hbm_bw)
        best = max(self._agg.values())

        def within_tol(w: int) -> bool:
            a = self._agg.get(w)
            return a is not None and a >= best * (1.0 - self.sat_tol)

        degraded = (self._hbm_ref > 0
                    and sample.hbm_bw < self._hbm_ref * (1.0 - self.hbm_tol))
        congested = degraded or self.excess_slots(sample) > self.excess_tol
        # Host-saturation slack in aggregate terms (B_h + observed B_g).
        slack = self.sat_tol * (self.host_bw_limit + self._hbm_ref)
        under_saturated = sample.host_bw < self.host_bw_limit - slack
        # Block ascent only when the window above is known to *reduce*
        # aggregate bandwidth (past the peak) — a below-tolerance window on
        # the way up is still worth climbing through.
        up_agg = self._agg.get(self.window + 1)
        up_known_bad = up_agg is not None and up_agg < self._agg[self.window]
        # A step down must not land on a window the AI rule would immediately
        # leave again (oscillation): it is safe when the smaller window's
        # aggregate is no worse, or when Little's law predicts the host link
        # stays saturated there.
        down = self.window - 1
        down_agg = self._agg.get(down)
        down_pred_host = min(self.host_bw_limit,
                             down * self.n_streams * self.chunk_bytes / self.rtt)
        down_safe = (down_agg is None
                     or down_agg >= self._agg[self.window]
                     or down_pred_host >= self.host_bw_limit - slack)
        target = self.window
        if congested:
            target = min(self.window - 1, int(self.window * self.beta))
        elif under_saturated and not up_known_bad:
            target = self.window + 1
        elif (self.window > self.min_window and down_safe
              and (down_agg is None or within_tol(down))):
            # Saturated (or the step up is known to hurt): probe/settle
            # downward while the smaller window holds the peak aggregate.
            target = self.window - 1
        target = max(self.min_window, min(self.max_window, target))
        if self.max_step is not None:
            lo = self.window - self.max_step
            hi = self.window + self.max_step
            target = max(lo, min(hi, target))
        if target > self.window:
            self.increases += 1
            self.hold_streak = 0
        elif target < self.window:
            self.decreases += 1
            self.hold_streak = 0
        else:
            self.hold_streak += 1
        self.window = target
        return self.window


@dataclasses.dataclass
class RuntimeStats:
    """Aggregated adaptive-runtime activity for one serving run."""

    replans: int = 0
    promoted_pages: int = 0
    demoted_pages: int = 0
    window_min: int = 0
    window_max: int = 0
    modeled_time_static: float = 0.0   # analytical step-latency, startup ratios
    modeled_time_adaptive: float = 0.0  # analytical step-latency, live ratios
    modeled_tokens: int = 0

    @property
    def modeled_static_tps(self) -> float:
        return self.modeled_tokens / self.modeled_time_static \
            if self.modeled_time_static > 0 else 0.0

    @property
    def modeled_adaptive_tps(self) -> float:
        return self.modeled_tokens / self.modeled_time_adaptive \
            if self.modeled_time_adaptive > 0 else 0.0

    @property
    def modeled_gain(self) -> float:
        return self.modeled_adaptive_tps / self.modeled_static_tps \
            if self.modeled_static_tps > 0 else 1.0


class RuntimeController:
    """The engine's between-steps hook: telemetry in, control actions out.

    Composes the AIMD window controller, the phase-aware re-planner and
    the budgeted page migrator.  `ServingEngine.step` calls
    :meth:`on_step` once per step with that step's :class:`StepSample`;
    the controller records telemetry, updates the window, migrates pages
    within budget, and — when the workload mix has drifted — re-plans and
    incrementally repartitions the params tree it is handed, returning
    the (possibly new) tree.

    Every knob has a zero setting that makes the runtime a provable
    no-op (the parity tests pin this): ``window_budget=0`` freezes the
    window at the static seed, ``migration_budget=0`` disables page
    movement, ``drift_threshold=inf`` disables re-planning.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        plan: offload_engine.TieringPlan,
        hw: HardwareSpec,
        *,
        source: congestion.MeasurementSource | None = None,
        telemetry: Telemetry | None = None,
        window_budget: int | None = None,
        migration_budget: int = 1,
        migration_headroom: int = 1,
        drift_threshold: float = 0.25,
        replan_min_interval: int = 4,
        align: int = 1,
    ):
        self.cfg = cfg
        self.hw = hw
        self.plan = plan                      # live plan (replaced on replan)
        self.base_ratios = dict(plan.op_ratios)
        self.telemetry = telemetry or Telemetry(
            predicted_local_bw=hw.hbm.bandwidth,
            predicted_remote_bw=hw.host.bandwidth)
        model = congestion.CongestionModel(hw)
        self.source = source or congestion.ModelSource(
            model, plan.window.n_streams, plan.window.chunk_bytes)
        # One congestion window per host link, keyed by mesh-axis index: a
        # mesh plan carries P per-link window seeds, a single-chip plan one.
        # Each link runs its own AIMD loop — links congest independently on
        # real hardware (per-chip PCIe) even though the analytical CPU model
        # is symmetric.
        seeds = ([w.n_inflight for w in plan.mesh.link_windows]
                 if plan.mesh is not None else [plan.window.n_inflight])
        self.link_controllers = [
            AIMDController(
                window=seed,
                host_bw_limit=hw.host.bandwidth,
                rtt=model.rtt,
                n_streams=plan.window.n_streams,
                chunk_bytes=plan.window.chunk_bytes,
                max_step=window_budget)
            for seed in seeds]
        self.replanner = replan_mod.Replanner(
            cfg, hw, plan,
            policy=replan_mod.ReplanPolicy(
                drift_threshold=drift_threshold,
                min_interval=replan_min_interval))
        self.migrator = migration_mod.Migrator(
            pages_per_step=migration_budget, headroom=migration_headroom)
        self.align = align
        self._static_window = plan.window.n_inflight
        self.stats = RuntimeStats(
            window_min=self.window, window_max=self.window)
        # Observability hook: called as on_event(name, **args) when a
        # control action actually fires ('migrate' with promoted/demoted,
        # 'replan' with reason/ratio/mix).  The serving engine points it at
        # the trace recorder; None (the default) costs nothing.
        self.on_event = None

    @property
    def window(self) -> int:
        """The window threaded into the kernels: every chip paces its own
        link, so the step issues at the slowest link's window."""
        return min(c.window for c in self.link_controllers)

    @property
    def windows(self) -> tuple[int, ...]:
        """Per-host-link congestion windows (one entry per mesh link)."""
        return tuple(c.window for c in self.link_controllers)

    # -- modeled throughput (the analytical harness) -----------------------
    def _modeled_step_time(self, sample: StepSample,
                           ratios: dict[str, float]) -> float:
        t = 0.0
        if sample.decode_tokens:
            wl = WorkloadSpec(batch=max(1, sample.active_slots),
                              seq_len=max(1, round(sample.mean_kv_len)),
                              phase="decode")
            ops = offload_engine.enumerate_ops(self.cfg, wl)
            t += total_latency(ops, [ratios.get(op.name, 0.0) for op in ops],
                               self.hw)
        if sample.prefill_tokens:
            wl = WorkloadSpec(batch=1, seq_len=sample.prefill_tokens,
                              phase="prefill")
            ops = offload_engine.enumerate_ops(self.cfg, wl)
            t += total_latency(ops, [ratios.get(op.name, 0.0) for op in ops],
                               self.hw)
        return t

    # -- the hook ----------------------------------------------------------
    def on_step(self, sample: StepSample, cache=None,
                params: dict[str, Any] | None = None,
                migration_used: int = 0) -> dict[str, Any] | None:
        """Record one step and run the control actions.

        ``migration_used`` is page movement the engine already performed
        this step outside the migrator (the scheduler's tier-demotion
        preemptions); it draws down the migrator's per-step budget so
        preemption and migration share one movement allowance.

        Returns the params tree — repartitioned when a re-plan fired,
        otherwise the identical object that was passed in.
        """
        self.telemetry.record(sample)
        # Modeled static-vs-adaptive accounting on the *observed* workload.
        self.stats.modeled_time_static += self._modeled_step_time(
            sample, self.base_ratios)
        self.stats.modeled_time_adaptive += self._modeled_step_time(
            sample, self.plan.op_ratios)
        self.stats.modeled_tokens += sample.tokens

        # Each link's AIMD loop gets its own observation when the source
        # can resolve links (TelemetrySource on a mesh); single-link
        # sources feed every controller the same sample — correct there,
        # since off-mesh the aggregate *is* the one link.
        measure_link = getattr(self.source, "measure_link", None)
        for i, link in enumerate(self.link_controllers):
            if measure_link is not None and len(self.link_controllers) > 1:
                link.update(measure_link(i, link.window))
            else:
                link.update(self.source.measure(link.window))
        self.stats.window_min = min(self.stats.window_min, self.window)
        self.stats.window_max = max(self.stats.window_max, self.window)

        if cache is not None:
            try:
                rep = self.migrator.step(cache, budget_used=migration_used)
            except CacheFull:
                # Degraded mode: a move_pages destination filled up under
                # this very step's pressure — skip the pass rather than
                # kill the run; the engine's elastic drain restores room.
                rep = migration_mod.MigrationReport()
            self.stats.promoted_pages += rep.promoted
            self.stats.demoted_pages += rep.demoted
            if rep.moved and self.on_event is not None:
                self.on_event("migrate", **rep.as_args())

        new_plan = self.replanner.maybe_replan(self.telemetry)
        if new_plan is not None:
            self.stats.replans += 1
            self.plan = new_plan
            if params is not None:
                params, _ = replan_mod.repartition(
                    params, new_plan, align=self.align)
            if self.on_event is not None:
                self.on_event("replan", reason=self.replanner.last_reason,
                              ratio=new_plan.global_ratio,
                              mix=self.replanner.planned_mix)
        return params

    def elastic_replan(self, local_fraction: float,
                       params: dict[str, Any] | None) -> dict[str, Any] | None:
        """Elastic degradation hook: the engine's local page budget shrank
        to ``local_fraction`` of what the plan assumed — re-solve the
        greedy allocator at the correspondingly *higher* offload ratio
        (`Replanner.force_ratio`) and incrementally repartition.  Returns
        the (possibly new) params tree; the identical object when the
        ratio would not increase."""
        new_plan = self.replanner.force_ratio(local_fraction, self.telemetry)
        if new_plan is None:
            return params
        self.stats.replans += 1
        self.plan = new_plan
        if params is not None:
            params, _ = replan_mod.repartition(
                params, new_plan, align=self.align)
        if self.on_event is not None:
            self.on_event("replan", reason=self.replanner.last_reason,
                          ratio=new_plan.global_ratio,
                          mix=self.replanner.planned_mix)
        return params

    def report(self) -> dict:
        """Machine-readable runtime summary (BENCH_serving.json keys)."""
        return {
            "window": {
                "static": self._static_window,
                "final": self.window,
                "min": self.stats.window_min,
                "max": self.stats.window_max,
                "converged": all(c.converged for c in self.link_controllers),
                "per_link": list(self.windows),
            },
            "replans": self.stats.replans,
            "migration": {"promoted": self.stats.promoted_pages,
                          "demoted": self.stats.demoted_pages},
            "modeled": {
                "static_tokens_per_s": self.stats.modeled_static_tps,
                "adaptive_tokens_per_s": self.stats.modeled_adaptive_tps,
                "gain": self.stats.modeled_gain,
            },
            "telemetry": self.telemetry.report(),
        }
