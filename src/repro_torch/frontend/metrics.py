"""Per-request lifecycle accounting for the serving frontend.

Three pieces, all numpy/stdlib below the engine (no serving imports, so
`serving.engine` can fold them into `EngineStats` without a cycle):

* **Clocks** — the engine timestamps every lifecycle event through a
  :class:`Clock`.  :class:`WallClock` is ``time.time`` (the default; the
  engine behaves exactly as before).  :class:`ModeledClock` is a virtual
  clock the engine advances by the analytical step latency
  (:func:`modeled_step_seconds`) — trace replay and the scheduler
  acceptance tests run on it so TTFT/SLO comparisons are deterministic
  functions of the schedule, not of CPU-interpret wall time.
* **Per-request records** — :class:`RequestRecord` snapshots one finished
  request (class, priority, queue delay, TTFT, end-to-end latency,
  preemption count, SLO verdict).
* **SLO reports** — :func:`slo_report` groups records per tenant class:
  attainment (fraction of requests whose TTFT met their SLO), TTFT / queue
  delay / e2e percentiles, preemption totals.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------
class Clock:
    """Timestamp source for request lifecycle events."""

    kind = "abstract"      # provenance / trace-metadata tag

    def now(self) -> float:
        raise NotImplementedError

    def advance(self, dt: float) -> None:   # pragma: no cover - interface
        """Advance virtual time (no-op on wall clocks)."""


class WallClock(Clock):
    kind = "wall"

    def now(self) -> float:
        return time.time()

    def advance(self, dt: float) -> None:
        pass


class ModeledClock(Clock):
    """Virtual time advanced by the engine's modeled per-step latency.

    Starts at 0.0 so trace arrival offsets are absolute times."""

    kind = "modeled"

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.t += dt


@dataclasses.dataclass(frozen=True)
class OpCost:
    """One op's priced latency inside a modeled tick, with its binding term.

    ``seconds`` is exactly ``OpProfile.latency(x, hw)`` — the max of the
    compute time and the two tier streams — and ``bound`` names which of
    the three terms won the max ('compute' | 'hbm' | 'host'; ties resolve
    in that order, mirroring ``max``'s first-argument preference)."""

    name: str
    kind: str                      # "linear" (weights) | "attention" (KV)
    phase: str                     # "decode" | "prefill"
    seconds: float
    bound: str                     # "compute" | "hbm" | "host"


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Decomposition of one modeled clock tick (`modeled_step_cost`).

    ``total`` reproduces the scalar the clock advances by with the *exact*
    accumulation order the pre-decomposition ``modeled_step_seconds`` used
    — per-op left fold inside each ops group, then the five terms folded
    in sequence — so the clock and any profiler reading the parts cannot
    drift by even a ULP.  Terms that do not apply are exactly 0.0 (adding
    them is a bitwise no-op)."""

    decode_ops: tuple[OpCost, ...] = ()
    kv_local: float = 0.0          # live KV read from the HBM tier
    kv_remote: float = 0.0         # live KV read over the host link(s)
    pool_copy: float = 0.0         # eager functional-update copy traffic
    prefill_ops: tuple[OpCost, ...] = ()

    @property
    def total(self) -> float:
        t = 0.0
        t += sum(oc.seconds for oc in self.decode_ops)
        t += self.kv_local
        t += self.kv_remote
        t += self.pool_copy
        t += sum(oc.seconds for oc in self.prefill_ops)
        return t


def _op_costs(cfg, hw, op_ratios, wl, *, drop_attention: bool,
              phase: str) -> tuple[OpCost, ...]:
    from repro_torch.core import engine as offload_engine

    ops = offload_engine.enumerate_ops(cfg, wl)
    if drop_attention:
        ops = [op for op in ops if op.kind != "attention"]
    out = []
    for op in ops:
        x = op_ratios.get(op.name, 0.0)
        secs = op.latency(x, hw)
        if secs == op.t_comp(hw):
            bound = "compute"
        elif secs == op.bytes * (1.0 - x) / hw.hbm.bandwidth:
            bound = "hbm"
        else:
            bound = "host"
        out.append(OpCost(name=op.name, kind=op.kind, phase=phase,
                          seconds=secs, bound=bound))
    return tuple(out)


def modeled_step_cost(
    cfg,
    hw,
    op_ratios: dict[str, float],
    *,
    prefill_tokens: int = 0,
    decode_slots: int = 0,
    mean_kv_len: float = 0.0,
    kv_local_bytes: float = 0.0,
    kv_remote_bytes: float = 0.0,
    hbm_copy_bytes: float = 0.0,
) -> StepCost:
    """Analytical cost of one engine tick, decomposed per term.

    Weights go through the paper's EB model (`core.ebmodel` per-op
    latencies over the plan's ratios — same machinery as the adaptive
    runtime's static-vs-adaptive accounting).  The decode KV term uses the
    *live* page residency when the caller passes ``kv_local_bytes`` /
    ``kv_remote_bytes`` (each tier streamed at its own bandwidth), so tier
    demotion — preemption, migration, spills — is visible to the clock;
    with both at zero the planner's attention ops price the KV instead.
    ``hbm_copy_bytes`` prices functional-update copy traffic at HBM
    bandwidth: the eager (un-jitted) decode step materializes a fresh copy
    of each KV page pool per layer scatter, while the jitted step donates
    the pools and writes in place (zero) — this term is what makes the
    eager-vs-jitted throughput row a deterministic gateable figure.

    ``StepCost.total`` is the modeled clock's tick; the attribution
    profiler (`repro.obs.attribution`) records the same object, so the
    clock and the per-step ledger share one pricing path by construction.
    """
    from repro_torch.core.ebmodel import WorkloadSpec

    live_kv = kv_local_bytes > 0 or kv_remote_bytes > 0
    decode_ops: tuple[OpCost, ...] = ()
    kv_local = kv_remote = 0.0
    if decode_slots:
        wl = WorkloadSpec(batch=decode_slots,
                          seq_len=max(1, round(mean_kv_len)), phase="decode")
        decode_ops = _op_costs(cfg, hw, op_ratios, wl,
                               drop_attention=live_kv, phase="decode")
        kv_local = kv_local_bytes / hw.hbm.bandwidth
        kv_remote = kv_remote_bytes / hw.host.bandwidth
    pool_copy = hbm_copy_bytes / hw.hbm.bandwidth if hbm_copy_bytes else 0.0
    prefill_ops: tuple[OpCost, ...] = ()
    if prefill_tokens:
        wl = WorkloadSpec(batch=1, seq_len=prefill_tokens, phase="prefill")
        prefill_ops = _op_costs(cfg, hw, op_ratios, wl,
                                drop_attention=False, phase="prefill")
    return StepCost(decode_ops=decode_ops, kv_local=kv_local,
                    kv_remote=kv_remote, pool_copy=pool_copy,
                    prefill_ops=prefill_ops)


def modeled_step_seconds(
    cfg,
    hw,
    op_ratios: dict[str, float],
    *,
    prefill_tokens: int = 0,
    decode_slots: int = 0,
    mean_kv_len: float = 0.0,
    kv_local_bytes: float = 0.0,
    kv_remote_bytes: float = 0.0,
    hbm_copy_bytes: float = 0.0,
) -> float:
    """Analytical latency of one engine step (the modeled clock's tick).

    Thin wrapper over :func:`modeled_step_cost` — the scalar is the
    decomposition's ``total``, so the clock and the attribution ledger
    can never disagree about what a step cost."""
    return modeled_step_cost(
        cfg, hw, op_ratios,
        prefill_tokens=prefill_tokens, decode_slots=decode_slots,
        mean_kv_len=mean_kv_len, kv_local_bytes=kv_local_bytes,
        kv_remote_bytes=kv_remote_bytes, hbm_copy_bytes=hbm_copy_bytes).total


# ---------------------------------------------------------------------------
# Per-request lifecycle records
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """Snapshot of one finished request's lifecycle."""

    rid: int
    cls: str                        # tenant / priority class name
    priority: int
    prompt_tokens: int
    output_tokens: int
    queue_delay: float              # first prefill chunk − submit
    ttft: float                     # first token − submit
    e2e: float                      # done − submit
    preemptions: int                # tier-demotion preemptions suffered
    slo_ttft_s: float | None        # the class's TTFT SLO (None = best effort)
    admitted_degraded: bool = False
    # admitted while the engine health state was not 'healthy' (elastic
    # degradation backoff let it through as a recovery trickle) — these
    # requests' latencies price the degraded window, so reports can
    # separate them from steady-state admissions

    @property
    def slo_ok(self) -> bool | None:
        """TTFT within SLO (None when the request carries no SLO)."""
        if self.slo_ttft_s is None:
            return None
        return self.ttft <= self.slo_ttft_s


def percentile(values: list[float], q: float) -> float:
    return float(np.percentile(values, q)) if values else 0.0


def slo_report(records: list[RequestRecord]) -> dict:
    """Per-class SLO attainment + latency percentiles.

    Returns ``{cls: {requests, attainment, ttft_p50/p95, queue_delay_p95,
    e2e_p95, preemptions}}``; ``attainment`` is None for classes with no
    SLO (best effort)."""
    by_cls: dict[str, list[RequestRecord]] = {}
    for r in records:
        by_cls.setdefault(r.cls, []).append(r)
    out: dict[str, dict] = {}
    for cls, rs in sorted(by_cls.items()):
        verdicts = [r.slo_ok for r in rs if r.slo_ok is not None]
        out[cls] = {
            "requests": len(rs),
            "attainment": (sum(verdicts) / len(verdicts)) if verdicts else None,
            "ttft_p50": percentile([r.ttft for r in rs], 50),
            "ttft_p95": percentile([r.ttft for r in rs], 95),
            "queue_delay_p95": percentile([r.queue_delay for r in rs], 95),
            "e2e_p95": percentile([r.e2e for r in rs], 95),
            "preemptions": sum(r.preemptions for r in rs),
            "degraded_admissions": sum(r.admitted_degraded for r in rs),
        }
    return out
