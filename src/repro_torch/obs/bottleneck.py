"""Bottleneck auditor — label every step, audit bandwidth vs the optimum.

Built on the attribution ledger (`obs.attribution`): each step's
per-component seconds collapse into four resource categories and the
step is labeled by the dominant one —

========== =====================================================
label      components
========== =====================================================
compute    prefill_compute, decode_compute
hbm        kv_local_hbm, weight_local_hbm, pool_copy
host_link  kv_remote_link, weight_remote_link
ici        ici_broadcast (reserved; the modeled clock prices the
           fetch-once broadcast as overlapped, so 0.0 today)
idle       nothing attributed (admission-only / empty steps)
========== =====================================================

(``unattributed`` — the wall-clock residual — is deliberately outside
the taxonomy: a step is labeled by what the *model* can explain.)

The auditor also tracks the paper's headline figure per step:
``achieved_aggregate_bw / optimal_aggregate_bw``, where the denominator
is the engine plan's `core.congestion.optimal_window` aggregate — the
smallest-window bandwidth optimum DAK's AIMD controller converges to
(`tests/test_attribution.py` pins fraction ≈ 1.0 at the converged
window on the analytical model).

`report_from_trace` / `report_from_bench` rebuild the same report from
a saved Chrome trace (the ``attribution`` / ``bw.optimal_fraction``
counter tracks) or a ``BENCH_serving.json`` document — the backing for
``python -m repro_torch.obs bottleneck``.
"""
from __future__ import annotations

from typing import Any

from repro_torch.obs.attribution import COMPONENTS, StepLedger

# component -> resource category (insertion order is the tie-break order
# for the label argmax: compute > hbm > host_link > ici).
CATEGORY = {
    "prefill_compute": "compute",
    "decode_compute": "compute",
    "kv_local_hbm": "hbm",
    "weight_local_hbm": "hbm",
    "pool_copy": "hbm",
    "kv_remote_link": "host_link",
    "weight_remote_link": "host_link",
    "ici_broadcast": "ici",
}
CATEGORIES = ("compute", "hbm", "host_link", "ici")
LABELS = CATEGORIES + ("idle",)


def label_components(components: dict[str, float]) -> str:
    """Bottleneck label for one step's per-component seconds: the
    category with the most attributed time ('idle' when nothing was)."""
    totals = dict.fromkeys(CATEGORIES, 0.0)
    for comp, cat in CATEGORY.items():
        totals[cat] += components.get(comp, 0.0)
    best = max(totals, key=totals.get)       # ties -> CATEGORIES order
    return best if totals[best] > 0.0 else "idle"


def optimality_fraction(achieved_bw: float, optimal_bw: float | None) -> float:
    """``achieved / optimal`` aggregate bandwidth (0.0 with no optimum)."""
    if not optimal_bw or optimal_bw <= 0.0:
        return 0.0
    return achieved_bw / optimal_bw


class BottleneckAuditor:
    """Running label / utilization / optimality statistics over a run's
    ledgers (owned by `attribution.AttributionProfiler`)."""

    def __init__(self):
        self.labels: dict[str, int] = dict.fromkeys(LABELS, 0)
        self.category_seconds: dict[str, float] = dict.fromkeys(
            CATEGORIES, 0.0)
        self.transitions: list[tuple[int, str, str]] = []
        self.fractions: list[float] = []
        self.last_label: str | None = None
        self.steps = 0

    def observe(self, ledger: StepLedger) -> tuple[str, str | None]:
        """Fold one closed ledger in; returns (label, previous label) so
        the engine can emit a trace instant on a transition."""
        comps = ledger.components()
        label = label_components(comps)
        prev = self.last_label
        self.labels[label] += 1
        for comp, cat in CATEGORY.items():
            self.category_seconds[cat] += comps[comp]
        self.fractions.append(ledger.optimal_fraction)
        if prev is not None and prev != label:
            self.transitions.append((ledger.step, prev, label))
        self.last_label = label
        self.steps += 1
        return label, prev

    def utilization(self) -> dict[str, float]:
        """Fraction of total attributed time spent on each category."""
        total = sum(self.category_seconds.values())
        return {cat: (s / total if total > 0.0 else 0.0)
                for cat, s in self.category_seconds.items()}

    def fraction_stats(self) -> dict[str, float]:
        fr = self.fractions
        return {
            "mean": sum(fr) / len(fr) if fr else 0.0,
            "max": max(fr) if fr else 0.0,
            "last": fr[-1] if fr else 0.0,
        }

    def report(self) -> dict[str, Any]:
        return {
            "steps": self.steps,
            "labels": dict(self.labels),
            "utilization": self.utilization(),
            "transitions": len(self.transitions),
            "optimal_fraction": self.fraction_stats(),
        }


# ---------------------------------------------------------------------------
# Offline reports (the `repro_torch.obs bottleneck` CLI)
# ---------------------------------------------------------------------------
def _attributed_total(components: dict[str, float]) -> float:
    """Reporting-level step total: every component except the residual."""
    return sum(v for k, v in components.items() if k != "unattributed")


def report_from_trace(doc: dict[str, Any], top_k: int = 5) -> dict[str, Any]:
    """Rebuild the per-step bottleneck report from a traced run.

    Consumes the ``attribution`` counter track (one sample per closed
    step, args = per-component seconds) paired in emission order with the
    ``bw.optimal_fraction`` track.  Raises ``ValueError`` when the trace
    carries no attribution track (run `launch.serve` with
    ``--attribution``)."""
    events = doc.get("traceEvents", [])
    comp_samples: list[tuple[float, dict[str, float]]] = []
    fractions: list[float] = []
    for ev in events:
        if ev.get("ph") != "C":
            continue
        if ev.get("name") == "attribution":
            comp_samples.append((float(ev.get("ts", 0.0)),
                                 dict(ev.get("args", {}))))
        elif ev.get("name") == "bw.optimal_fraction":
            fractions.append(float(ev.get("args", {}).get("fraction", 0.0)))
    if not comp_samples:
        raise ValueError(
            "trace has no 'attribution' counter track — was the run served "
            "with --attribution?")
    steps = []
    totals: dict[str, float] = dict.fromkeys(COMPONENTS, 0.0)
    labels: dict[str, int] = dict.fromkeys(LABELS, 0)
    for i, (ts, comps) in enumerate(comp_samples):
        for comp in COMPONENTS:
            totals[comp] += comps.get(comp, 0.0)
        label = label_components(comps)
        labels[label] += 1
        dominant = max((c for c in COMPONENTS if c != "unattributed"),
                       key=lambda c: comps.get(c, 0.0))
        steps.append({
            "index": i,
            "ts_us": ts,
            "seconds": _attributed_total(comps),
            "label": label,
            "dominant": dominant,
            "dominant_s": comps.get(dominant, 0.0),
            "unattributed_s": comps.get("unattributed", 0.0),
            "optimal_fraction": fractions[i] if i < len(fractions) else None,
        })
    fr = [s["optimal_fraction"] for s in steps
          if s["optimal_fraction"] is not None]
    top = sorted(steps, key=lambda s: s["seconds"], reverse=True)[:top_k]
    return {
        "source": "trace",
        "steps": len(steps),
        "seconds": totals,
        "labels": labels,
        "optimal_fraction": {
            "mean": sum(fr) / len(fr) if fr else 0.0,
            "max": max(fr) if fr else 0.0,
            "last": fr[-1] if fr else 0.0,
        },
        "top": top,
    }


def report_from_bench(doc: dict[str, Any]) -> dict[str, Any]:
    """Bottleneck report from a ``BENCH_serving.json`` document's
    ``attribution.*`` / ``bottleneck.*`` blocks (aggregate only — the
    per-step ranking needs the trace)."""
    attr = doc.get("attribution")
    btl = doc.get("bottleneck")
    if not isinstance(attr, dict) or not isinstance(btl, dict):
        raise ValueError(
            "bench report has no attribution/bottleneck blocks — was the "
            "run served with --attribution?")
    return {
        "source": "bench",
        "steps": attr.get("steps", 0),
        "seconds": attr.get("seconds", {}),
        "labels": btl.get("labels", {}),
        "utilization": btl.get("utilization", {}),
        "optimal_fraction": btl.get("optimal_fraction", {}),
        "top": [],
    }


def format_report(rep: dict[str, Any]) -> str:
    """Human-readable rendering of a bottleneck report (the CLI output)."""
    lines = [f"bottleneck report ({rep['source']}): {rep['steps']} steps"]
    secs = rep.get("seconds", {})
    total = _attributed_total(secs)
    lines.append(f"  attributed seconds: {total:.6f}")
    for comp in COMPONENTS:
        v = secs.get(comp, 0.0)
        if comp == "unattributed":
            # Residual vs the recorded durations (wall clocks) — not a
            # share of the modeled decomposition, so no percentage.
            if v:
                lines.append(f"    {comp:<20s} {v:12.6f}s  (residual)")
            continue
        pct = (100.0 * v / total) if total else 0.0
        lines.append(f"    {comp:<20s} {v:12.6f}s  {pct:5.1f}%")
    labels = rep.get("labels", {})
    counted = {k: v for k, v in labels.items() if v}
    lines.append("  step labels: " + (", ".join(
        f"{k} {v}" for k, v in counted.items()) if counted else "none"))
    util = rep.get("utilization")
    if util:
        lines.append("  utilization: " + ", ".join(
            f"{cat} {util.get(cat, 0.0):.1%}" for cat in CATEGORIES))
    frac = rep.get("optimal_fraction", {})
    if frac:
        lines.append(
            f"  bw optimality: mean {frac.get('mean', 0.0):.3f}  "
            f"max {frac.get('max', 0.0):.3f}  last {frac.get('last', 0.0):.3f}")
    if rep.get("top"):
        lines.append(f"  top {len(rep['top'])} most expensive steps:")
        for s in rep["top"]:
            fr = s.get("optimal_fraction")
            fr_s = f"  bw {fr:.3f}" if fr is not None else ""
            dom_pct = (100.0 * s["dominant_s"] / s["seconds"]
                       if s["seconds"] else 0.0)
            lines.append(
                f"    step[{s['index']:>4d}] {s['seconds']:.6f}s  "
                f"{s['label']:<9s} dominant {s['dominant']} "
                f"({dom_pct:.0f}%){fr_s}")
    return "\n".join(lines)
