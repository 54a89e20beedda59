"""Flight recorder — bounded ring of engine-state snapshots, dumped as a
post-mortem bundle when something goes wrong.

The serving engine appends one :func:`ServingEngine._flight_snapshot`
summary per step (page-table occupancy per tier, elastic limit/deficit,
congestion windows, queue depth, health state) into a bounded ring; on an
``InvariantViolation``, an uncaught exception in the run loop, or a TTFT
SLO breach past ``slo_breach_s``, the engine dumps the ring — plus a
final snapshot taken *at the failure*, the tail of the trace-event
buffer, and a metrics snapshot — as one JSON bundle.  ``python -m
repro_torch.obs summarize BUNDLE`` renders it; ``convert`` extracts the trace
tail into a Perfetto-loadable file.

Recording is read-only host bookkeeping (dict/ numpy scalars only), so an
attached flight recorder never changes tokens or stats; detached (the
default) the engine skips every call site.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any

BUNDLE_SCHEMA_VERSION = 1


class FlightRecorder:
    """Last-N-steps engine state ring + post-mortem bundle writer."""

    def __init__(self, out_dir: str, *, capacity: int = 64,
                 slo_breach_s: float | None = None, trace_tail: int = 200):
        if capacity < 1:
            raise ValueError("flight ring capacity must be >= 1")
        self.out_dir = out_dir
        self.ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self.slo_breach_s = slo_breach_s
        self.trace_tail = trace_tail
        self.dumped: list[str] = []        # bundle paths written this run

    def record(self, snapshot: dict[str, Any]) -> None:
        self.ring.append(snapshot)

    def breached(self, ttft_s: float) -> bool:
        """Is this TTFT past the configured SLO-breach dump threshold?"""
        return self.slo_breach_s is not None and ttft_s > self.slo_breach_s

    def dump(self, reason: str, *, error: str | None = None,
             final_snapshot: dict[str, Any] | None = None,
             recorder=None, registry=None) -> str:
        """Write one post-mortem bundle; returns its path.

        ``final_snapshot`` is the engine state *at the failure* (appended
        after the per-step ring so the bundle's last snapshot is the
        violating step even when the step aborted before its end-of-step
        record).  ``recorder`` / ``registry`` contribute the trace tail
        and a metrics snapshot when attached.
        """
        snaps = list(self.ring)
        if final_snapshot is not None:
            snaps.append(final_snapshot)
        bundle: dict[str, Any] = {
            "bundle_schema_version": BUNDLE_SCHEMA_VERSION,
            "reason": reason,
            "error": error,
            "steps": [s.get("step") for s in snaps],
            "snapshots": snaps,
        }
        if recorder is not None and getattr(recorder, "enabled", False):
            bundle["trace_tail"] = recorder.tail(self.trace_tail)
        if registry is not None:
            bundle["metrics"] = registry.nested()
        os.makedirs(self.out_dir, exist_ok=True)
        step = snaps[-1].get("step", "na") if snaps else "na"
        path = os.path.join(
            self.out_dir, f"flight_{reason}_step{step}.json")
        with open(path, "w") as fh:
            json.dump(bundle, fh, indent=1, default=_jsonable)
        self.dumped.append(path)
        return path


def _jsonable(obj: Any) -> Any:
    """Best-effort serialization for numpy scalars/arrays in snapshots."""
    if hasattr(obj, "item"):
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


def load_bundle(path: str) -> dict[str, Any]:
    with open(path) as fh:
        bundle = json.load(fh)
    if bundle.get("bundle_schema_version") != BUNDLE_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: not a flight bundle (bundle_schema_version="
            f"{bundle.get('bundle_schema_version')!r})")
    return bundle


def summarize_bundle(bundle: dict[str, Any]) -> dict[str, Any]:
    """Condensed view of a bundle: failure reason, step span, the last
    snapshot, and counts of what context travelled along."""
    snaps = bundle.get("snapshots", [])
    return {
        "reason": bundle.get("reason"),
        "error": bundle.get("error"),
        "snapshots": len(snaps),
        "first_step": snaps[0].get("step") if snaps else None,
        "last_step": snaps[-1].get("step") if snaps else None,
        "last_snapshot": snaps[-1] if snaps else None,
        "trace_tail_events": len(bundle.get("trace_tail", [])),
        "has_metrics": "metrics" in bundle,
    }
