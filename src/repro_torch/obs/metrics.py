"""Unified metrics registry — one place every subsystem's counters live.

Before this module, `EngineStats` (serving), `ElasticCounters` (health),
the `Telemetry` EMAs (runtime) and the frontend's request records each
kept parallel fields and `launch.serve.bench_report` hand-assembled them
into ``BENCH_serving.json``.  Now each component *registers* its metrics
into a :class:`MetricsRegistry` (``register_metrics`` methods on
`EngineStats`, `HealthMonitor`, `Telemetry`, `RuntimeController`, and the
scheduler), and the registry is the single producer of

* the **BENCH stats block** — :func:`serving_registry` +
  :meth:`MetricsRegistry.nested` reproduce the pre-registry
  ``BENCH_serving.json`` fields byte-for-byte (pinned by test), so the
  bench regression gate (`benchmarks/compare.py`) diffs one schema;
* the **Prometheus text exposition** (``--metrics-out``) — counters,
  gauges and summary-style histograms with sanitized ``dak_``-prefixed
  names, ready for a scrape endpoint.

Metric names are JSON paths (``"kv.spills"``); :meth:`nested` unflattens
them in registration order, which is what keeps the emitted block
byte-identical to the old hand-built dict.  Metrics registered with
``in_json=False`` (per-phase histograms, scheduler queue counters) appear
only in the Prometheus view, so the JSON schema never grows by accident.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Iterable

# BENCH_serving.json schema version (the provenance stamp compare.py
# refuses to cross).  1 = the pre-provenance implicit schema; 2 adds
# schema_version + provenance.
BENCH_SCHEMA_VERSION = 2


class Metric:
    """Base metric: a named value with Prometheus-kind metadata."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", in_json: bool = True):
        self.name = name
        self.help = help
        self.in_json = in_json

    def value(self) -> Any:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name: str, help: str = "", in_json: bool = True):
        super().__init__(name, help, in_json)
        self._value: int | float = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self._value += n

    def set_total(self, total: int | float) -> None:
        """Adopt an externally-accumulated total (component counters that
        predate the registry keep their own field; registration syncs)."""
        self._value = total

    def value(self) -> int | float:
        return self._value


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name: str, help: str = "", in_json: bool = True,
                 fn: Callable[[], Any] | None = None):
        super().__init__(name, help, in_json)
        self._value: Any = 0
        self._fn = fn

    def set(self, v: Any) -> None:
        self._value = v

    def value(self) -> Any:
        return self._fn() if self._fn is not None else self._value


class Histogram(Metric):
    """Sample distribution; exposed as a Prometheus summary (quantiles)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", in_json: bool = False,
                 quantiles: tuple[float, ...] = (0.5, 0.95, 0.99)):
        super().__init__(name, help, in_json)
        self.quantiles = quantiles
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(float(v))

    def extend(self, vs: Iterable[float]) -> None:
        self.samples.extend(float(v) for v in vs)

    def value(self) -> dict[str, float]:
        from repro_torch.frontend.metrics import percentile

        out = {f"p{int(q * 100)}": percentile(self.samples, q * 100)
               for q in self.quantiles}
        out["count"] = len(self.samples)
        out["sum"] = sum(self.samples)
        return out


class Const(Metric):
    """A fixed JSON value (strings, bools, lists, nested report dicts)."""

    kind = "const"

    def __init__(self, name: str, value: Any, help: str = "",
                 in_json: bool = True):
        super().__init__(name, help, in_json)
        self._value = value

    def value(self) -> Any:
        return self._value


class MetricsRegistry:
    """Ordered name → metric map with JSON and Prometheus writers."""

    def __init__(self, namespace: str = "dak"):
        self.namespace = namespace
        self._metrics: dict[str, Metric] = {}

    # -- registration ------------------------------------------------------
    def register(self, metric: Metric) -> Metric:
        if metric.name in self._metrics:
            raise ValueError(f"metric {metric.name!r} already registered")
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "", *,
                in_json: bool = True) -> Counter:
        return self.register(Counter(name, help, in_json))  # type: ignore[return-value]

    def gauge(self, name: str, help: str = "", *, fn=None,
              in_json: bool = True) -> Gauge:
        return self.register(Gauge(name, help, in_json, fn=fn))  # type: ignore[return-value]

    def histogram(self, name: str, help: str = "", *,
                  in_json: bool = False) -> Histogram:
        return self.register(Histogram(name, help, in_json))  # type: ignore[return-value]

    def const(self, name: str, value: Any, help: str = "", *,
              in_json: bool = True) -> Const:
        return self.register(Const(name, value, help, in_json))  # type: ignore[return-value]

    # -- access ------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str) -> Metric:
        return self._metrics[name]

    def value(self, name: str) -> Any:
        return self._metrics[name].value()

    def metrics(self) -> list[Metric]:
        return list(self._metrics.values())

    # -- JSON view ---------------------------------------------------------
    def nested(self) -> dict[str, Any]:
        """Unflatten dotted metric names into the report dict, preserving
        registration order (this is the BENCH_serving.json stats block)."""
        out: dict[str, Any] = {}
        for m in self._metrics.values():
            if not m.in_json:
                continue
            parts = m.name.split(".")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
                if not isinstance(node, dict):
                    raise ValueError(
                        f"metric {m.name!r} nests under non-dict {p!r}")
            if parts[-1] in node:
                raise ValueError(f"metric {m.name!r} collides in JSON view")
            node[parts[-1]] = m.value()
        return out

    # -- Prometheus view ---------------------------------------------------
    @staticmethod
    def _sanitize(name: str) -> str:
        return re.sub(r"[^a-zA-Z0-9_]", "_", name)

    @staticmethod
    def _fmt(v: Any) -> str:
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, int):
            return str(v)
        return repr(float(v))

    def _prom_lines(self, name: str, kind: str, help: str,
                    value: Any) -> list[str]:
        full = f"{self.namespace}_{self._sanitize(name)}"
        lines = []
        if help:
            lines.append(f"# HELP {full} {help}")
        lines.append(f"# TYPE {full} {kind}")
        lines.append(f"{full} {self._fmt(value)}")
        return lines

    def to_prometheus(self) -> str:
        """Prometheus text exposition (numeric metrics; nested consts are
        flattened to their numeric leaves, strings/lists skipped)."""
        lines: list[str] = []
        for m in self._metrics.values():
            v = m.value()
            if isinstance(m, Histogram):
                full = f"{self.namespace}_{self._sanitize(m.name)}"
                if m.help:
                    lines.append(f"# HELP {full} {m.help}")
                lines.append(f"# TYPE {full} summary")
                from repro_torch.frontend.metrics import percentile

                for q in m.quantiles:
                    lines.append(f'{full}{{quantile="{q}"}} '
                                 f"{self._fmt(percentile(m.samples, q * 100))}")
                lines.append(f"{full}_sum {self._fmt(sum(m.samples))}")
                lines.append(f"{full}_count {len(m.samples)}")
                continue
            if isinstance(v, dict):
                for path, leaf in _numeric_leaves(m.name, v):
                    lines.extend(self._prom_lines(path, "gauge", "", leaf))
                continue
            if isinstance(v, bool) or isinstance(v, (int, float)):
                kind = m.kind if m.kind in ("counter", "gauge") else "gauge"
                lines.extend(self._prom_lines(m.name, kind, m.help, v))
        return "\n".join(lines) + "\n"


def _numeric_leaves(prefix: str, d: dict) -> list[tuple[str, float]]:
    out: list[tuple[str, float]] = []
    for k, v in d.items():
        path = f"{prefix}.{k}"
        if isinstance(v, dict):
            out.extend(_numeric_leaves(path, v))
        elif isinstance(v, bool) or isinstance(v, (int, float)):
            out.append((path, v))
    return out


# ---------------------------------------------------------------------------
# The serving report producer
# ---------------------------------------------------------------------------
def serving_registry(engine, stats, wall: float, *,
                     meta: dict[str, Any]) -> MetricsRegistry:
    """Build the registry behind one serving run's report.

    ``meta`` carries the serve command's fields the engine does not know
    (arch name, smoke flag, request count, trace name).  Registration
    order is load-bearing: :meth:`MetricsRegistry.nested` must reproduce
    the pre-registry ``bench_report`` dict byte-for-byte.
    """
    reg = MetricsRegistry()
    reg.const("arch", meta.get("arch"))
    reg.const("smoke", bool(meta.get("smoke")))
    reg.const("adaptive", bool(meta.get("adaptive")))
    reg.const("scheduler", engine.scheduler.name)
    reg.const("prefill_chunk", engine.scheduler.chunk_tokens)
    reg.const("trace", meta.get("trace"))
    reg.const("mesh_shape", engine.mesh_shape)
    reg.const("requests", meta.get("requests"))
    stats.register_metrics(reg, global_ratio=engine.plan.global_ratio,
                           wall_s=wall)
    engine.health.register_metrics(reg, prefix="elastic")
    reg.gauge("window.static", "plan-time in-flight DMA window").set(
        engine.plan.window.n_inflight)
    reg.gauge("window.final", "window after the run").set(stats.final_window)
    if engine.clock.kind == "modeled":
        mk = engine.clock.now()
        reg.gauge("modeled.makespan_s", "modeled-clock run length").set(mk)
        reg.gauge("modeled.tokens_per_modeled_s").set(
            stats.generated_tokens / mk if mk else 0.0)
    if engine.mesh is not None:
        reg.const("mesh_traffic", engine.mesh_traffic_report())
    if engine.runtime is not None:
        engine.runtime.register_metrics(reg, prefix="runtime")
    # Compiled decode step: bucket compilations vs cache hits (a recompile
    # storm shows as count ~ steps; healthy steady state is count = #buckets
    # with every step a hit), plus the autotuner's sweep/hit counters.
    reg.const("compile.jit", bool(getattr(engine, "_jit", False)),
              "decode step runs as one jitted, pool-donating call")
    reg.counter("compile.count",
                "fresh decode-step compilations (one per (kind, "
                "window-bucket, pool-shape) bucket)").set_total(
        int(getattr(engine, "compile_count", 0)))
    reg.counter("compile.cache_hits",
                "decode steps served by an already-compiled bucket"
                ).set_total(int(getattr(engine, "compile_cache_hits", 0)))
    if getattr(engine, "tuner", None) is not None:
        reg.const("autotune", engine.tuner.counters(),
                  "autotuner table size + hit/miss/sweep counters")
    # Attribution / bottleneck blocks: only when a profiler was attached,
    # so profiler-off reports keep the exact pre-attribution schema
    # (byte-identical JSON — same contract as the recorder).
    prof = getattr(engine, "profiler", None)
    if prof is not None and prof.enabled:
        prof.register_metrics(reg)
    # Prometheus-only extras: latency distributions + scheduler queue flow
    # (in_json=False so the JSON schema stays frozen).
    reg.histogram("ttft_seconds", "time to first token").extend(stats.ttfts)
    reg.histogram("queue_delay_seconds",
                  "submit to first prefill chunk").extend(stats.queue_delays)
    reg.histogram("e2e_seconds", "request end-to-end latency").extend(
        stats.e2e_latencies)
    engine.scheduler.register_metrics(reg)
    return reg


def provenance(engine, *, arch: str, extra: dict[str, Any] | None = None
               ) -> dict[str, Any]:
    """The BENCH provenance stamp: enough identity for
    `benchmarks/compare.py` to refuse nonsense comparisons (cross-schema,
    cross-config, cross-clock).  The port stamps its backend as
    ``torch`` where the reference stamps ``jax``."""
    import torch

    return {
        "git_rev": git_revision(),
        "arch": arch,
        "config": type(engine.cfg).__name__,
        "clock": engine.clock.kind,
        "scheduler": engine.scheduler.name,
        "mesh_shape": engine.mesh_shape,
        "jit": bool(getattr(engine, "_jit", False)),
        "torch": torch.__version__,
        **(extra or {}),
    }


def git_revision() -> str:
    """Current git revision (``unknown`` outside a checkout)."""
    import os
    import subprocess

    try:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=root,
            capture_output=True, text=True, timeout=10, check=False)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
