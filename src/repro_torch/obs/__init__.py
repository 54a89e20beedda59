"""End-to-end observability for the DAK serving stack.

* :mod:`repro_torch.obs.trace` — Chrome trace-event (Perfetto-loadable) span /
  counter recorder the engine's step loop emits into;
* :mod:`repro_torch.obs.metrics` — the unified metrics registry (counters /
  gauges / histograms, Prometheus text + JSON snapshot) that produces
  ``BENCH_serving.json``'s stats block;
* :mod:`repro_torch.obs.flight` — flight recorder: last-N-steps state ring
  dumped as a post-mortem bundle on invariant violations, crashes, or
  SLO breaches;
* :mod:`repro_torch.obs.attribution` / :mod:`repro_torch.obs.bottleneck` — per-step
  time/byte ledger over the modeled cost decomposition, bottleneck
  labels, and the achieved-vs-optimal aggregate-bandwidth audit;
* ``python -m repro_torch.obs`` — summarize / validate / convert / bottleneck
  tooling.
"""
from repro_torch.obs.attribution import (
    COMPONENTS,
    NULL_PROFILER,
    AttributionProfiler,
    StepLedger,
)
from repro_torch.obs.bottleneck import (
    BottleneckAuditor,
    label_components,
    optimality_fraction,
    report_from_bench,
    report_from_trace,
)
from repro_torch.obs.flight import FlightRecorder, load_bundle, summarize_bundle
from repro_torch.obs.metrics import (
    BENCH_SCHEMA_VERSION,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    provenance,
    serving_registry,
)
from repro_torch.obs.trace import (
    NULL_RECORDER,
    ChromeTraceRecorder,
    TraceRecorder,
    summarize_trace,
    validate_trace,
)

__all__ = [
    "BENCH_SCHEMA_VERSION",
    "COMPONENTS",
    "AttributionProfiler",
    "BottleneckAuditor",
    "ChromeTraceRecorder",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_PROFILER",
    "NULL_RECORDER",
    "StepLedger",
    "TraceRecorder",
    "label_components",
    "load_bundle",
    "optimality_fraction",
    "provenance",
    "report_from_bench",
    "report_from_trace",
    "serving_registry",
    "summarize_bundle",
    "summarize_trace",
    "validate_trace",
]
