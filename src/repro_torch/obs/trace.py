"""Structured span/event tracing — Chrome trace-event JSON the whole
serving stack emits into.

The recorder produces the `Chrome trace-event format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
(load the file in Perfetto / ``chrome://tracing``), organised as:

* an **engine** process — one *step* track carrying the per-step phase
  spans (``admission``, ``prefill[rid]`` chunks, ``decode``, ``migrate``,
  ``replan``) plus instant markers for elastic events, health transitions
  and preemptions;
* a **links** process — counter tracks: per-host-link achieved bytes,
  the AIMD window, queue depth, elastic local deficit, and the numeric
  health state;
* a **requests** process — one track per request id with the lifecycle
  spans (``queued`` submit→admit, ``active`` admit→done) and instant
  markers (``submit``, ``first_token``, ``preempted``);
* a **host phases** process (the port's own) — the engine's `region`
  spans (``dak.step``, ``dak.admit``, ``dak.prefill``, ...) nested on one
  track, on a wall clock only.

Every timestamp comes from the engine's `frontend.metrics.Clock` (wall
or modeled seconds, written as trace microseconds), so a modeled-clock
trace replay produces a timeline in *modeled* time — the bandwidth /
overlap story the paper's figures tell, reconstructable per step.

:data:`NULL_RECORDER` is the engine's default: every emission method is a
no-op and ``enabled`` is False, so the serving path stays bitwise
identical when tracing is off (the parity tests pin this).

**Phase regions.**  `region` is the port's one instrumentation point
inside the engine: a context manager stamped with ``time.time`` (the
`WallClock`'s clock, and the clock torch.profiler stamps its events
with), whose inclusive seconds always go to the engine's `PhaseLedger`.
While a torch profiler records, it also opens a ``record_function`` range
of its name; under an enabled recorder on a wall clock it also emits a
span on the host phases track.  The ledger holds plain numbers only, and
`latest_ledger` reaches the ledger of the engine built or stepped last
without the engine.  ``docs/torch_observability.md`` lists the regions.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any

import torch

TRACE_SCHEMA_VERSION = 1

# Stable process ids for the track groups (Perfetto sorts by pid).
ENGINE, LINKS, REQUESTS, HOST_PHASES = 1, 2, 3, 4
_PROCESS_NAMES = {ENGINE: "engine", LINKS: "links", REQUESTS: "requests",
                  HOST_PHASES: "host phases"}

# Numeric encoding of the health ladder for the counter track.
HEALTH_LEVEL = {"healthy": 0, "recovering": 1, "spilling": 2}


class TraceRecorder:
    """No-op base recorder (and the interface).

    The engine calls these unconditionally-guarded by ``enabled``; the
    base class keeps them safe to call anyway so ad-hoc instrumentation
    never needs a None check.
    """

    enabled = False

    def span(self, pid: int, tid: int, name: str, t0: float, t1: float,
             cat: str = "phase", **args: Any) -> None:
        """Complete span on track (pid, tid): [t0, t1] clock seconds."""

    def instant(self, pid: int, tid: int, name: str, t: float,
                cat: str = "event", **args: Any) -> None:
        """Zero-duration marker at clock second ``t``."""

    def counter(self, pid: int, name: str, t: float,
                values: dict[str, float]) -> None:
        """Counter sample: one track per ``name``, one series per key."""

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        """Label a track (emitted once per (pid, tid))."""

    def save(self, path: str) -> None:
        """Write the trace JSON (no-op on the null recorder)."""


NULL_RECORDER = TraceRecorder()


class ChromeTraceRecorder(TraceRecorder):
    """In-memory trace-event buffer with Chrome/Perfetto JSON output."""

    enabled = True

    def __init__(self, metadata: dict[str, Any] | None = None):
        self.events: list[dict[str, Any]] = []
        self.metadata = dict(metadata or {})
        self._named: set[tuple[int, int]] = set()
        for pid, name in _PROCESS_NAMES.items():
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid, "tid": 0, "args": {"name": name}})

    @staticmethod
    def _us(t: float) -> float:
        return round(t * 1e6, 3)

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) in self._named:
            return
        self._named.add((pid, tid))
        self.events.append({"ph": "M", "name": "thread_name",
                            "pid": pid, "tid": tid, "args": {"name": name}})

    def span(self, pid: int, tid: int, name: str, t0: float, t1: float,
             cat: str = "phase", **args: Any) -> None:
        self.events.append({
            "ph": "X", "name": name, "cat": cat, "pid": pid, "tid": tid,
            "ts": self._us(t0), "dur": max(0.0, self._us(t1) - self._us(t0)),
            "args": args})

    def instant(self, pid: int, tid: int, name: str, t: float,
                cat: str = "event", **args: Any) -> None:
        self.events.append({
            "ph": "i", "name": name, "cat": cat, "pid": pid, "tid": tid,
            "ts": self._us(t), "s": "t", "args": args})

    def counter(self, pid: int, name: str, t: float,
                values: dict[str, float]) -> None:
        self.events.append({
            "ph": "C", "name": name, "cat": "counter", "pid": pid, "tid": 0,
            "ts": self._us(t), "args": {k: float(v) for k, v in values.items()}})

    # -- output ------------------------------------------------------------
    def to_json(self) -> dict[str, Any]:
        return {
            "traceEvents": self.events,
            "displayTimeUnit": "ms",
            "otherData": {"schema_version": TRACE_SCHEMA_VERSION,
                          **self.metadata},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1, default=float)

    def tail(self, n: int) -> list[dict[str, Any]]:
        """The last ``n`` non-metadata events (flight-recorder context)."""
        evs = [e for e in self.events if e["ph"] != "M"]
        return evs[-n:]


# ---------------------------------------------------------------------------
# Phase regions and the engine's phase ledger
# ---------------------------------------------------------------------------
STEP, PREFILL, PROMPT_WRITE, PIN = "dak.step", "dak.prefill", "dak.prompt_write", "dak.pin"
MAX_STEPS = 4096                    # step records a ledger keeps


@dataclasses.dataclass
class PassRecord:
    """One prefill pass (`dak.prefill`).  ``t_submit`` and ``t_prefill`` (the
    start of the request's first pass) are the engine clock's stamps;
    ``t0``/``t1`` and the prompt write's seconds are wall time."""

    rid: int
    t_submit: float
    t_prefill: float
    pos: int                        # prompt tokens done before this pass (0: its first)
    tokens: int
    t0: float
    t1: float
    write_s: float = 0.0            # `dak.prompt_write` inside the pass
    write_local_bytes: int = 0
    write_remote_bytes: int = 0


@dataclasses.dataclass
class StepRecord:
    """One engine step (`dak.step`): its wall span, the inclusive seconds of
    every region inside it by name (``dak.step`` included), and its passes."""

    index: int
    t0: float
    t1: float = 0.0
    seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    passes: list[PassRecord] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BuildRecord:
    """The regions outside every step: the engine's build (`dak.build`) and
    the pinned allocations, zero-fills and copies of the remote tiers in it
    (`dak.pin`, with their bytes)."""

    seconds: dict[str, float] = dataclasses.field(default_factory=dict)
    pin_bytes: int = 0


class PhaseLedger:
    """An engine's phase regions as plain numbers: a ring of the last
    `MAX_STEPS` step records and one build record."""

    def __init__(self):
        self.steps: collections.deque[StepRecord] = collections.deque(maxlen=MAX_STEPS)
        self.build = BuildRecord()
        self.n_steps = 0                # steps begun, those the ring dropped included
        self._step: StepRecord | None = None
        self._write = [0.0, 0, 0]       # the open pass's prompt write: seconds, bytes

    def enter(self, name: str, t0: float) -> None:
        if name == STEP:
            self._step = StepRecord(index=self.n_steps, t0=t0)
            self.n_steps += 1
        elif name == PREFILL:
            self._write = [0.0, 0, 0]

    def exit(self, name: str, t0: float, t1: float, args: dict[str, Any]) -> None:
        rec = self._step if self._step is not None else self.build
        rec.seconds[name] = rec.seconds.get(name, 0.0) + (t1 - t0)
        if name == PROMPT_WRITE:
            self._write[0] += t1 - t0
            self._write[1] += args.get("local_bytes", 0)
            self._write[2] += args.get("remote_bytes", 0)
        elif name == PREFILL and self._step is not None:
            self._step.passes.append(PassRecord(
                args["rid"], args["t_submit"], args["t_prefill"], args["pos"], args["tokens"],
                t0, t1, *self._write))
        elif name == PIN and rec is self.build:
            self.build.pin_bytes += args.get("bytes", 0)
        elif name == STEP and self._step is not None:
            self._step.t1 = t1
            self.steps.append(self._step)
            self._step = None

    def window(self, n: int) -> list[StepRecord] | None:
        """The last ``n`` whole steps, oldest first (None when the ring holds
        fewer)."""
        return list(self.steps)[-n:] if 0 < n <= len(self.steps) else None


_ACTIVE: dict[str, Any] = {"ledger": None, "spans": None, "latest": None}


class recording:
    """``with recording(ledger, recorder):`` regions opened inside record
    into ``ledger`` and, with an enabled ``recorder``, onto its host phases
    track (an engine passes its recorder on a wall clock only: a modeled
    trace's other spans are in modeled seconds).  ``ledger`` becomes
    `latest_ledger`."""

    __slots__ = ("ledger", "spans", "_saved")

    def __init__(self, ledger: PhaseLedger, recorder: TraceRecorder | None = None):
        self.ledger = ledger
        self.spans = recorder if recorder is not None and recorder.enabled else None

    def __enter__(self) -> PhaseLedger:
        self._saved = (_ACTIVE["ledger"], _ACTIVE["spans"])
        _ACTIVE.update(ledger=self.ledger, spans=self.spans, latest=self.ledger)
        return self.ledger

    def __exit__(self, *exc) -> bool:
        _ACTIVE["ledger"], _ACTIVE["spans"] = self._saved
        return False


def latest_ledger() -> PhaseLedger | None:
    """The ledger of the engine built or stepped last in this process."""
    return _ACTIVE["latest"]


class region:
    """A phase region, ``with region("dak.fetch"): ...``.  ``args`` go to
    the ledger and the span, and the body may add to them (``with region(n)
    as r: r.args[k] = v``).  Adds no host sync, device allocation or
    tensor read."""

    __slots__ = ("name", "args", "t0", "t1", "_rf")

    def __init__(self, name: str, **args: Any):
        self.name, self.args = name, args

    def __enter__(self) -> region:
        # the wall stamps enclose the profiler's range, whose own stamps lie
        # within tens of microseconds of them
        self.t0 = time.time()
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.autograd.profiler.record_function(self.name)
            self._rf.__enter__()
        if _ACTIVE["ledger"] is not None:
            _ACTIVE["ledger"].enter(self.name, self.t0)
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        self.t1 = time.time()
        ledger, spans = _ACTIVE["ledger"], _ACTIVE["spans"]
        if ledger is not None:
            ledger.exit(self.name, self.t0, self.t1, self.args)
        if spans is not None:
            spans.span(HOST_PHASES, 0, self.name, self.t0, self.t1, cat="host", **self.args)
        return False


# ---------------------------------------------------------------------------
# Schema validation (the CI obs-smoke gate and `repro_torch.obs validate`)
# ---------------------------------------------------------------------------
_PHASES = {"X", "i", "C", "M"}
_REQUIRED = {"ph", "name", "pid", "tid"}


def validate_trace(doc: dict[str, Any]) -> list[str]:
    """Check a trace document against the schema documented in
    ``docs/observability.md``.  Returns a list of problems (empty = valid).
    """
    errors: list[str] = []
    if not isinstance(doc, dict):
        return ["trace document is not a JSON object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents list"]
    other = doc.get("otherData", {})
    if other.get("schema_version") != TRACE_SCHEMA_VERSION:
        errors.append(f"otherData.schema_version != {TRACE_SCHEMA_VERSION}: "
                      f"{other.get('schema_version')!r}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event[{i}]: not an object")
            continue
        missing = _REQUIRED - ev.keys()
        if missing:
            errors.append(f"event[{i}]: missing keys {sorted(missing)}")
            continue
        ph = ev["ph"]
        if ph not in _PHASES:
            errors.append(f"event[{i}]: unknown phase {ph!r}")
            continue
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            errors.append(f"event[{i}] ({ev['name']}): non-numeric ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            errors.append(f"event[{i}] ({ev['name']}): span without dur")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                errors.append(
                    f"event[{i}] ({ev['name']}): counter args not numeric")
        if ph != "M" and isinstance(ev.get("ts"), (int, float)) and ev["ts"] < 0:
            errors.append(f"event[{i}] ({ev['name']}): negative ts")
    if len(errors) > 50:
        errors = errors[:50] + [f"... {len(errors) - 50} more"]
    return errors


def summarize_trace(doc: dict[str, Any]) -> dict[str, Any]:
    """Aggregate view of a trace document: span/instant/counter counts per
    track, total span time per phase name, counter last-values."""
    events = doc.get("traceEvents", [])
    names: dict[tuple[int, int], str] = {}
    procs: dict[int, str] = {}
    spans: dict[str, dict[str, float]] = {}
    instants: dict[str, int] = {}
    counters: dict[str, dict[str, float]] = {}
    t_min, t_max = float("inf"), float("-inf")
    for ev in events:
        ph = ev.get("ph")
        if ph == "M":
            if ev.get("name") == "process_name":
                procs[ev["pid"]] = ev["args"]["name"]
            elif ev.get("name") == "thread_name":
                names[(ev["pid"], ev["tid"])] = ev["args"]["name"]
            continue
        ts = float(ev.get("ts", 0.0))
        t_min, t_max = min(t_min, ts), max(t_max, ts)
        if ph == "X":
            rec = spans.setdefault(ev["name"], {"count": 0, "total_us": 0.0})
            rec["count"] += 1
            rec["total_us"] += float(ev.get("dur", 0.0))
            t_max = max(t_max, ts + float(ev.get("dur", 0.0)))
        elif ph == "i":
            instants[ev["name"]] = instants.get(ev["name"], 0) + 1
        elif ph == "C":
            counters[ev["name"]] = dict(ev.get("args", {}))
    # Per-phase totals ("where did the time go" without loading Perfetto):
    # prefill chunks trace as `prefill[rid]` spans, decode and admission
    # as one span each per step.
    phase_us = {
        "prefill": sum(rec["total_us"] for name, rec in spans.items()
                       if name.startswith("prefill[")),
        "decode": spans.get("decode", {}).get("total_us", 0.0),
        "admission": spans.get("admission", {}).get("total_us", 0.0),
    }
    phase_total = sum(phase_us.values())
    phases = {
        name: {"seconds": us / 1e6,
               "pct": (100.0 * us / phase_total) if phase_total else 0.0}
        for name, us in phase_us.items()
    }
    return {
        "schema_version": doc.get("otherData", {}).get("schema_version"),
        "events": sum(1 for e in events if e.get("ph") != "M"),
        "processes": procs,
        "tracks": {f"{pid}/{tid}": n for (pid, tid), n in sorted(names.items())},
        "span_us": (t_max - t_min) if t_max >= t_min else 0.0,
        "spans": spans,
        "phases": phases,
        "instants": instants,
        "counters_final": counters,
    }
