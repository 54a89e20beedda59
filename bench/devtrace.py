"""The measured window as a torch.profiler trace sees it: the device's busy
time, its time by kernel, and its idle time by what the host was doing.

The busy arithmetic (the union of the device's intervals) is copied from
``chip_smoke.py`` (`trace_device`).  The window is the CPU range named
`WINDOW`; the benchmark's own calls are the ranges in `HOST_RANGES`, which
label each idle gap together with the innermost host operation over it.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import NamedTuple

WINDOW = "bench.window"
HOST_RANGES = ("engine.step", "bench.submit", "bench.bookkeeping")
SHORT_GAP_US = 10.0          # idle gaps shorter than this are not labelled one by one
_WALK_BACK = 4000            # host events searched back for one that spans a gap
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    window_s: float                      # length of the window on the trace's clock
    busy_s: float                        # union of the device's intervals inside it
    kernels: dict[str, float]            # device seconds by operation name
    idle: dict[str, float]               # idle seconds by host activity
    device_ops: int                      # device operations in the window


class Event(NamedTuple):
    name: str
    start: float                         # us
    end: float
    on_device: bool
    annotation: bool                     # a range annotation, not an operation


def events_of(prof) -> list[Event]:
    """A profiler's events from its raw kineto results: torch's own
    ``events()`` builds a tree of Python objects, about a minute for the
    ~10^6 events of a 46 s window, the raw list a second."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [Event(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3, e.device_type() == cuda,
                  e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _union(spans: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """Busy time of sorted intervals, and the idle gaps between them."""
    busy, end, gaps = 0.0, None, []
    for a, b in spans:
        if end is None:
            busy, end = b - a, b
            continue
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, gaps


def reduce(events: list[Event]) -> Trace | None:
    """None when the events hold no window or the device recorded no time
    (the profiler saw no device)."""
    windows = [e for e in events if e.name == WINDOW and not e.on_device]
    if not windows:
        return None
    w0, w1 = windows[0].start, windows[0].end
    spans, kernels = [], defaultdict(float)
    host, marks = [], []
    for e in events:
        a, b = max(e.start, w0), min(e.end, w1)
        if e.on_device and not e.annotation and e.name not in HOST_RANGES and e.name != WINDOW:
            if b > a:
                spans.append((a, b))
                kernels[e.name[:NAME_CHARS]] += (b - a) / 1e6
        elif e.on_device or e.name == WINDOW or b <= a:
            continue
        elif e.name in HOST_RANGES:
            marks.append((e.start, e.end, e.name))
        else:
            host.append((e.start, e.end, e.name))
    spans.sort()
    busy, gaps = _union(spans)
    if busy <= 0:
        return None
    if spans:
        gaps = [(w0, spans[0][0])] + gaps + [(max(b for _, b in spans), w1)]
    host.sort()
    marks.sort()
    starts, mark_starts = [h[0] for h in host], [m[0] for m in marks]
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        if b - a < SHORT_GAP_US:
            idle[f"gaps under {SHORT_GAP_US:g} us"] += (b - a) / 1e6
            continue
        mid = (a + b) / 2
        idle[_label(mid, host, starts, marks, mark_starts)] += (b - a) / 1e6
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, kernels=dict(kernels),
                 idle=dict(idle), device_ops=len(spans))


def _innermost(mid: float, spans: list, starts: list[float], walk: int) -> str | None:
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(-1, i - walk), -1):
        if spans[j][1] >= mid:
            return spans[j][2]
    return None


def _label(mid: float, host: list, starts: list, marks: list, mark_starts: list) -> str:
    outer = _innermost(mid, marks, mark_starts, len(marks)) or "outside the benchmark's calls"
    inner = _innermost(mid, host, starts, _WALK_BACK)
    return f"{outer} > {inner}"[:NAME_CHARS] if inner else outer


def top(d: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def seconds_of(kernels: dict[str, float], *needles: str) -> float:
    """Device seconds of the operations whose name holds any of `needles`."""
    return sum(s for name, s in kernels.items() if any(n in name for n in needles))
