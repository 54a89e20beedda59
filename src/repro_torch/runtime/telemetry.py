"""Per-step serving telemetry — the adaptive runtime's measurement plane.

Counterpart of ``src/repro/runtime/telemetry.py``, copied from it but for
the tree walks and one port-only source:

* :class:`Telemetry` — a ring buffer of :class:`StepSample` records (bytes
  moved per tier, step duration, queue depth, prefill/decode token mix,
  in-flight window) with EMA aggregates.  The re-planner and the serving
  report read from here, and :class:`TelemetrySource` adapts the achieved
  EMAs into the controller's `MeasurementSource` protocol.
* :class:`CudaEventSource` — the achieved bandwidth of each decode step,
  timed on the card by CUDA events; what ``RuntimeController(source=...)``
  takes to close the AIMD loop over the measured host link.  The engine's
  default source stays the analytical model, as in the reference.
* :class:`PageTouchHistogram` — decayed touch counts per (tier, pool page)
  of the paged KV cache, the single source of truth for page temperature
  (`serving.paged_cache.PagedTieredCache` records a touch on every page it
  writes or attends and asks the histogram for its spill victim;
  `runtime.migration` asks it for promotion/demotion candidates).
* :func:`weight_tier_bytes` and :func:`weight_link_bytes` — the bytes one
  full read of a params tree takes from each tier and over each host link,
  walking torch trees.

No serving imports, so it sits below both `serving.paged_cache` and the
rest of `repro_torch.runtime`.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Iterable, Iterator

import torch

from repro_torch.core.congestion import BandwidthSample, MeasurementSource
from repro_torch.core.tiering import TieredTensor, traffic_bytes


@dataclasses.dataclass(frozen=True)
class StepSample:
    """Counters for one engine step (prefill admissions + one decode)."""

    step: int
    duration_s: float                  # engine-clock time of the step (wall
    #                                    seconds on WallClock, modeled seconds
    #                                    on ModeledClock replays — one time
    #                                    base per run, never mixed)
    prefill_tokens: int                # prompt tokens prefetched this step
    decode_tokens: int                 # one per active slot
    queue_depth: int                   # requests still waiting after admission
    active_slots: int
    mean_kv_len: float                 # mean kv length over active slots
    local_bytes: float                 # bytes streamed from the HBM tier
    remote_bytes: float                # bytes crossing host links (all links)
    window: int                        # in-flight DMA window used this step
    remote_bytes_per_link: tuple[float, ...] | None = None
    # per-host-link breakdown of remote_bytes under a serving mesh (one
    # entry per chip's link, summing to remote_bytes); None = single link
    health: str = "healthy"            # engine health state this step
    local_deficit: int = 0             # pages over the elastic local limit

    @property
    def tokens(self) -> int:
        return self.prefill_tokens + self.decode_tokens

    @property
    def prefill_fraction(self) -> float:
        return self.prefill_tokens / self.tokens if self.tokens else 0.0

    @property
    def link_bytes(self) -> tuple[float, ...]:
        """remote_bytes resolved per link (single-link when no breakdown)."""
        if self.remote_bytes_per_link is not None:
            return self.remote_bytes_per_link
        return (self.remote_bytes,)

    @property
    def achieved_aggregate_bw(self) -> float:
        """Achieved aggregate bandwidth of this step (both tiers), B/s —
        the numerator of the bottleneck auditor's optimality fraction
        (`obs.bottleneck`, vs `core.congestion.optimal_window`)."""
        return (self.local_bytes + self.remote_bytes) / max(self.duration_s,
                                                            1e-12)


def _ema(prev: float | None, value: float, alpha: float) -> float:
    return value if prev is None else alpha * value + (1.0 - alpha) * prev


class Telemetry:
    """Ring buffer of step samples + EMA aggregates.

    ``predicted_local_bw`` / ``predicted_remote_bw`` carry the planner's
    model-predicted bandwidths so reports can show achieved vs predicted
    side by side; they are set once from the `TieringPlan` and never
    updated by samples.
    """

    def __init__(self, capacity: int = 64, ema_alpha: float = 0.25,
                 predicted_local_bw: float = 0.0,
                 predicted_remote_bw: float = 0.0):
        if capacity <= 0:
            raise ValueError("telemetry ring capacity must be positive")
        self.ring: deque[StepSample] = deque(maxlen=capacity)
        self.alpha = ema_alpha
        self.predicted_local_bw = predicted_local_bw
        self.predicted_remote_bw = predicted_remote_bw
        self.total_steps = 0
        self.total_prefill_tokens = 0
        self.total_decode_tokens = 0
        self.degraded_steps = 0        # steps sampled while not healthy
        self.total_local_bytes = 0.0
        self.total_remote_bytes = 0.0
        self._ema_local_bw: float | None = None
        self._ema_remote_bw: float | None = None
        self._ema_link_bw: list[float | None] = []   # per host link (mesh)
        self._ema_mix: float | None = None
        self._ema_queue: float | None = None
        self._ema_kv_len: float | None = None
        self._ema_batch: float | None = None

    def record(self, sample: StepSample) -> None:
        self.ring.append(sample)
        self.total_steps += 1
        self.total_prefill_tokens += sample.prefill_tokens
        self.total_decode_tokens += sample.decode_tokens
        self.total_local_bytes += sample.local_bytes
        self.total_remote_bytes += sample.remote_bytes
        if sample.health != "healthy":
            self.degraded_steps += 1
        dt = max(sample.duration_s, 1e-12)
        self._ema_local_bw = _ema(self._ema_local_bw, sample.local_bytes / dt, self.alpha)
        self._ema_remote_bw = _ema(self._ema_remote_bw, sample.remote_bytes / dt, self.alpha)
        links = sample.link_bytes
        if len(self._ema_link_bw) < len(links):
            self._ema_link_bw += [None] * (len(links) - len(self._ema_link_bw))
        for i, b in enumerate(links):
            self._ema_link_bw[i] = _ema(self._ema_link_bw[i], b / dt, self.alpha)
        self._ema_mix = _ema(self._ema_mix, sample.prefill_fraction, self.alpha)
        self._ema_queue = _ema(self._ema_queue, float(sample.queue_depth), self.alpha)
        self._ema_kv_len = _ema(self._ema_kv_len, sample.mean_kv_len, self.alpha)
        self._ema_batch = _ema(self._ema_batch, float(sample.active_slots), self.alpha)

    # -- EMA aggregates ----------------------------------------------------
    @property
    def achieved_local_bw(self) -> float:
        return self._ema_local_bw or 0.0

    @property
    def achieved_remote_bw(self) -> float:
        return self._ema_remote_bw or 0.0

    @property
    def achieved_link_bw(self) -> list[float]:
        """Per-host-link achieved-bandwidth EMAs (one entry per mesh link;
        a single entry — equal to ``achieved_remote_bw`` — off-mesh)."""
        return [b or 0.0 for b in self._ema_link_bw]

    @property
    def prefill_fraction(self) -> float:
        """EMA of the per-step prefill token share (the workload mix)."""
        return self._ema_mix or 0.0

    @property
    def queue_depth(self) -> float:
        return self._ema_queue or 0.0

    @property
    def mean_kv_len(self) -> float:
        return self._ema_kv_len or 0.0

    @property
    def mean_batch(self) -> float:
        return self._ema_batch or 0.0

    def window_trace(self) -> list[int]:
        return [s.window for s in self.ring]

    def report(self) -> dict:
        """Machine-readable snapshot (BENCH_serving.json 'telemetry' key)."""
        return {
            "steps": self.total_steps,
            "degraded_steps": self.degraded_steps,
            "prefill_tokens": self.total_prefill_tokens,
            "decode_tokens": self.total_decode_tokens,
            "prefill_fraction_ema": self.prefill_fraction,
            "queue_depth_ema": self.queue_depth,
            "bandwidth": {
                "local": {"achieved": self.achieved_local_bw,
                          "predicted": self.predicted_local_bw},
                "remote": {"achieved": self.achieved_remote_bw,
                           "predicted": self.predicted_remote_bw},
                "per_link": self.achieved_link_bw,
            },
            "bytes": {"local": self.total_local_bytes,
                      "remote": self.total_remote_bytes},
        }


class TelemetrySource:
    """The telemetry EMAs as a `congestion.MeasurementSource`.

    On hardware this closes the controller's loop over *observed*
    bandwidth: ``measure`` reports the ring buffer's achieved per-tier
    EMAs (the ``window`` argument is ignored — the samples were taken at
    whatever window the engine actually ran).  The serving engine's
    default remains the analytical `congestion.ModelSource` because this
    reproduction's CPU-interpret wall-clock is noise, but the adapter is
    what a TPU deployment plugs into ``RuntimeController(source=...)``.
    """

    def __init__(self, telemetry: Telemetry):
        self.telemetry = telemetry

    def measure(self, window: int):
        return BandwidthSample(host_bw=self.telemetry.achieved_remote_bw,
                               hbm_bw=self.telemetry.achieved_local_bw)

    def measure_link(self, link: int, window: int):
        """Per-host-link observation for the mesh's per-link AIMD loops:
        link `link`'s achieved-bandwidth EMA, not the all-links sum —
        ``measure()`` reports the aggregate, which against a single link's
        ``host_bw_limit`` would read permanently saturated.  Falls back to
        the aggregate while no per-link samples have arrived."""
        per_link = self.telemetry.achieved_link_bw
        host = (per_link[link] if link < len(per_link)
                else self.telemetry.achieved_remote_bw)
        return BandwidthSample(host_bw=host,
                               hbm_bw=self.telemetry.achieved_local_bw)


class CudaEventSource:
    """Achieved per-tier bandwidth of each decode step, timed on the card by
    CUDA events: the port's counterpart of :class:`TelemetrySource`, for
    ``RuntimeController(source=...)``.

    The serving engine records :meth:`begin` and :meth:`end` on the current
    stream around a decode step's launches and, once the step's sampled
    tokens have reached the host (which already waits for the step, so the
    timing adds no synchronisation), calls :meth:`observe` with the bytes
    that step read from each tier: one read of the tiered weights plus the
    KV pages it attended, the accounting of the engine's telemetry samples.
    :meth:`measure` answers with the newest observation (the ``window``
    argument is ignored: the sample was taken at whatever window the step
    ran; a step that launched no decode repeats it).  Until the first
    decode step has been timed it answers with ``prior``.  There is no
    wall-clock fallback: on any device but a CUDA one it raises."""

    def __init__(self, prior: MeasurementSource, device: Any = "cuda"):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CudaEventSource times decode steps on a CUDA device, not {device}")
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available to time decode steps on")
        self.prior = prior
        self.device = device
        self.last: BandwidthSample | None = None   # the newest timed step's bandwidth,
        self.last_seconds = 0.0                     # its device time
        self.last_bytes = (0.0, 0.0)                # and its (local, remote) bytes
        self.timed_steps = 0
        self.prior_answers = 0                      # measurements answered by `prior`
        self._start: torch.cuda.Event | None = None
        self._stop: torch.cuda.Event | None = None

    def _record(self) -> torch.cuda.Event:
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def begin(self) -> None:
        """Mark the start of a decode step's launches."""
        self._start, self._stop = self._record(), None

    def end(self) -> None:
        """Mark the end of a decode step's launches."""
        if self._start is None:
            raise RuntimeError("CudaEventSource.end() without begin()")
        self._stop = self._record()

    def observe(self, local_bytes: float, remote_bytes: float) -> BandwidthSample:
        """The bracketed step's bandwidth: its bytes from each tier over its
        device time.  Call after the host has waited for the step."""
        if self._start is None or self._stop is None:
            raise RuntimeError("CudaEventSource.observe() needs a step bracketed by "
                               "begin() and end()")
        self.last_seconds = self._start.elapsed_time(self._stop) * 1e-3
        self.last_bytes = (local_bytes, remote_bytes)
        self._start = self._stop = None
        dt = max(self.last_seconds, 1e-12)
        self.last = BandwidthSample(host_bw=remote_bytes / dt, hbm_bw=local_bytes / dt)
        self.timed_steps += 1
        return self.last

    def measure(self, window: int) -> BandwidthSample:
        if self.last is None:
            self.prior_answers += 1
            return self.prior.measure(window)
        return self.last


class PageTouchHistogram:
    """Decayed touch counts per (tier, pool index) KV page.

    ``touch`` adds ``weight`` heat to a page and stamps it with a global
    monotone counter; ``advance`` (once per engine step) decays every
    page's heat by ``decay``.  Temperature ordering is ``(heat, stamp)``:
    colder = less accumulated recent heat, ties broken by least-recent
    touch — which reproduces the old allocation-stamp behaviour (oldest
    page spills first) when all pages are touched equally.
    """

    def __init__(self, decay: float = 0.85):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = decay
        self._heat: dict[tuple[int, int], float] = {}
        self._stamp: dict[tuple[int, int], int] = {}
        self._clock = 0

    def touch(self, tier: int, index: int, weight: float = 1.0) -> None:
        key = (tier, int(index))
        self._clock += 1
        self._heat[key] = self._heat.get(key, 0.0) + weight
        self._stamp[key] = self._clock

    def advance(self) -> None:
        """One step of exponential decay (call once per engine step)."""
        if self.decay >= 1.0:
            return
        for key in self._heat:
            self._heat[key] *= self.decay

    def heat(self, tier: int, index: int) -> float:
        return self._heat.get((tier, int(index)), 0.0)

    def forget(self, tier: int, index: int) -> None:
        """Drop a page's history (freed back to the pool)."""
        key = (tier, int(index))
        self._heat.pop(key, None)
        self._stamp.pop(key, None)

    def retag(self, tier_from: int, index_from: int,
              tier_to: int, index_to: int) -> None:
        """Move a page's heat with it across a tier migration."""
        src = (tier_from, int(index_from))
        dst = (tier_to, int(index_to))
        self._heat[dst] = self._heat.pop(src, 0.0)
        self._stamp[dst] = self._stamp.pop(src, self._clock)

    # -- temperature ordering ---------------------------------------------
    def temperature(self, tier: int, index: int) -> tuple[float, int]:
        """Sort key: (decayed heat, last-touch stamp) — colder sorts first."""
        k = (tier, int(index))
        return (self._heat.get(k, 0.0), self._stamp.get(k, 0))

    def coldest(self, tier: int, candidates: Iterable[int]) -> int:
        cands = list(candidates)
        if not cands:
            raise ValueError("no candidate pages")
        return min(cands, key=lambda i: (*self.temperature(tier, i), i))

    def hottest(self, tier: int, candidates: Iterable[int]) -> int:
        cands = list(candidates)
        if not cands:
            raise ValueError("no candidate pages")
        return max(cands, key=lambda i: (*self.temperature(tier, i), -i))

    def ranked(self, tier: int, candidates: Iterable[int],
               hottest_first: bool = True) -> list[int]:
        return sorted(candidates,
                      key=lambda i: (*self.temperature(tier, i), i),
                      reverse=hottest_first)


def _weight_leaves(node: Any) -> Iterator[Any]:
    """The leaves of a params tree: tensors and `TieredTensor` operands."""
    if isinstance(node, dict):
        for v in node.values():
            yield from _weight_leaves(v)
    elif isinstance(node, TieredTensor) or hasattr(node, "nbytes"):
        yield node


def weight_tier_bytes(params) -> tuple[float, float]:
    """(local_bytes, remote_bytes) for one full read of a params tree.

    `TieredTensor` leaves contribute to both tiers; plain tensor leaves are
    HBM-resident.  Used by the engine to account per-step weight traffic
    (decode reads every weight once per step).
    """
    local = remote = 0.0
    for leaf in _weight_leaves(params):
        if isinstance(leaf, TieredTensor):
            loc, rem = traffic_bytes(leaf)
            local += loc
            remote += rem
        else:
            local += leaf.nbytes
    return local, remote


def weight_link_bytes(params, n_links: int) -> list[float]:
    """Per-host-link bytes for one full read of a params tree's remote
    partitions (the serving mesh's traffic accounting).

    A mesh-sharded remote partition (``mesh_axes`` set) is pulled as
    disjoint 1/P slices — each link carries its slice once (fetch-once
    broadcast); a whole remote partition (single link, or the divisibility
    fallback) is pulled entirely by every link (naive replication).  With
    one link this reduces to ``weight_tier_bytes``'s remote figure.
    """
    n = max(1, n_links)
    links = [0.0] * n
    for leaf in _weight_leaves(params):
        if not isinstance(leaf, TieredTensor):
            continue
        b = leaf.remote.nbytes
        share = b / n if getattr(leaf, "mesh_axes", None) is not None else b
        for i in range(n):
            links[i] += share
    return links
