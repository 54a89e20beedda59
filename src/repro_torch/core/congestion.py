"""Congestion control for remote-tier access — paper §4.3.1 (Fig. 7).

Phenomenon (paper): once the host link saturates, *excess* in-flight remote
requests pile up in shared resources of the on-chip memory system and stall
local HBM traffic.  Total in-flight remote volume is

    Q = N_streams · N_inflight · chunk_bytes

where on GPU N_streams = N_SM_host; on TPU it is the number of concurrent
host-DMA streams a kernel keeps open (one per pipeline stage per core) times
the chips pulling from their host link.

Model.  The link needs a bandwidth-delay product of in-flight bytes to
saturate:  Q* = B_h · RTT.   Below Q*, host throughput = Q/RTT (Little's
law).  Above Q*, host throughput stays B_h but the overflow occupies shared
request-tracking resources, degrading local HBM bandwidth linearly down to a
floor — the same shape as the paper's Fig. 7 measurements:

    hbm_eff(Q) = B_g · max(floor, 1 − penalty · max(0, Q−Q*)/Q*)

The paper sizes the window *statically* via an offline parameter sweep; on
hardware `sweep_window` runs against measured timings — here it runs against
this analytical model (documented hardware-adaptation substitution,
DESIGN.md §2).  The resulting static window feeds the Pallas kernels'
``num_slots`` (in-flight DMA buffers) and the planner's per-chip host-stream
cap.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol

from repro_torch.core.hardware import HardwareSpec


@dataclasses.dataclass(frozen=True)
class CongestionModel:
    hw: HardwareSpec
    rtt: float = 2.0e-6            # host-link round-trip (s): PCIe ~2us
    penalty: float = 0.35          # HBM degradation slope vs overflow fraction
    hbm_floor: float = 0.55        # worst-case local bw fraction (paper Fig.7 ~55-60%)

    @property
    def q_star(self) -> float:
        """Bandwidth-delay product: in-flight bytes that saturate the link."""
        return self.hw.host.bandwidth * self.rtt

    def host_throughput(self, inflight_bytes: float) -> float:
        if inflight_bytes <= 0:
            return 0.0
        return min(self.hw.host.bandwidth, inflight_bytes / self.rtt)

    def hbm_throughput(self, inflight_bytes: float) -> float:
        overflow = max(0.0, inflight_bytes - self.q_star) / self.q_star
        frac = max(self.hbm_floor, 1.0 - self.penalty * overflow)
        return self.hw.hbm.bandwidth * frac

    def aggregate(self, n_streams: int, window: int, chunk_bytes: int) -> float:
        """Aggregate achieved bandwidth for a (streams, window) choice."""
        q = float(n_streams) * window * chunk_bytes
        return self.host_throughput(q) + self.hbm_throughput(q)


# ---------------------------------------------------------------------------
# Pluggable measurement sources (runtime.controller feedback input).
#
# The adaptive runtime's AIMD controller is closed over a *measurement
# source*: anything that can report the achieved per-tier bandwidth at a
# given in-flight window.  On hardware that is the telemetry ring buffer
# (`runtime.telemetry`); in tests and in the analytical harness it is the
# congestion model itself, which makes the controller's convergence to
# `optimal_window` a deterministic, checkable property.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BandwidthSample:
    """One per-tier achieved-bandwidth observation."""

    host_bw: float                 # achieved host-link bandwidth (bytes/s)
    hbm_bw: float                  # achieved local HBM bandwidth (bytes/s)

    @property
    def aggregate(self) -> float:
        return self.host_bw + self.hbm_bw


class MeasurementSource(Protocol):
    def measure(self, window: int) -> BandwidthSample:
        """Achieved per-tier bandwidth with `window` in-flight slots."""
        ...


@dataclasses.dataclass(frozen=True)
class ModelSource:
    """The analytical `CongestionModel` as a measurement source."""

    model: CongestionModel
    n_streams: int
    chunk_bytes: int

    def measure(self, window: int) -> BandwidthSample:
        q = float(self.n_streams) * max(0, window) * self.chunk_bytes
        return BandwidthSample(
            host_bw=self.model.host_throughput(q),
            hbm_bw=self.model.hbm_throughput(q),
        )


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    n_inflight: int                # per-stream in-flight DMA slots
    n_streams: int                 # concurrent host streams (chips × pipeline stages)
    chunk_bytes: int
    aggregate_bw: float            # model-predicted achieved bandwidth
    uncontrolled_bw: float         # what an unconstrained issue rate would get

    @property
    def gain(self) -> float:
        return self.aggregate_bw / self.uncontrolled_bw if self.uncontrolled_bw else 1.0


def sweep_window(
    model: CongestionModel,
    n_streams: int,
    chunk_bytes: int,
    max_window: int = 64,
) -> list[tuple[int, float]]:
    """The paper's 'lightweight parameter-sweeping profiler' (§4.3.1)."""
    return [(w, model.aggregate(n_streams, w, chunk_bytes)) for w in range(1, max_window + 1)]


def optimal_window(
    model: CongestionModel,
    n_streams: int,
    chunk_bytes: int,
    max_window: int = 64,
    uncontrolled_window: int = 64,
) -> WindowPlan:
    """Static congestion window: smallest window achieving max aggregate bw."""
    sweep = sweep_window(model, n_streams, chunk_bytes, max_window)
    best_bw = max(bw for _, bw in sweep)
    # smallest window within 0.1% of the peak — saturate, don't exceed
    w = next(w for w, bw in sweep if bw >= best_bw * 0.999)
    return WindowPlan(
        n_inflight=w,
        n_streams=n_streams,
        chunk_bytes=chunk_bytes,
        aggregate_bw=model.aggregate(n_streams, w, chunk_bytes),
        uncontrolled_bw=model.aggregate(n_streams, uncontrolled_window, chunk_bytes),
    )


def optimal_host_streams(
    model: CongestionModel,
    window: int,
    chunk_bytes: int,
    required_streams: int,
    max_streams: int = 256,
) -> int:
    """Paper: cap N_SM_host — provision just enough streams to saturate the
    link (and to cover the offloaded data), never more.

    "Saturate" is judged against the *achievable* peak over the stream
    range, not the nominal link bandwidth: when the link never reaches
    ``B_h`` (BDP-limited windows, or a measured/soft-knee throughput curve
    that plateaus below nominal), the answer is the smallest stream count
    within tolerance of the best achievable throughput.  The previous
    ``for/else`` left ``saturating`` at ``max_streams`` whenever the
    nominal-bandwidth test never fired, silently over-provisioning streams
    past the plateau."""
    tput = [model.host_throughput(float(s) * window * chunk_bytes)
            for s in range(1, max_streams + 1)]
    best = max(tput)
    saturating = next(
        (s for s, th in enumerate(tput, start=1) if th >= best * 0.999),
        max_streams)
    return max(1, min(max(required_streams, 1), saturating))
