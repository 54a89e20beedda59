"""Read-amplification accounting + fetch-once-broadcast — paper §4.3.2.

Host memory is uncacheable by the accelerator, so every consumer of a remote
tile re-crosses the host link.  In a GEMM ``C[M,N] = A[M,K] @ B[K,N]`` with
A rows offloaded, each host row-tile of A is needed by every column-tile of
the output: ``ceil(N / tile_n)`` consumers ⇒ that much read amplification
(paper Table 1: 1.05× → 16.78× as N goes 256 → 4096).

The paper's fix is TMA multicast over DSMEM within a thread-block cluster.
The TPU analogue (DESIGN.md §2) operates at pod level: the host-resident
partition is *sharded* across chips, every chip DMAs a disjoint 1/P slice
over its own PCIe link, and the slices are exchanged over ICI (all-gather) —
each byte crosses the host link exactly once.  `host-locality-first`
scheduling becomes the tile→chip assignment that keeps each host row-tile's
consumers within one broadcast group, plus a grid ordering inside the Pallas
kernels that issues host-tile DMAs first.
"""
from __future__ import annotations

import dataclasses
import math


# TMA/DMA granularity overhead: minimum-burst padding on remote reads.
# Calibrated to the paper's Table 1 (98 MB offloaded, N=256 ⇒ 102.76 MB
# traffic = 1.05×): each 256-wide output column-tile re-reads A once, and the
# burst padding adds ~5%.
GRANULARITY_OVERHEAD = 102.76 / 98.0


@dataclasses.dataclass(frozen=True)
class AmplificationReport:
    host_bytes: int               # unique offloaded bytes
    consumers: int                # column-tiles needing each host row-tile
    traffic_no_multicast: float   # bytes crossing the host link, naive
    traffic_multicast: float      # bytes crossing the host link, fetch-once
    ici_bytes: float              # broadcast bytes over ICI (multicast path)

    @property
    def amplification(self) -> float:
        return self.traffic_no_multicast / self.host_bytes

    @property
    def amplification_multicast(self) -> float:
        return self.traffic_multicast / self.host_bytes


def gemm_read_amplification(
    host_bytes: int,
    n: int,
    tile_n: int = 256,
    broadcast_group: int = 1,
    overhead: float = GRANULARITY_OVERHEAD,
) -> AmplificationReport:
    """Traffic accounting for a GEMM with A partially host-resident.

    ``broadcast_group`` is the number of consumers sharing one fetch
    (cluster size on GPU / ICI group size on TPU). 1 = no multicast.
    """
    consumers = max(1, math.ceil(n / tile_n))
    fetches_naive = consumers
    fetches_mcast = math.ceil(consumers / max(1, broadcast_group))
    return AmplificationReport(
        host_bytes=host_bytes,
        consumers=consumers,
        traffic_no_multicast=host_bytes * fetches_naive * overhead,
        traffic_multicast=host_bytes * fetches_mcast * overhead,
        ici_bytes=host_bytes * max(0, broadcast_group - 1) * fetches_mcast,
    )


def sharded_fetch_report(
    host_bytes: float,
    n_devices: int,
    overhead: float = GRANULARITY_OVERHEAD,
) -> AmplificationReport:
    """Fetch-once-broadcast of a host partition to `n_devices` chips, as
    read-amplification accounting (the pod-level instance of
    :func:`gemm_read_amplification`).

    Each chip is one consumer of the full host partition (one column-tile
    per device) and all P chips form one broadcast group, so the naive
    path crosses the host links ``P·host_bytes`` total (every chip pulls
    everything over its own link) while the multicast path crosses them
    ``host_bytes`` total (disjoint 1/P slices, rebuilt over ICI).  Divide
    by ``n_devices`` for the per-link figures the serving engine accounts
    (`ServingEngine.mesh_traffic_report`).
    """
    return gemm_read_amplification(
        int(round(host_bytes)), n=max(1, n_devices), tile_n=1,
        broadcast_group=max(1, n_devices), overhead=overhead)


@dataclasses.dataclass(frozen=True)
class BroadcastPlan:
    """Pod-level fetch-once-broadcast of the host partition (TPU adaptation)."""

    group_size: int               # chips per broadcast group
    pcie_bytes_per_chip: float    # unique host bytes each chip pulls
    ici_bytes_per_chip: float     # all-gather traffic per chip
    t_pcie: float                 # time to pull the host slice
    t_ici: float                  # time to exchange slices over ICI
    t_naive: float                # every chip pulls the whole host partition

    @property
    def time(self) -> float:
        # PCIe pull and ICI exchange pipeline over tiles; bound = max stream.
        return max(self.t_pcie, self.t_ici)

    @property
    def speedup_vs_naive(self) -> float:
        return self.t_naive / self.time if self.time > 0 else float("inf")


def plan_broadcast(
    host_bytes: float,
    group_size: int,
    pcie_bw: float,
    ici_bw_per_chip: float,
) -> BroadcastPlan:
    """Fetch-once-broadcast: shard the host partition over `group_size` chips.

    Each chip pulls host_bytes/group over its own PCIe link; the ring
    all-gather then moves (group-1)/group · host_bytes over each chip's ICI
    links.  Naive: every chip pulls all host_bytes over PCIe.
    """
    g = max(1, group_size)
    slice_bytes = host_bytes / g
    ici_bytes = host_bytes * (g - 1) / g
    return BroadcastPlan(
        group_size=g,
        pcie_bytes_per_chip=slice_bytes,
        ici_bytes_per_chip=ici_bytes,
        t_pcie=slice_bytes / pcie_bw,
        t_ici=ici_bytes / ici_bw_per_chip if g > 1 else 0.0,
        t_naive=host_bytes / pcie_bw,
    )


def host_locality_schedule(
    n_row_tiles: int, n_col_tiles: int, host_row_tiles: int
) -> list[tuple[int, int]]:
    """Host-locality-first tile order (paper §4.3.2).

    Output tiles consuming the same *host* row-tile are scheduled
    contiguously (one broadcast group each), and host-sourced tiles are
    issued before HBM-sourced tiles so their longer-latency fetches start
    earliest.  Returns (row_tile, col_tile) grid order.
    """
    host_rows = range(n_row_tiles - host_row_tiles, n_row_tiles)
    local_rows = range(0, n_row_tiles - host_row_tiles)
    order: list[tuple[int, int]] = []
    for r in host_rows:            # grouped: all consumers of host row r together
        order += [(r, c) for c in range(n_col_tiles)]
    for r in local_rows:
        order += [(r, c) for c in range(n_col_tiles)]
    return order
