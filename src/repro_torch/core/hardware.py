"""Hardware tier/link constants for the tiered-memory model.

DAK's analysis is parameterized by three numbers per system:
  * ``peak_flops``  — accelerator peak math throughput (bf16 unless noted)
  * ``hbm_bw``      — local fast-tier (HBM) bandwidth, bytes/s
  * ``link_bw``     — host<->accelerator interconnect bandwidth, bytes/s
plus, for pod-level multicast planning, the inter-chip (ICI) link bandwidth.

We carry three presets: the TPU v5e target of this reproduction, and the two
GPU systems the paper evaluates on (GH200, RTX 6000 Pro Blackwell) so the
paper-parity benchmarks reproduce the paper's own numbers on the paper's own
hardware constants.
"""
from __future__ import annotations

import dataclasses

GB = 1e9
TB = 1e12


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One memory tier visible to the accelerator."""

    name: str
    bandwidth: float          # bytes/s the accelerator can stream from this tier
    capacity: float           # bytes


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """A tiered-memory accelerator system (one accelerator + its host link)."""

    name: str
    peak_flops: float         # FLOP/s (bf16/fp16 tensor math)
    hbm: TierSpec             # local tier
    host: TierSpec            # remote tier, bandwidth = min(link, host DRAM)
    ici_link_bw: float = 0.0  # bytes/s per inter-chip link (pods only)
    ici_links: int = 0        # links per chip participating in the mesh
    vmem_bytes: float = 128e6 # on-chip scratch (VMEM / SMEM-analogue)

    @property
    def aggregate_bw(self) -> float:
        """Paper footnote 1: GPU_HBM_BW + MIN(interconnect, host DRAM)."""
        return self.hbm.bandwidth + self.host.bandwidth

    @property
    def machine_balance(self) -> float:
        """FLOP/byte at which local-HBM ops flip memory<->compute bound."""
        return self.peak_flops / self.hbm.bandwidth


# --- TPU v5e: the reproduction target (roofline constants per assignment) ---
TPU_V5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm=TierSpec("hbm", bandwidth=819 * GB, capacity=16 * GB),
    # Per-chip PCIe Gen4-ish host link; host DRAM itself is far faster, so the
    # link is the binding constraint (min() in the paper's footnote).
    host=TierSpec("host_dram", bandwidth=32 * GB, capacity=512 * GB),
    ici_link_bw=50 * GB,
    ici_links=4,               # 2D torus: ±x, ±y
)

# --- Paper testbeds (for paper-parity benchmarks) ---
GH200 = HardwareSpec(
    name="gh200",
    peak_flops=989e12,          # H100 bf16 dense
    hbm=TierSpec("hbm3", bandwidth=4.0 * TB, capacity=96 * GB),
    # NVLink-C2C 450 GB/s/dir; host LPDDR5X ~500 GB/s => min = 450.
    host=TierSpec("lpddr5x", bandwidth=450 * GB, capacity=480 * GB),
    vmem_bytes=228e3 * 132,     # SMEM per SM * SMs — only used for scratch sizing
)

RTX6000_BLACKWELL = HardwareSpec(
    name="rtx6000_blackwell",
    peak_flops=503e12,
    hbm=TierSpec("gddr7", bandwidth=1.8 * TB, capacity=96 * GB),
    host=TierSpec("ddr5_pcie5", bandwidth=64 * GB, capacity=512 * GB),
    vmem_bytes=228e3 * 188,
)

# --- The port's target: one H100 SXM behind a PCIe Gen5 x16 host link ---
# Data-sheet figures: 989 TFLOP/s dense bf16, 80 GB HBM3 at 3.35 TB/s, and
# the link's nominal 64 GB/s per direction (the remote tier is pinned host
# DRAM read over it).  Dynamic shared memory a block can use: 227 KB of
# each of the 132 SMs.
H100_SXM = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm=TierSpec("hbm3", bandwidth=3.35 * TB, capacity=80 * GB),
    host=TierSpec("ddr5_pcie5", bandwidth=64 * GB, capacity=512 * GB),
    vmem_bytes=227e3 * 132,
)

SYSTEMS = {s.name: s for s in (TPU_V5E, GH200, RTX6000_BLACKWELL, H100_SXM)}


def optimal_memory_bound_ratio(hw: HardwareSpec) -> float:
    """Paper §4.2.1: memory-bound EB peaks at B_h / (B_h + B_g)."""
    bh, bg = hw.host.bandwidth, hw.hbm.bandwidth
    return bh / (bh + bg)


# --- mesh-level (multi-chip) views -----------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """The serving mesh as the planner sees it: P chips, each with its own
    host link, cooperating on one replica (paper §4.3.2 / DESIGN.md §2 —
    the host-resident partition is sharded 1/P per chip and rebuilt over
    ICI, so each offloaded byte crosses exactly one host link)."""

    n_devices: int = 1
    axis_name: str = "model"       # mesh axis carrying the remote-tier shards


def mesh_host_bandwidth(hw: HardwareSpec, n_devices: int) -> float:
    """Aggregate host-stream bandwidth of the mesh's P links under
    fetch-once-broadcast — NOT one link's physical rate.

    Each chip pulls 1/P of the host partition over its own link while the
    ring all-gather moves (P-1)/P of it over ICI; the streams pipeline, so
    the full partition arrives at every chip at
    ``host_bytes / max(t_pcie, t_ici)`` = ``min(P·B_h, B_ici·P/(P-1))``.
    This is what the allocator solves on (`mesh_hardware`); per-link
    pacing (AIMD limits, window solves) must keep using
    ``hw.host.bandwidth``.  With one chip (or no ICI figure) this
    degenerates to the plain link bandwidth.
    """
    p = max(1, n_devices)
    if p == 1:
        return hw.host.bandwidth
    agg = p * hw.host.bandwidth
    ici = hw.ici_link_bw * max(1, hw.ici_links)
    if ici > 0:
        agg = min(agg, ici * p / (p - 1))
    return agg


def mesh_hardware(hw: HardwareSpec, n_devices: int) -> HardwareSpec:
    """The aggregate-of-P-host-links view the greedy allocator solves on.

    Per-chip compute and HBM are unchanged (weights' local partitions and
    the KV page tables replicate); only the *remote* tier widens — P links
    pull disjoint 1/P shards in parallel, so the effective host bandwidth
    is :func:`mesh_host_bandwidth` and the host capacity aggregates.
    """
    p = max(1, n_devices)
    if p == 1:
        return hw
    return dataclasses.replace(
        hw,
        name=f"{hw.name}_x{p}",
        host=TierSpec(
            name=hw.host.name,
            bandwidth=mesh_host_bandwidth(hw, p),
            capacity=hw.host.capacity * p,
        ),
    )
