"""Collective-traffic accounting and roofline terms for the dry run.

Counterpart of ``src/repro/launch/hlo_analysis.py``.  `CollectiveStats`,
`RooflineTerms` and the ring factors are the reference's.  Where the
reference reads XLA objects (``memory_analysis()`` and the collective
instructions of the compiled HLO text), the port reads the trace of
`launch.hlo_cost`: `collective_stats` and `memory_dict` take its `HloCost`.

The roofline's default figures are the H100 SXM's (`core.hardware.H100_SXM`:
989 TFLOP/s dense bf16, 3.35 TB/s HBM3).  The card-to-card figure is an
argument with its source named beside it: by default NVLink 4 at 450 GB/s
a direction (NVIDIA H100 SXM data sheet: 900 GB/s bidirectional).  It is
kept out of `H100_SXM`, whose ICI fields price the serving planner's mesh.
Every per-device byte of a collective is priced at that one link rate, so
a collective that leaves an 8-GPU NVLink domain (a 16-wide axis spans two
nodes) is under-priced: `t_collective` is a lower bound.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import H100_SXM

_TRAFFIC_FACTOR = {  # per-device bytes moved per payload byte (ring algos)
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-reduce": 2.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# The card-to-card rate the roofline prices collectives at, and its source.
NVLINK4_BW = 450e9
NVLINK4_SOURCE = "NVLink 4, 450 GB/s per direction (NVIDIA H100 SXM data sheet)"


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, float]
    count_by_kind: dict[str, int]

    @property
    def total_bytes(self) -> float:
        """Per-device traffic bytes (factors applied)."""
        return sum(_TRAFFIC_FACTOR[k] * v for k, v in self.bytes_by_kind.items())

    @property
    def raw_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class RooflineTerms:
    """Per-step roofline terms (seconds) on the target system."""

    t_compute: float
    t_memory: float
    t_collective: float
    flops: float                 # total flops (all chips)
    hbm_bytes: float             # total bytes accessed (all chips)
    collective_bytes: float      # total traffic (all chips)
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)


def roofline(
    flops_per_device: float,
    bytes_per_device: float,
    coll_bytes_per_device: float,
    chips: int,
    peak_flops: float = H100_SXM.peak_flops,
    hbm_bw: float = H100_SXM.hbm.bandwidth,
    link_bw_per_chip: float = NVLINK4_BW,
) -> RooflineTerms:
    return RooflineTerms(
        t_compute=flops_per_device / peak_flops,
        t_memory=bytes_per_device / hbm_bw,
        t_collective=coll_bytes_per_device / link_bw_per_chip,
        flops=flops_per_device * chips,
        hbm_bytes=bytes_per_device * chips,
        collective_bytes=coll_bytes_per_device * chips,
        chips=chips,
    )


def collective_stats(cost) -> CollectiveStats:
    """The raw payloads (no ring factor) and counts of a trace's collectives:
    what the reference's ``parse_collectives`` reads from the HLO text."""
    return CollectiveStats(dict(cost.collective_raw_by_kind), dict(cost.collective_counts))


def memory_dict(cost) -> dict[str, float]:
    """``memory_analysis()``'s sizes as the trace has them: the local shards
    of the step's arguments and outputs, and the peak of live local bytes
    where the trace took one (``temp_size_in_bytes``: that peak less the
    arguments)."""
    out = {"argument_size_in_bytes": float(cost.argument_bytes),
           "output_size_in_bytes": float(cost.output_bytes)}
    if cost.peak_live_bytes is not None:
        out["temp_size_in_bytes"] = float(max(0, cost.peak_live_bytes - cost.argument_bytes))
    return out
