"""Effective-bandwidth (EB) model — paper §4.2.

Every matmul-class operation ``F_i`` in the inference pipeline is described by

  * ``bytes``  (paper ``C_i``): the weights-or-KV bytes the op must fetch,
  * ``flops``  (``W_i``): math work,
  * the hardware's two streaming tiers (``B_g`` local HBM, ``B_h`` host link).

Under offload ratio ``x`` (fraction of ``C`` resident on the host tier) with
*direct access* (both tiers streamed concurrently — the paper's core
mechanism), the op latency is

    T(x) = max( T_comp,  C·(1-x)/B_g,  C·x/B_h )

and the paper's performance metric is the effective bandwidth

    EB(x) = C / T(x).

The latency curve has two structural points:

  * ``x_lo`` — the smallest ratio achieving minimal latency.  For a strictly
    memory-bound op this is the paper's peak ``B_h/(B_h+B_g)`` (both streams
    finish together); for a compute-bound op it is 0.
  * ``x_hi`` — the largest ratio still achieving minimal latency (the
    paper's "turning point" / "threshold").  For a strictly memory-bound op
    ``x_hi == x_lo``; for a compute-bound op ``x_hi = T_comp·B_h/C`` (the
    point where the host stream alone would exceed the compute time).

Ops with ``C/(B_h+B_g) < T_comp < C/B_g`` are *mixed*: offloading first
helps (until ``x_lo``), is then free (until ``x_hi``), then hurts.  The
paper's two classes are the ends of this spectrum; the greedy allocator in
``planner.py`` is stated over ``(x_lo, x_hi)`` and reduces exactly to the
paper's three phases.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core.hardware import HardwareSpec

Boundness = Literal["memory", "compute", "mixed"]


@dataclasses.dataclass(frozen=True)
class OpProfile:
    """One offloadable operation (paper ``F_i``)."""

    name: str
    bytes: float              # C_i — offloadable operand bytes (weights or KV)
    flops: float              # W_i
    kind: str = "linear"      # "linear" (weights) | "attention" (KV cache)

    def t_comp(self, hw: HardwareSpec) -> float:
        return self.flops / hw.peak_flops

    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)

    # ---- latency / EB under direct access -------------------------------
    def latency(self, x: float, hw: HardwareSpec) -> float:
        """T(x) = max(T_comp, local stream, host stream)."""
        bg, bh = hw.hbm.bandwidth, hw.host.bandwidth
        return max(self.t_comp(hw), self.bytes * (1.0 - x) / bg, self.bytes * x / bh)

    def eb(self, x: float, hw: HardwareSpec) -> float:
        return self.bytes / self.latency(x, hw)

    # ---- structural points ----------------------------------------------
    def x_lo(self, hw: HardwareSpec) -> float:
        """Smallest ratio reaching min latency (memory-bound peak)."""
        bg, bh = hw.hbm.bandwidth, hw.host.bandwidth
        tc = self.t_comp(hw)
        balanced = bh / (bh + bg)                 # paper: B_h/(B_h+B_g)
        if tc <= self.bytes / (bh + bg):          # strictly memory-bound
            return balanced
        # local stream alone fits under T_comp at x >= 1 - tc*bg/C
        return max(0.0, 1.0 - tc * bg / self.bytes)

    def x_hi(self, hw: HardwareSpec) -> float:
        """Largest ratio at min latency (paper 'turning point'/'threshold')."""
        bg, bh = hw.hbm.bandwidth, hw.host.bandwidth
        tc = self.t_comp(hw)
        if tc <= self.bytes / (bh + bg):
            return bh / (bh + bg)
        return min(1.0, tc * bh / self.bytes)     # paper: T_comp·B_h/C

    def boundness(self, hw: HardwareSpec) -> Boundness:
        bg, bh = hw.hbm.bandwidth, hw.host.bandwidth
        tc = self.t_comp(hw)
        if tc <= self.bytes / (bh + bg):
            return "memory"
        if tc >= self.bytes / bg:
            return "compute"
        return "mixed"

    def min_latency(self, hw: HardwareSpec) -> float:
        return self.latency(self.x_lo(hw), hw)


def total_latency(ops: list[OpProfile], ratios: list[float], hw: HardwareSpec) -> float:
    """Paper objective: end-to-end latency = Σ_i T_i(x_i)."""
    return sum(op.latency(x, hw) for op, x in zip(ops, ratios, strict=True))


def aggregate_eb(ops: list[OpProfile], ratios: list[float], hw: HardwareSpec) -> float:
    """Pipeline-level effective bandwidth: total fetched bytes / total time."""
    c = sum(op.bytes for op in ops)
    return c / total_latency(ops, ratios, hw)


# ---------------------------------------------------------------------------
# Workload -> op enumeration (paper footnote 2: "linear" ops carry weights,
# "attention" ops carry KV cache).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Inference workload parameters used to profile ops."""

    batch: int
    seq_len: int              # KV length (decode) or prompt length (prefill)
    phase: str = "decode"     # "decode" | "prefill"
    dtype_bytes: int = 2


def linear_op(
    name: str, d_in: int, d_out: int, wl: WorkloadSpec, n_layers: int = 1
) -> OpProfile:
    """A weight matmul: x[B,T,d_in] @ W[d_in,d_out] (T=1 at decode)."""
    tokens = wl.batch * (wl.seq_len if wl.phase == "prefill" else 1)
    c = float(d_in) * d_out * wl.dtype_bytes * n_layers
    w = 2.0 * tokens * d_in * d_out * n_layers
    return OpProfile(name=name, bytes=c, flops=w, kind="linear")


def attention_op(
    name: str,
    n_kv_heads: int,
    head_dim: int,
    n_q_heads: int,
    wl: WorkloadSpec,
    n_layers: int = 1,
) -> OpProfile:
    """KV-cache matmuls (QK^T and PV) for one layer group.

    Decode: memory O(B·L·Dh·H_kv), flops O(B·L·Dh·H_q) => AI = O(H_q/H_kv).
    Prefill: flops gain another factor of L (AI = O(L)) — paper §4.2.1.
    """
    kv_tokens = wl.batch * wl.seq_len
    c = 2.0 * kv_tokens * n_kv_heads * head_dim * wl.dtype_bytes * n_layers
    q_tokens = wl.batch * (wl.seq_len if wl.phase == "prefill" else 1)
    # QK^T + PV, causal prefill halves the effective kv length on average.
    causal = 0.5 if wl.phase == "prefill" else 1.0
    w = 2.0 * 2.0 * q_tokens * wl.seq_len * causal * n_q_heads * head_dim * n_layers
    return OpProfile(name=name, bytes=c, flops=w, kind="attention")
