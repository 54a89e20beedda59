"""Optimal greedy offload allocator — paper §4.2.2 + Appendix A.

Problem:   min_x  Σ_i C_i / EB_i(x_i)      (= Σ_i T_i(x_i))
           s.t.   Σ_i C_i·x_i = R·Σ_i C_i,   0 ≤ x_i ≤ 1.

The greedy allocates the global budget in three phases, keyed on each op's
``x_lo`` (smallest latency-minimizing ratio) and ``x_hi`` (turning point):

  Phase 1  raise ops toward ``x_lo`` — this is the paper's "allocate to
           memory-bound operations" (compute-bound ops have x_lo = 0 so they
           receive nothing here).  Distribution among them is free
           (Theorem 1) — we use proportional-to-deficit for determinism.
  Phase 2  distribute the remainder inside the free intervals
           [x_lo, x_hi] — the paper's "saturate compute-bound operations"
           (Theorem 2).  Again any distribution is optimal.
  Phase 3  beyond every turning point the marginal cost of any offloaded
           byte is 1/B_h regardless of op (Theorem 3) — distribute the
           excess proportionally to remaining headroom.

``brute_force`` is a dense grid-search oracle used by the hypothesis tests
to check optimality (Theorems 1–3) numerically.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.ebmodel import OpProfile, total_latency
from repro_torch.core.hardware import HardwareSpec


@dataclasses.dataclass(frozen=True)
class OffloadPlan:
    ratios: tuple[float, ...]          # x_i per op, same order as `ops`
    global_ratio: float                # R
    latency: float                     # Σ T_i(x_i), seconds
    phase_reached: int                 # 1, 2 or 3 — how deep allocation went


def _distribute(budget: float, capacity: np.ndarray) -> np.ndarray:
    """Give each slot budget proportional to capacity, capped at capacity.

    Water-fills iteratively so the full budget lands even when some slots
    saturate.  budget ≤ capacity.sum() must hold.
    """
    alloc = np.zeros_like(capacity)
    remaining = budget
    active = capacity > 0
    for _ in range(len(capacity) + 1):
        if remaining <= 1e-12 or not active.any():
            break
        share = remaining * capacity[active] / capacity[active].sum()
        take = np.minimum(share, capacity[active] - alloc[active])
        alloc[active] += take
        remaining -= take.sum()
        active = active & (alloc < capacity - 1e-12)
    return alloc


def solve(ops: list[OpProfile], global_ratio: float, hw: HardwareSpec) -> OffloadPlan:
    """Three-phase greedy allocation (provably optimal — paper Appendix A)."""
    if not 0.0 <= global_ratio <= 1.0:
        raise ValueError(f"global offload ratio must be in [0,1], got {global_ratio}")
    c = np.array([op.bytes for op in ops], dtype=np.float64)
    x_lo = np.array([op.x_lo(hw) for op in ops])
    x_hi = np.array([op.x_hi(hw) for op in ops])
    budget = global_ratio * c.sum()
    x = np.zeros(len(ops))

    # Phase 1: toward x_lo (memory-bound peaks).
    cap1 = c * x_lo
    phase = 1
    if budget <= cap1.sum() + 1e-9:
        x += _distribute(budget, cap1) / np.maximum(c, 1e-30)
    else:
        x += x_lo
        budget -= cap1.sum()
        # Phase 2: free intervals [x_lo, x_hi] (compute-bound thresholds).
        cap2 = c * (x_hi - x_lo)
        phase = 2
        if budget <= cap2.sum() + 1e-9:
            x += _distribute(budget, cap2) / np.maximum(c, 1e-30)
        else:
            x = x_hi.copy()
            budget -= cap2.sum()
            # Phase 3: beyond turning points — uniform marginal cost 1/B_h.
            cap3 = c * (1.0 - x_hi)
            phase = 3
            x += _distribute(budget, cap3) / np.maximum(c, 1e-30)
    x = np.clip(x, 0.0, 1.0)
    return OffloadPlan(
        ratios=tuple(float(v) for v in x),
        global_ratio=global_ratio,
        latency=total_latency(ops, list(x), hw),
        phase_reached=phase,
    )


def solve_uniform(ops: list[OpProfile], global_ratio: float, hw: HardwareSpec) -> OffloadPlan:
    """Paper's baseline: the same ratio R for every op (§4.2.1, Fig. 11)."""
    x = [global_ratio] * len(ops)
    return OffloadPlan(
        ratios=tuple(x),
        global_ratio=global_ratio,
        latency=total_latency(ops, x, hw),
        phase_reached=0,
    )


def brute_force(
    ops: list[OpProfile], global_ratio: float, hw: HardwareSpec, grid: int = 48
) -> OffloadPlan:
    """Dense grid-search oracle (exponential — test sizes only).

    Enumerates ratio grids for n-1 ops and solves the last op from the
    budget-equality constraint; keeps the feasible minimum.
    """
    c = np.array([op.bytes for op in ops], dtype=np.float64)
    budget = global_ratio * c.sum()
    # put the largest-bytes op last: it absorbs the budget-equality residue
    # with the most resolution, so a feasible grid point always exists
    order = np.argsort(c)
    inv = np.argsort(order)
    ops_o = [ops[i] for i in order]
    c_o = c[order]
    pts = np.linspace(0.0, 1.0, grid + 1)
    best: OffloadPlan | None = None
    for combo in itertools.product(pts, repeat=len(ops) - 1):
        used = float(np.dot(combo, c_o[:-1]))
        last = (budget - used) / c_o[-1]
        if not -1e-9 <= last <= 1.0 + 1e-9:
            continue
        ratios_o = list(combo) + [float(np.clip(last, 0.0, 1.0))]
        lat = total_latency(ops_o, ratios_o, hw)
        if best is None or lat < best.latency:
            ratios = tuple(ratios_o[i] for i in inv)
            best = OffloadPlan(ratios, global_ratio, lat, phase_reached=-1)
    assert best is not None, "no feasible allocation on grid"
    return best


def global_offload_ratio(footprint_bytes: float, hbm_budget_bytes: float) -> float:
    """Paper §3: OR = max(0, 1 - HBM_avail / footprint)."""
    if footprint_bytes <= 0:
        return 0.0
    return float(np.clip(1.0 - hbm_budget_bytes / footprint_bytes, 0.0, 1.0))
