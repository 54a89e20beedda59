"""Phase-aware re-planning — per-op ratios that track the live workload.

The greedy allocator (`core.planner.solve`) is provably optimal *for the
workload it was handed*; the serving engine hands it the steady-state
decode workload once, at startup.  But an op's boundness — and therefore
its optimal offload ratio — is phase-dependent (paper §4.2.1: prefill
attention is compute-bound where decode attention is memory-bound), so a
shifting prefill/decode mix strands the plan away from the optimum.

:class:`Replanner` watches the telemetry EMA of the prefill token fraction
(and the observed batch / KV-length) and, when the mix drifts past
``drift_threshold`` from the mix the current plan was solved for, re-runs
the full planning pass on the *observed* workload.  :func:`repartition`
then realizes the new ratios incrementally: only operands whose realized
split extents actually moved are re-split (materialize → re-partition —
bitwise-identical to a fresh partition of the original params); every
other leaf passes through as the same object, so an unchanged plan is a
strict no-op.

Pool budgets are *not* resized on re-plan: the KV page pools are fixed
jnp allocations, so KV-ratio drift is absorbed by the live page migrator
(`runtime.migration`) moving pages within the existing pools.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import engine as offload_engine
from repro_torch.core import hardware as hardware_mod
from repro_torch.core import tiering
from repro_torch.core.engine import _copy_tree, _set_path
from repro_torch.core.ebmodel import WorkloadSpec
from repro_torch.core.hardware import HardwareSpec
from repro_torch.models.registry import resolve
from repro_torch.runtime.telemetry import Telemetry


@dataclasses.dataclass(frozen=True)
class ReplanPolicy:
    drift_threshold: float = 0.25   # |observed mix − planned mix| that triggers
    min_interval: int = 4           # steps between consecutive re-plans
    warmup_steps: int = 2           # steps of telemetry before the first re-plan


class Replanner:
    """Re-run the greedy allocator when the observed workload mix drifts."""

    def __init__(
        self,
        cfg: ModelConfig,
        hw: HardwareSpec,
        base_plan: offload_engine.TieringPlan,
        *,
        policy: ReplanPolicy | None = None,
    ):
        self.cfg = cfg
        self.hw = hw
        self.plan = base_plan
        self.policy = policy or ReplanPolicy()
        # Mix the current plan was solved for: the startup plan is the
        # steady-state decode solve (prefill fraction 0).
        self.planned_mix = 0.0
        self.replans = 0
        # Why the last re-plan fired ('drift' | 'forced'), with the ratio
        # it landed on — trace-event args for the observability layer.
        self.last_reason: str | None = None
        self._last_replan_step = -(10 ** 9)

    def drift(self, telemetry: Telemetry) -> float:
        return abs(telemetry.prefill_fraction - self.planned_mix)

    def observed_workload(self, telemetry: Telemetry) -> WorkloadSpec:
        """The workload the telemetry EMAs describe."""
        phase = "prefill" if telemetry.prefill_fraction >= 0.5 else "decode"
        batch = max(1, round(telemetry.mean_batch)) if phase == "decode" else 1
        seq = max(1, round(telemetry.mean_kv_len))
        if phase == "prefill":
            # Mean admitted prompt length ≈ prefill tokens per prefill step.
            steps = max(1, telemetry.total_steps)
            seq = max(1, round(telemetry.total_prefill_tokens / steps), seq)
        return WorkloadSpec(batch=batch, seq_len=seq, phase=phase)

    def maybe_replan(self, telemetry: Telemetry) -> offload_engine.TieringPlan | None:
        """Returns a new plan when the mix drifted past threshold, else None."""
        pol = self.policy
        if not math.isfinite(pol.drift_threshold):
            return None
        if telemetry.total_steps < pol.warmup_steps:
            return None
        if telemetry.total_steps - self._last_replan_step < pol.min_interval:
            return None
        if self.drift(telemetry) <= pol.drift_threshold:
            return None
        wl = self.observed_workload(telemetry)
        page_size = (self.plan.kv_pages.page_size
                     if self.plan.kv_pages is not None else 16)
        # The device axis survives a re-plan: re-solve on the same mesh so
        # the new ratios still shard into 1/P host-link slices.
        mesh_spec = None
        if self.plan.mesh is not None:
            mesh_spec = hardware_mod.MeshSpec(
                n_devices=self.plan.mesh.n_devices,
                axis_name=self.plan.mesh.axis_name)
        new = offload_engine.plan(
            self.cfg, wl, self.hw, global_ratio=self.plan.global_ratio,
            kv_page_size=page_size, mesh=mesh_spec)
        self.planned_mix = telemetry.prefill_fraction
        self.plan = new
        self.replans += 1
        self.last_reason = "drift"
        self._last_replan_step = telemetry.total_steps
        return new

    def force_ratio(self, local_fraction: float,
                    telemetry: Telemetry) -> offload_engine.TieringPlan | None:
        """Elastic re-plan at a *higher* offload ratio — the escape valve
        for local-capacity pressure (the KV-offloading bottleneck analysis:
        when HBM shrinks, a larger remote share is the right answer, not a
        crash).

        ``local_fraction`` is what remains of the local budget the current
        plan assumed: the share that must live remote grows to
        ``1 - (1 - r) * fraction``.  No drift gate, no warmup, no interval
        — capacity pressure, not mix drift, triggers this path — but a
        ratio that would not actually increase returns None (restoring a
        budget never forces a re-plan downward; the drift path handles
        optimization).  The solve runs on the telemetry-observed workload
        and the same mesh, exactly like :meth:`maybe_replan`, so the
        incremental :func:`repartition` realizes it bitwise-identically to
        a fresh partition."""
        frac = min(1.0, max(0.0, local_fraction))
        new_ratio = min(1.0, 1.0 - (1.0 - self.plan.global_ratio) * frac)
        if new_ratio <= self.plan.global_ratio + 1e-9:
            return None
        wl = self.observed_workload(telemetry)
        page_size = (self.plan.kv_pages.page_size
                     if self.plan.kv_pages is not None else 16)
        mesh_spec = None
        if self.plan.mesh is not None:
            mesh_spec = hardware_mod.MeshSpec(
                n_devices=self.plan.mesh.n_devices,
                axis_name=self.plan.mesh.axis_name)
        new = offload_engine.plan(
            self.cfg, wl, self.hw, global_ratio=new_ratio,
            kv_page_size=page_size, mesh=mesh_spec)
        self.plan = new
        self.replans += 1
        self.last_reason = "forced"
        self._last_replan_step = telemetry.total_steps
        return new


def repartition(
    params: dict[str, Any],
    new_plan: offload_engine.TieringPlan,
    *,
    align: int = 1,
) -> tuple[dict[str, Any], list[str]]:
    """Incrementally realize `new_plan`'s ratios on an already-partitioned
    params tree.  The current split state is read off the leaves themselves
    (a `TieredTensor`'s remote extent), so the caller does not need to
    thread the superseded plan through.

    Only operands whose *realized* split extents move are touched: each is
    re-split at the new boundary, which is bitwise-identical to
    partitioning the original params fresh.  Operands whose rounded remote
    extent is unchanged — including every one whose ratio did not move —
    pass through as the identical leaf object.

    The port never rebuilds a changed operand unsplit: its new tiers are
    allocated at their final size (the remote one as pinned, device-mapped
    host memory on a CUDA device, as `TieringPlan.partition_source` does)
    and filled from the old tiers one slice of the stack's leading (layer
    or block) axis at a time, so beyond the new tiers the device holds at
    most one layer's columns in flight.  The old tiers stay as they are;
    the caller synchronises the stream before it drops them.

    Returns ``(new_params, changed_paths)``.
    """
    out = _copy_tree(params)
    changed: list[str] = []
    mesh_div = (new_plan.mesh.n_devices
                if new_plan.mesh is not None and new_plan.mesh.n_devices > 1
                else 1)
    for od in new_plan.registry:
        new_r = new_plan.op_ratios.get(od.op, 0.0)
        leaf = resolve(params, od.path)
        is_tiered = isinstance(leaf, tiering.TieredTensor)
        dim = leaf.shape[od.axis]
        align_eff = od.align if od.align is not None else align
        align_eff = math.lcm(align_eff, mesh_div)
        _, tgt_remote = tiering.split_sizes(dim, max(0.0, new_r), align_eff)
        cur_remote = leaf.remote.shape[od.axis] if is_tiered else 0
        if tgt_remote == cur_remote:
            continue
        _set_path(out, od.path, _resplit(leaf, od.axis, dim - tgt_remote,
                                         stacked=len(od.path) > 1))
        changed.append(od.path_str)
    return out, changed


def _resplit(leaf: Any, axis: int, n_local: int, *, stacked: bool) -> Any:
    """`leaf` (a `TieredTensor` or a whole tensor) split at `n_local` along
    `axis`: a new `TieredTensor`, or a whole tensor on the local tier's
    device when nothing stays remote.  A `stacked` leaf (a layer or block
    stack) is copied one slice of its leading axis at a time."""
    olds = [leaf.local, leaf.remote] if isinstance(leaf, tiering.TieredTensor) else [leaf]
    device = olds[0].device
    shape = list(leaf.shape)
    ax = axis % len(shape)
    local_shape, remote_shape = list(shape), list(shape)
    local_shape[ax] = n_local
    remote_shape[ax] -= n_local
    news = [torch.empty(local_shape, dtype=olds[0].dtype, device=device)]
    if remote_shape[ax]:
        from repro_torch.kernels import _build

        news.append(_build.host_tier(remote_shape, olds[0].dtype, device))

    def starts(parts: list[torch.Tensor]) -> list[tuple[torch.Tensor, int]]:
        """Each part with the offset of its first column along `axis`."""
        out, at = [], 0
        for t in parts:
            out.append((t, at))
            at += t.shape[ax]
        return out

    sub = ax - 1 if stacked else ax
    news_at, olds_at = starts(news), starts(olds)
    for i in range(shape[0] if stacked else 1):
        for dst, d0 in news_at:
            for src, s0 in olds_at:
                lo = max(d0, s0)
                hi = min(d0 + dst.shape[ax], s0 + src.shape[ax])
                if lo >= hi:
                    continue
                d, s = (dst[i], src[i]) if stacked else (dst, src)
                d.narrow(sub, lo - d0, hi - lo).copy_(s.narrow(sub, lo - s0, hi - lo))
    if len(news) == 1:
        return news[0]
    return tiering.TieredTensor(local=news[0], remote=news[1], axis=axis)
