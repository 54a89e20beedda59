"""Plan validator (DAK201-205): structural checks over ``TieringPlan``.

The planner is provably optimal *given* its own invariants — the greedy
spends exactly the global byte budget, every planned op maps onto a real
operand, the congestion window sits at the model's knee, and the realized
split is a fixed point of ``repartition``.  These are exactly the
properties later layers assume without re-checking (the serving engine
sizes pools from ``kv_pages``, the mesh path divides remote extents by P,
the kernels take ``window.n_inflight`` as their DMA slot count), so drift
here surfaces far away as capacity bugs or wrong traffic accounting.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.analysis.findings import Finding
from repro_torch.core import congestion, tiering
from repro_torch.core.engine import TieringPlan
from repro_torch.core.hardware import HardwareSpec, mesh_hardware

# Planned ops that legitimately have no weight operand in the registry:
# "attention" offloads the KV *cache*, realized page-granularly by
# ``plan.kv_pages`` and the paged cache rather than by a TieredArray.
ALLOWED_UNREALIZED = frozenset({"attention"})

_REL_TOL = 1e-6


def check_budget(plan: TieringPlan, *, where: str = "plan") -> list[Finding]:
    """DAK201: byte-budget conservation.  The greedy must spend exactly
    ``R · Σ C_i`` (paper §4.2.2 constraint), every per-op ratio must stay in
    [0, 1], and the KV page budget must conserve the pool (local + remote =
    total, achieved ratio within one page of the continuous solve)."""
    out: list[Finding] = []
    if not plan.ops:
        out.append(Finding("DAK201", where, "plan carries no op profiles"))
        return out
    total = sum(op.bytes for op in plan.ops)
    spent = 0.0
    for op in plan.ops:
        r = plan.op_ratios.get(op.name)
        if r is None:
            out.append(Finding("DAK201", f"{where}.op_ratios",
                               f"op {op.name!r} missing from the solve"))
            continue
        if not -_REL_TOL <= r <= 1.0 + _REL_TOL:
            out.append(Finding("DAK201", f"{where}.op_ratios[{op.name}]",
                               f"ratio {r} outside [0, 1]"))
        spent += op.bytes * r
    want = plan.global_ratio * total
    if abs(spent - want) > _REL_TOL * max(total, 1.0):
        out.append(Finding(
            "DAK201", f"{where}.op_ratios",
            f"allocated {spent:.6e} offloaded bytes but the global budget is "
            f"{want:.6e} (R={plan.global_ratio}, total={total:.6e}) — the "
            "greedy must conserve the budget exactly",
            context={"spent": spent, "budget": want}))
    kp = plan.kv_pages
    if kp is not None:
        if kp.local_pages + kp.remote_pages != kp.total_pages:
            out.append(Finding(
                "DAK201", f"{where}.kv_pages",
                f"page budget leaks: {kp.local_pages} local + {kp.remote_pages} "
                f"remote != {kp.total_pages} total"))
        if min(kp.local_pages, kp.remote_pages, kp.total_pages) < 0:
            out.append(Finding("DAK201", f"{where}.kv_pages",
                               "negative page count"))
        elif kp.total_pages > 0:
            # One page of slack each way, plus the >=1-page floors that keep
            # both tiers exercised for non-degenerate ratios.
            drift = abs(kp.remote_pages - plan.kv_ratio * kp.total_pages)
            if drift > 1.0 + _REL_TOL and not (
                    kp.remote_pages in (1, kp.total_pages - 1)):
                out.append(Finding(
                    "DAK201", f"{where}.kv_pages",
                    f"{kp.remote_pages} remote pages drift {drift:.2f} pages "
                    f"from kv_ratio={plan.kv_ratio:.4f} of {kp.total_pages}"))
    return out


def check_registry(plan: TieringPlan, cfg: Any = None, *,
                   where: str = "plan") -> list[Finding]:
    """DAK202: registry completeness, both directions.  Every registered
    operand's op must be priced by the solve, and every op the solve
    offloads must be realizable — by a registry operand, or by the KV page
    budget for "attention", or (tied embeddings) priced-but-tied "lm_head".
    An op that is planned remote but realized nowhere would silently keep
    its bytes in HBM: exactly the budget overrun the paper's Fig. 10 mode
    is supposed to prevent."""
    out: list[Finding] = []
    registry_ops = {od.op for od in plan.registry}
    for od in plan.registry:
        if od.op not in plan.op_ratios:
            out.append(Finding(
                "DAK202", f"{where}.registry[{od.path_str}]",
                f"operand op {od.op!r} never priced by the planner"))
    allowed = set(ALLOWED_UNREALIZED)
    if cfg is None or getattr(cfg, "tie_embeddings", False):
        allowed.add("lm_head")
    for name, ratio in plan.op_ratios.items():
        if ratio <= 0.0 or name in registry_ops:
            continue
        if name == "attention":
            kp = plan.kv_pages
            if kp is None or kp.remote_pages < 1:
                out.append(Finding(
                    "DAK202", f"{where}.op_ratios[attention]",
                    f"KV offload ratio {ratio:.4f} but no remote page budget "
                    "realizes it"))
            continue
        if name not in allowed:
            out.append(Finding(
                "DAK202", f"{where}.op_ratios[{name}]",
                f"op planned at ratio {ratio:.4f} but no registry operand "
                "realizes it — its bytes stay resident in HBM"))
    for path, r in plan.param_ratios.items():
        if path not in {od.path_str for od in plan.registry}:
            out.append(Finding("DAK202", f"{where}.param_ratios[{path}]",
                               "path not in the operand registry"))
        op = next((od.op for od in plan.registry if od.path_str == path), None)
        if op is not None and plan.op_ratios.get(op) != r:
            out.append(Finding(
                "DAK202", f"{where}.param_ratios[{path}]",
                f"param ratio {r} disagrees with op ratio "
                f"{plan.op_ratios.get(op)} for op {op!r}"))
    return out


def _check_window(window: congestion.WindowPlan, model: congestion.CongestionModel,
                  site: str) -> list[Finding]:
    out: list[Finding] = []
    if window.n_inflight < 1 or window.n_streams < 1 or window.chunk_bytes <= 0:
        out.append(Finding(
            "DAK203", site,
            f"degenerate window (n_inflight={window.n_inflight}, "
            f"n_streams={window.n_streams}, chunk={window.chunk_bytes})"))
        return out
    achieved = model.aggregate(window.n_streams, window.n_inflight,
                               window.chunk_bytes)
    if abs(achieved - window.aggregate_bw) > _REL_TOL * max(achieved, 1.0):
        out.append(Finding(
            "DAK203", site,
            f"claimed aggregate bandwidth {window.aggregate_bw:.4e} does not "
            f"match the congestion model ({achieved:.4e})"))
    sweep = congestion.sweep_window(model, window.n_streams, window.chunk_bytes)
    peak = max(bw for _, bw in sweep)
    if achieved < peak * 0.999 - _REL_TOL * peak:
        out.append(Finding(
            "DAK203", site,
            f"window {window.n_inflight} achieves {achieved:.4e} B/s, below "
            f"99.9% of the sweep peak {peak:.4e} — the static window must sit "
            "at the congestion knee (paper Fig. 7)",
            context={"window": window.n_inflight, "achieved": achieved,
                     "peak": peak}))
    return out


def check_window(plan: TieringPlan, hw: HardwareSpec, *,
                 where: str = "plan") -> list[Finding]:
    """DAK203: the plan's congestion windows are feasible and optimal
    against the analytical model re-derived from the hardware profile (the
    kernels take ``n_inflight`` as their DMA slot depth — an over-deep
    window re-creates the HBM-interference regime the paper measures)."""
    model = congestion.CongestionModel(hw)
    out = _check_window(plan.window, model, f"{where}.window")
    if plan.mesh is not None:
        for i, lw in enumerate(plan.mesh.link_windows):
            out.extend(_check_window(lw, model, f"{where}.mesh.link_windows[{i}]"))
    return out


def check_repartition_idempotent(params: dict[str, Any], plan: TieringPlan, *,
                                 align: int = 1,
                                 where: str = "plan") -> list[Finding]:
    """DAK204: a params tree that already realizes ``plan`` is a fixed point
    of ``runtime.replan.repartition`` — re-planning to the same ratios must
    touch nothing (the adaptive runtime relies on this to make drift-free
    re-plans free)."""
    from repro_torch.runtime import replan

    _, changed = replan.repartition(params, plan, align=align)
    if changed:
        return [Finding(
            "DAK204", f"{where}.repartition",
            f"re-realizing the already-applied plan moved {len(changed)} "
            f"operand(s): {changed} — repartition is not idempotent")]
    return []


def check_mesh(plan: TieringPlan, hw: HardwareSpec,
               extents: list[tuple[str, int, int]] | None = None, *,
               where: str = "plan") -> list[Finding]:
    """DAK205: mesh-plan structure.  One congestion window per host link,
    the aggregate the allocator solved on matches ``mesh_hardware``'s
    widened host tier, fetch-once traffic never exceeds naive, and every
    realized remote extent divides into P equal link slices
    (``extents`` rows are ``(name, dim, n_remote)``)."""
    mesh = plan.mesh
    if mesh is None:
        return []
    out: list[Finding] = []
    if mesh.n_devices < 2:
        out.append(Finding("DAK205", f"{where}.mesh",
                           f"mesh plan with n_devices={mesh.n_devices}"))
        return out
    if len(mesh.link_windows) != mesh.n_devices:
        out.append(Finding(
            "DAK205", f"{where}.mesh.link_windows",
            f"{len(mesh.link_windows)} per-link windows for "
            f"{mesh.n_devices} host links — the runtime adapts one AIMD "
            "loop per link"))
    want_agg = mesh_hardware(hw, mesh.n_devices).host.bandwidth
    if abs(mesh.aggregate_host_bw - want_agg) > _REL_TOL * max(want_agg, 1.0):
        out.append(Finding(
            "DAK205", f"{where}.mesh.aggregate_host_bw",
            f"allocator solved on {mesh.aggregate_host_bw:.4e} B/s but "
            f"mesh_hardware({hw.name}, P={mesh.n_devices}) gives "
            f"{want_agg:.4e} (ICI-capped aggregate)"))
    if mesh.host_link_bw != hw.host.bandwidth:
        out.append(Finding("DAK205", f"{where}.mesh.host_link_bw",
                           f"per-link bandwidth {mesh.host_link_bw:.4e} != "
                           f"hardware profile {hw.host.bandwidth:.4e}"))
    t = mesh.traffic
    if t.traffic_multicast > t.traffic_no_multicast * (1.0 + _REL_TOL):
        out.append(Finding(
            "DAK205", f"{where}.mesh.traffic",
            f"fetch-once traffic {t.traffic_multicast:.4e} exceeds the naive "
            f"replication oracle {t.traffic_no_multicast:.4e}"))
    for name, dim, n_remote in extents or []:
        if n_remote % mesh.n_devices:
            out.append(Finding(
                "DAK205", f"{where}.extents[{name}]",
                f"remote extent {n_remote} of {dim} not divisible by "
                f"P={mesh.n_devices} — host shard cannot split into equal "
                "link slices"))
    return out


def realized_extents(plan: TieringPlan, shapes: dict[str, tuple[int, ...]], *,
                     align: int = 1) -> list[tuple[str, int, int]]:
    """Replay ``TieringPlan.partition``'s extent arithmetic over abstract
    operand shapes: rows of ``(path, dim, n_remote)`` for every operand the
    plan realizes (n_remote > 0).  ``shapes`` maps registry ``path_str`` to
    the full (unsplit) leaf shape."""
    rows: list[tuple[str, int, int]] = []
    mesh_div = (plan.mesh.n_devices
                if plan.mesh is not None and plan.mesh.n_devices > 1 else 1)
    for od in plan.registry:
        ratio = plan.op_ratios.get(od.op, 0.0)
        if ratio <= 0.0 or od.path_str not in shapes:
            continue
        dim = shapes[od.path_str][od.axis]
        align_eff = od.align if od.align is not None else align
        align_eff = math.lcm(align_eff, mesh_div)
        _, n_remote = tiering.split_sizes(dim, ratio, align_eff)
        if n_remote:
            rows.append((od.path_str, dim, n_remote))
    return rows


def check_plan(plan: TieringPlan, hw: HardwareSpec, cfg: Any = None,
               shapes: dict[str, tuple[int, ...]] | None = None, *,
               align: int = 1, where: str = "plan") -> list[Finding]:
    """All structural plan checks (DAK201/202/203/205; DAK204 needs a
    realized params tree — see :func:`check_repartition_idempotent`)."""
    extents = realized_extents(plan, shapes, align=align) if shapes else None
    return (check_budget(plan, where=where)
            + check_registry(plan, cfg, where=where)
            + check_window(plan, hw, where=where)
            + check_mesh(plan, hw, extents, where=where))
