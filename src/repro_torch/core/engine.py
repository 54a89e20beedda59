"""OffloadEngine — end-to-end planning (paper §3, Fig. 4).

Given (model config, workload, hardware), the engine:
  1. enumerates the offloadable operations (linear ops carry weights,
     attention ops carry KV cache — paper footnote 2),
  2. computes the memory footprint and the *global* offload ratio
     ``OR = max(0, 1 − HBM_avail / footprint)``,
  3. runs the provably-optimal greedy allocator for per-op ratios,
  4. emits a `TieringPlan` carrying the model family's *operand registry*
     (`models.registry`) alongside the per-op ratios, the KV page budget,
     the congestion window, and the broadcast plan.

``TieringPlan.partition(params)`` is the single entry point that realizes
the plan on a param pytree: every registered operand whose planner op
carries a non-zero ratio becomes a `TieredArray`, split along the axis the
registry declares.  This is the unified path for every model family —
dense, VLM, MoE (expert-stack splits), MLA (latent projections), SSM and
hybrid — replacing the former trio of ``_OP_TO_PARAM``,
``tiering.partition_tree`` path patterns, and the serving-side ``TIERABLE``
list.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.core import congestion, multicast, planner, tiering
from repro_torch.core.hardware import HardwareSpec, MeshSpec, mesh_hardware
from repro_torch.core.ebmodel import OpProfile, WorkloadSpec, attention_op, linear_op
from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import Operand, operand_registry, resolve


@dataclasses.dataclass(frozen=True)
class KVPagePlan:
    """Page-granular KV accounting: the serving cache allocates fixed-size
    pages, so the planner's continuous ``kv_ratio`` must round to a page
    *budget* — ``local_pages`` is the HBM pool size, ``remote_pages`` the
    host pool size; their sum covers the full (batch x max_len) cache."""
    page_size: int                         # tokens per page
    page_bytes: float                      # bytes per page across all layers
    total_pages: int
    local_pages: int
    remote_pages: int

    @property
    def achieved_kv_ratio(self) -> float:
        return self.remote_pages / self.total_pages if self.total_pages else 0.0


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The device axis of a `TieringPlan` (paper §4.3.2 fetch-once-broadcast
    promoted from accounting to the serving path).

    The remote tier is sharded into disjoint 1/P slices, one per chip's
    host link; every stage downstream keys off this record: the partitioner
    rounds remote extents to P-divisible slices, `launch.sharding` places
    them with a `PartitionSpec` on ``axis_name``, the decode path rebuilds
    full operands through ``kernels.ops.broadcast_remote`` inside
    ``shard_map``, and the runtime keeps one congestion window per link.
    """

    n_devices: int
    axis_name: str
    host_link_bw: float                       # one link, B_h (bytes/s)
    aggregate_host_bw: float                  # what the allocator solved on
    link_windows: tuple[congestion.WindowPlan, ...]   # one per host link
    traffic: multicast.AmplificationReport    # fetch-once vs naive oracle

    @property
    def per_link_bytes_multicast(self) -> float:
        """Modeled bytes one chip's host link carries per full read of the
        offloaded weights on the fetch-once path."""
        return self.traffic.traffic_multicast / self.n_devices

    @property
    def per_link_bytes_naive(self) -> float:
        """Same read with naive replication: every chip pulls everything."""
        return self.traffic.traffic_no_multicast / self.n_devices


@dataclasses.dataclass(frozen=True)
class TieringPlan:
    global_ratio: float
    op_ratios: dict[str, float]            # op name -> ratio
    param_ratios: dict[str, float]         # param path ('/'-joined) -> ratio
    kv_ratio: float
    latency: float                         # modelled e2e step latency (s)
    effective_bandwidth: float             # modelled aggregate EB (bytes/s)
    window: congestion.WindowPlan
    broadcast: multicast.BroadcastPlan
    footprint_bytes: float
    ops: tuple[OpProfile, ...] = ()
    kv_pages: KVPagePlan | None = None     # page budget realizing kv_ratio
    registry: tuple[Operand, ...] = ()     # operand registry (models.registry)
    prefill_op_ratios: dict[str, float] | None = None  # prefill-phase solve
    mesh: MeshPlan | None = None           # device axis (None = single chip)

    def partition(self, params: dict[str, Any], *, align: int = 1,
                  place_remote: bool = False) -> dict[str, Any]:
        """Realize the plan on a params pytree (the unified tiering API).

        Every operand in the registry whose planner op carries a non-zero
        offload ratio is split into a `TieredArray` along the registry's
        declared axis; all other leaves pass through untouched, so the
        returned tree has the same structure and flows through
        ``jit``/``scan``/the serving layer loop unchanged.

        ``align`` rounds split extents to kernel-tile multiples (paper §4.1
        execution-wave alignment); a per-operand registry override (e.g.
        MoE expert stacks split whole experts, align 1) takes precedence.
        Operands whose rounded remote extent is zero stay plain arrays.
        The physical split follows the *decode-phase* ratios: a weight can
        only live in one place, and decode is the steady state — prefill
        streams the same remote partitions (see ``prefill_op_ratios`` for
        the prefill-phase accounting solve).  With ``place_remote`` the
        remote tier is pinned to host memory on backends that support it.
        Under a mesh plan every remote extent is additionally rounded to a
        multiple of ``mesh.n_devices`` so the host-resident shard splits
        into equal 1/P slices, one per host link.
        """
        out = _copy_tree(params)
        for od in self.registry:
            ratio = self.op_ratios.get(od.op, 0.0)
            if ratio <= 0.0:
                continue
            leaf = resolve(params, od.path)
            align_eff = od.align if od.align is not None else align
            if self.mesh is not None and self.mesh.n_devices > 1:
                align_eff = math.lcm(align_eff, self.mesh.n_devices)
            _, n_remote = tiering.split_sizes(leaf.shape[od.axis], ratio, align_eff)
            if n_remote == 0:
                continue
            t = tiering.partition(leaf, ratio, axis=od.axis, align=align_eff)
            if place_remote:
                t = tiering.place(t)
            _set_path(out, od.path, t)
        return out


def _copy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree


def _set_path(tree: dict[str, Any], path: tuple[str, ...], value: Any) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def enumerate_ops(cfg: ModelConfig, wl: WorkloadSpec) -> list[OpProfile]:
    """Offloadable ops for one full forward pass, aggregated over layers.

    Aggregation over layers is exact for the EB/latency model (both C and W
    scale linearly in n_layers) and keeps the planner input compact.
    """
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nl = cfg.n_layers
    ops: list[OpProfile] = []

    if cfg.family in ("ssm",):
        d_inner = cfg.ssm_expand * d
        n_heads = d_inner // cfg.ssm_head_dim
        in_w = 2 * d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state + n_heads
        ops.append(linear_op("ssm_in", d, in_w, wl, nl))
        ops.append(linear_op("ssm_out", d_inner, d, wl, nl))
    else:
        n_attn = nl
        if cfg.family == "hybrid" and cfg.hybrid_attn_every:
            n_attn = nl // cfg.hybrid_attn_every
            n_ssm = nl
            d_inner = cfg.ssm_expand * d
            n_heads = d_inner // cfg.ssm_head_dim
            in_w = 2 * d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state + n_heads
            ops.append(linear_op("ssm_in", d, in_w, wl, n_ssm))
            ops.append(linear_op("ssm_out", d_inner, d, wl, n_ssm))
        if cfg.use_mla:
            q_rank = cfg.q_lora_rank or d
            qkv_w = (cfg.q_lora_rank + cfg.kv_lora_rank + cfg.rope_head_dim) + (
                q_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
            ) // d + (cfg.kv_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)) // d
            ops.append(linear_op("attn_qkv", d, qkv_w, wl, n_attn))
            ops.append(linear_op("attn_out", cfg.n_heads * cfg.v_head_dim, d, wl, n_attn))
        elif cfg.family != "ssm":
            qkv_out = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            ops.append(linear_op("attn_qkv", d, qkv_out, wl, n_attn))
            ops.append(linear_op("attn_out", cfg.n_heads * hd, d, wl, n_attn))

        if cfg.family == "moe":
            # Routed experts: weights C = all experts; flops only top_k active.
            e_up = linear_op("moe_experts", d, 3 * cfg.moe_d_ff, wl, nl)
            c_all = e_up.bytes * cfg.n_experts
            w_active = e_up.flops * cfg.top_k
            ops.append(OpProfile("moe_experts", c_all, w_active, "linear"))
            if cfg.n_shared_experts:
                sh = linear_op("moe_shared", d, 3 * cfg.moe_d_ff * cfg.n_shared_experts, wl, nl)
                ops.append(sh)
        elif cfg.family != "ssm":
            mult = 2 if cfg.mlp == "swiglu" else 1
            ops.append(linear_op("mlp_up", d, mult * cfg.d_ff, wl, n_attn))
            ops.append(linear_op("mlp_down", cfg.d_ff, d, wl, n_attn))

        # KV-cache op (decode/prefill only; encoder fwd has no persistent KV).
        if cfg.has_decoder and wl.phase in ("decode", "prefill"):
            if cfg.use_mla:
                # MLA caches the latent (kv_lora + rope) per token, not heads.
                kv_width = cfg.kv_lora_rank + cfg.rope_head_dim
                ops.append(attention_op("attention", 1, kv_width, cfg.n_heads, wl, n_attn))
            else:
                ops.append(attention_op(
                    "attention", cfg.n_kv_heads, hd, cfg.n_heads, wl, n_attn))

    ops.append(linear_op("lm_head", d, cfg.vocab, wl, 1))
    return ops


def kv_cache_bytes(cfg: ModelConfig, wl: WorkloadSpec) -> float:
    if not cfg.has_decoder or cfg.family == "ssm":
        return 0.0
    n_attn = cfg.n_layers
    if cfg.family == "hybrid" and cfg.hybrid_attn_every:
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
    if cfg.use_mla:
        per_tok = cfg.kv_lora_rank + cfg.rope_head_dim
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
    return float(wl.batch) * wl.seq_len * per_tok * wl.dtype_bytes * n_attn


def kv_page_plan(
    cfg: ModelConfig, wl: WorkloadSpec, kv_ratio: float, page_size: int = 16
) -> KVPagePlan | None:
    """Map the planner's continuous ``kv_ratio`` onto a page budget.

    ``remote_pages = round(kv_ratio * total)`` with the guarantee (when the
    pool has more than one page) that a non-zero ratio yields at least one
    remote page — so the remote tier is actually exercised — and a sub-1.0
    ratio keeps at least one local page.  A single-page pool cannot satisfy
    both, so it simply rounds: the page goes remote iff kv_ratio >= 0.5."""
    if page_size <= 0:
        raise ValueError(f"kv page_size must be positive, got {page_size}")
    total_bytes = kv_cache_bytes(cfg, wl)
    if total_bytes <= 0:
        return None
    pages_per_seq = -(-wl.seq_len // page_size)
    total = wl.batch * pages_per_seq
    per_tok = total_bytes / (wl.batch * wl.seq_len)
    remote = int(round(kv_ratio * total + 1e-9))
    if total > 1:
        if kv_ratio > 0:
            remote = max(1, remote)
        if kv_ratio < 1:
            remote = min(total - 1, remote)
    remote = max(0, min(total, remote))
    return KVPagePlan(
        page_size=page_size,
        page_bytes=per_tok * page_size,
        total_pages=total,
        local_pages=total - remote,
        remote_pages=remote,
    )


def plan(
    cfg: ModelConfig,
    wl: WorkloadSpec,
    hw: HardwareSpec,
    hbm_budget_bytes: float | None = None,
    global_ratio: float | None = None,
    pod_chips: int = 1,
    dma_chunk_bytes: int = 512 * 1024,
    kv_page_size: int = 16,
    mesh: MeshSpec | None = None,
) -> TieringPlan:
    """Full DAK planning pass. Either give an HBM budget (paper Fig. 10 mode)
    or pin the global ratio directly (paper Fig. 8/9 sweep mode).

    With a ``mesh`` the plan gains its device axis: the greedy allocator
    solves against the *aggregate* of the mesh's P host links
    (`hardware.mesh_hardware` — each chip pulls a disjoint 1/P slice of
    every host-resident shard, rebuilt over ICI), the congestion window is
    solved once per link, and ``plan.mesh`` carries the fetch-once traffic
    oracle the serving engine accounts against.  ``hw`` stays the per-chip
    spec; per-chip HBM is unchanged (local partitions replicate), so the
    HBM-budget mode still prices a single chip's budget.
    """
    n_dev = mesh.n_devices if mesh is not None else 1
    ops = enumerate_ops(cfg, wl)
    weights = cfg.param_count() * wl.dtype_bytes
    kv = kv_cache_bytes(cfg, wl)
    footprint = weights + kv
    if global_ratio is None:
        budget = hbm_budget_bytes if hbm_budget_bytes is not None else hw.hbm.capacity
        global_ratio = planner.global_offload_ratio(footprint, budget * pod_chips)
    hw_solve = mesh_hardware(hw, n_dev) if n_dev > 1 else hw
    sol = planner.solve(ops, global_ratio, hw_solve)
    op_ratios = {op.name: r for op, r in zip(ops, sol.ratios, strict=True)}

    # The congestion window paces one chip's host link, so it is solved on
    # the per-link model whatever the mesh size; a mesh simply gets one
    # (structurally independent) window per link.
    cong = congestion.CongestionModel(hw)
    window = congestion.optimal_window(
        cong, n_streams=max(1, pod_chips), chunk_bytes=dma_chunk_bytes)
    host_bytes = sum(op.bytes * r for op, r in zip(ops, sol.ratios, strict=True))
    bcast = multicast.plan_broadcast(
        host_bytes=host_bytes,
        group_size=n_dev if n_dev > 1 else pod_chips,
        pcie_bw=hw.host.bandwidth,
        ici_bw_per_chip=hw.ici_link_bw * max(1, hw.ici_links) or hw.host.bandwidth,
    )
    mesh_plan: MeshPlan | None = None
    if mesh is not None:
        # Links are identical in the analytical model: one single-stream
        # window solve covers them all (the runtime still adapts each link
        # independently from its own seed).
        link_window = congestion.optimal_window(
            cong, n_streams=1, chunk_bytes=dma_chunk_bytes)
        mesh_plan = MeshPlan(
            n_devices=n_dev,
            axis_name=mesh.axis_name,
            host_link_bw=hw.host.bandwidth,
            aggregate_host_bw=hw_solve.host.bandwidth,
            link_windows=(link_window,) * n_dev,
            traffic=multicast.sharded_fetch_report(host_bytes, n_dev),
        )
    total_c = sum(op.bytes for op in ops)
    kv_ratio = op_ratios.get("attention", 0.0)
    registry = operand_registry(cfg)

    # Prefill-phase solve (paper: per-phase boundness => per-phase ratios).
    # The physical weight split realizes the decode ratios (see
    # TieringPlan.partition); the prefill solve prices streaming the same
    # remote partitions during the compute-bound prefill phase.
    prefill_op_ratios: dict[str, float] | None = None
    if wl.phase == "decode" and cfg.has_decoder:
        ops_pre = enumerate_ops(cfg, dataclasses.replace(wl, phase="prefill"))
        sol_pre = planner.solve(ops_pre, global_ratio, hw_solve)
        prefill_op_ratios = {
            op.name: r for op, r in zip(ops_pre, sol_pre.ratios, strict=True)}

    return TieringPlan(
        global_ratio=global_ratio,
        op_ratios=op_ratios,
        param_ratios={
            od.path_str: op_ratios[od.op] for od in registry if od.op in op_ratios
        },
        kv_ratio=kv_ratio,
        latency=sol.latency,
        effective_bandwidth=total_c / sol.latency if sol.latency > 0 else 0.0,
        window=window,
        broadcast=bcast,
        footprint_bytes=footprint,
        ops=tuple(ops),
        kv_pages=kv_page_plan(cfg, wl, kv_ratio, page_size=kv_page_size),
        registry=registry,
        prefill_op_ratios=prefill_op_ratios,
        mesh=mesh_plan,
    )
