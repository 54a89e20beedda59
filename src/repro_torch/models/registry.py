"""Operand registry — the single source of truth mapping planner ops to
param leaves (the unified tiering API's schema layer).

DAK's planner (`core/engine.enumerate_ops`) reasons about *operations*
(``attn_qkv``, ``moe_experts``, ...); the model zoo stores *parameters*
(``params["layers"]["wq"]``, ...).  Historically three disjoint surfaces
bridged the two — ``core.engine._OP_TO_PARAM``, ``tiering.partition_tree``'s
path patterns, and ``serving.tiered_decode.TIERABLE`` — each with its own
subset of families and its own bugs (the TIERABLE shim reused the ``wq``
ratio for ``wkv``).  This registry replaces all three: each model family
declares, next to its param layout (`models/model.py` ``init_params``), which
leaves realize which planner op and along which axis they split across the
(HBM, host) tiers.

Conventions:

* ``path`` indexes the *stacked* params tree from ``init_params``
  (``("layers", "wq")`` is the ``[n_layers, d, N]`` weight stack).
* ``axis`` is **negative** so the same spec is valid for the stacked leaf
  and for the per-layer slice that ``jax.lax.scan`` / the serving layer
  loop sees: dropping the leading layer axis leaves a negative axis
  pointing at the same dimension.  Column-split weights use ``-1``
  (the GEMM N dimension — paper §4.1 Fig. 5a); MoE expert stacks split
  along the expert axis ``-3`` (whole experts are homed per tier).
* Only weights a tier-aware matmul/einsum can consume are registered.
  MLA's ``wkv_b`` is intentionally *not* registered: decode consumes it in
  absorbed-einsum form (`layers.mla_decode`), so it stays HBM-resident.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Operand:
    """One tierable param leaf: which planner op prices it, where it lives
    in the params tree, and how it splits across tiers."""

    op: str                        # planner op name (core.engine.enumerate_ops)
    path: tuple[str, ...]          # key path into the init_params tree
    axis: int = -1                 # split axis (negative; see module docstring)
    align: int | None = None       # alignment override (None -> partitioner default)

    @property
    def path_str(self) -> str:
        return "/".join(self.path)


def operand_registry(cfg: ModelConfig) -> tuple[Operand, ...]:
    """The tierable operands of `cfg`'s family, in params-tree order."""
    out: list[Operand] = []

    def layer(key: str, op: str, axis: int = -1, align: int | None = None) -> None:
        out.append(Operand(op, ("layers", key), axis, align))

    if cfg.family in ("ssm", "hybrid"):
        for key in ("z_proj", "x_proj", "bc_proj", "dt_proj"):
            layer(key, "ssm_in")
        layer("ssm_out", "ssm_out")
        if cfg.family == "hybrid" and cfg.hybrid_attn_every:
            # Zamba2-style shared attention+MLP blocks (stacked over blocks).
            for key, op in (("wq", "attn_qkv"), ("wkv", "attn_qkv"),
                            ("wo", "attn_out"), ("wi", "mlp_up"),
                            ("wdown", "mlp_down")):
                out.append(Operand(op, ("shared", key)))
    else:
        if cfg.use_mla:
            if cfg.q_lora_rank:
                layer("wq_a", "attn_qkv")
            layer("wq_b", "attn_qkv")
            layer("wkv_a", "attn_qkv")
            # wkv_b: absorbed at decode (einsum over the latent) — resident.
            layer("wo", "attn_out")
        else:
            layer("wq", "attn_qkv")
            layer("wkv", "attn_qkv")
            layer("wo", "attn_out")
        if cfg.family == "moe":
            layer("experts_wi", "moe_experts", axis=-3, align=1)
            layer("experts_wdown", "moe_experts", axis=-3, align=1)
            if cfg.n_shared_experts:
                layer("shared_wi", "moe_shared")
                layer("shared_wdown", "moe_shared")
        else:
            layer("wi", "mlp_up")
            layer("wdown", "mlp_down")

    if not cfg.tie_embeddings:
        out.append(Operand("lm_head", ("lm_head",)))
    return tuple(out)


def resolve(params: dict[str, Any], path: tuple[str, ...]) -> Any:
    """Fetch the leaf at `path`, raising a helpful error when absent."""
    node: Any = params
    for key in path:
        try:
            node = node[key]
        except (KeyError, TypeError) as exc:
            raise KeyError(
                f"operand path {'/'.join(path)} does not resolve in the "
                f"params tree (missing {key!r})") from exc
    return node


def registered_ops(registry: tuple[Operand, ...]) -> frozenset[str]:
    return frozenset(od.op for od in registry)
