"""The work a configuration's steps need, from its published shapes: the
benchmark's own arithmetic behind every roofline and utilization metric.

Counted from the configuration and mix files alone, never from the
program's tensors or its plan.  Each byte of weight or cache that a step
needs is counted once, each product as 2 FLOPs a multiply-add; attention
counts QK^T and PV over the context.  The share of the weights that lies
across the host link is the one the HBM budget forces (`offload_ratio`),
whatever split the program chooses.
"""
from __future__ import annotations

from bench import peaks
from bench.weights import head_dim

ELEM_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def elem_bytes(model: dict) -> int:
    return ELEM_BYTES[model.get("dtype", "bfloat16")]


def attn_params(model: dict) -> int:
    """Q, K, V and O projections of one layer."""
    d, h, kh, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], head_dim(model)
    return d * h * hd + 2 * d * kh * hd + h * hd * d


def mlp_params(model: dict) -> int:
    """The dense MLP of one layer (two matrices, three for SwiGLU)."""
    return (3 if model.get("mlp") == "swiglu" else 2) * model["d_model"] * model["d_ff"]


def expert_params(model: dict) -> int:
    """One SwiGLU expert: gate, up and down."""
    return 3 * model["d_model"] * model["moe_d_ff"]


def head_params(model: dict) -> int:
    return model["d_model"] * model["vocab"]


def layer_gemm_params(model: dict) -> int:
    """The dense weights of one layer that the tiered GEMM multiplies: the
    attention projections, and the MLP of a dense model."""
    return attn_params(model) + (0 if model["family"] == "moe" else mlp_params(model))


def dense_gemm_params(model: dict) -> int:
    """The weights every decode step's tiered GEMM reads: each layer's, and
    an lm_head of its own (a tied head multiplies the embedding)."""
    head = 0 if model.get("tie_embeddings") else head_params(model)
    return model["n_layers"] * layer_gemm_params(model) + head


def weight_params(model: dict) -> int:
    """Every matrix of the model: the layers (all experts and the router of
    a MoE), the embedding and an untied lm_head."""
    if model["family"] == "moe":
        ffn = model["d_model"] * model["n_experts"] + model["n_experts"] * expert_params(model)
    else:
        ffn = mlp_params(model)
    heads = 1 if model.get("tie_embeddings") else 2
    return model["n_layers"] * (attn_params(model) + ffn) + heads * head_params(model)


def experts_reached(model: dict, rows: int) -> float:
    """Distinct experts a layer runs for `rows` tokens routed uniformly to
    their top k: n (1 - (1 - k/n)^rows)."""
    n, k = model["n_experts"], model["top_k"]
    return n * (1 - (1 - k / n) ** rows)


def step_weight_params(model: dict, rows: int) -> float:
    """Weights one decode step of `rows` rows reads: every layer's dense
    weights and, of a MoE, its router and the experts its rows reach; the
    lm_head (or the tied embedding it multiplies)."""
    per_layer = layer_gemm_params(model)
    if model["family"] == "moe":
        per_layer += (model["d_model"] * model["n_experts"]
                      + experts_reached(model, rows) * expert_params(model))
    return model["n_layers"] * per_layer + head_params(model)


def kv_pool_bytes(model: dict, mix: dict) -> int:
    """The KV cache the engine holds: every client's slot at ``max_len``."""
    return mix["clients"] * mix["max_len"] * kv_bytes_per_token(model)


def offload_ratio(model: dict, mix: dict) -> float:
    """The share of weights and cache that the mix's HBM budget (in bytes,
    as the harness resolves it) cannot hold: max(0, 1 - HBM / footprint),
    the paper's global offload ratio, as ``src/repro_torch/core/planner.py``
    (`global_offload_ratio`) writes it."""
    budget = mix["engine"]["hbm_budget_bytes"]
    footprint = weight_params(model) * elem_bytes(model) + kv_pool_bytes(model, mix)
    return max(0.0, 1.0 - budget / footprint)


def layer_active_params(model: dict) -> int:
    """Weights one token multiplies through one layer: attention, then the
    router and its top-k experts, or the dense MLP."""
    if model["family"] == "moe":
        ffn = model["d_model"] * model["n_experts"] + model["top_k"] * expert_params(model)
    else:
        ffn = mlp_params(model)
    return attn_params(model) + ffn


def attn_flops(model: dict, ctx: int) -> int:
    """QK^T and PV of one query over `ctx` keys, all layers."""
    return model["n_layers"] * 4 * model["n_heads"] * head_dim(model) * ctx


def decode_flops(model: dict, ctxs: list[int]) -> int:
    """One decode step over rows attending `ctxs` tokens each."""
    per_row = 2 * (model["n_layers"] * layer_active_params(model) + head_params(model))
    return per_row * len(ctxs) + sum(attn_flops(model, c) for c in ctxs)


def prefill_flops(model: dict, t: int) -> int:
    """A whole prompt of `t` tokens, causal, lm_head at its last position."""
    layers = 2 * t * model["n_layers"] * layer_active_params(model)
    causal = model["n_layers"] * 4 * model["n_heads"] * head_dim(model) * (t * (t + 1) // 2)
    return layers + causal + 2 * head_params(model)


def split_bound_s(nbytes: float, ratio: float, flops: float) -> float:
    """`bound_s` of `nbytes` of which the share `ratio` lies across the link."""
    return bound_s(nbytes * (1 - ratio), nbytes * ratio, flops)


def kv_bytes_per_token(model: dict) -> int:
    """K and V of one token over all layers."""
    return model["n_layers"] * 2 * model["n_kv_heads"] * head_dim(model) * elem_bytes(model)


def bound_s(local_bytes: float, remote_bytes: float, flops: float) -> float:
    """The least time the chip could take: HBM and the host link read at
    once, each at its peak, beside the tensor cores at theirs."""
    return max(local_bytes / peaks.HBM_BYTES_S, remote_bytes / peaks.LINK_BYTES_S,
               flops / peaks.BF16_FLOPS)
