"""Model configuration schema shared by every architecture in the zoo."""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encoder", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 => d_model // n_heads

    # attention flavor
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0        # chatglm3 "2d RoPE": rotary on half the head dim
    qk_norm: bool = False             # qwen3
    qkv_bias: bool = False            # qwen2.5 / starcoder2
    attn_logit_softcap: float = 0.0

    # MLP flavor
    mlp: Literal["swiglu", "gelu"] = "swiglu"

    # MoE (family == "moe")
    moe_capacity_factor: float = 1.5
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert FFN width (d_ff used for dense/shared)

    # MLA (deepseek-v2): latent-compressed KV
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0            # decoupled RoPE dims per head
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (family in {"ssm","hybrid"})
    ssm_state: int = 0
    ssm_chunk: int = 64               # SSD chunk length (perf knob, §Perf A1)
    ssm_n_groups: int = 1
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64

    # hybrid (zamba2): 1 shared attention+MLP block applied every k layers
    hybrid_attn_every: int = 0        # 0 => pure ssm
    hybrid_shared_blocks: int = 0

    # encoder-only (hubert) / vlm frontend stubs
    is_causal: bool = True
    frontend: Literal["none", "audio_frames", "vision_patches"] = "none"

    # misc
    tie_embeddings: bool = False
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # sub-quadratic? (drives long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # Query heads are padded to a multiple of the production model-axis size
    # (16) with zero-initialized weights — numerically exact, and lets GSPMD
    # shard attention for archs like starcoder2 (24H) / qwen2.5 (40H) whose
    # head counts don't divide the TP degree (Megatron-style padding).
    tp_head_multiple: int = 16

    @property
    def padded_heads(self) -> int:
        m = self.tp_head_multiple
        # keep padded count a multiple of n_kv_heads for group-major GQA
        base = max(self.n_heads, self.n_kv_heads)
        k = self.n_kv_heads or 1
        padded = -(-base // m) * m
        while padded % k:
            padded += m
        return padded

    @property
    def has_decoder(self) -> bool:
        return self.family != "encoder"

    def param_count(self) -> float:
        """Approximate parameter count N (for 6ND model-flops accounting)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0.0
        if self.family in ("ssm",):
            per_layer = self._ssm_layer_params()
        elif self.family == "hybrid":
            per_layer = self._ssm_layer_params()
        else:
            per_layer = self._attn_params() + self._mlp_params()
        total = emb + self.n_layers * per_layer
        if self.family == "hybrid" and self.hybrid_shared_blocks:
            total += self.hybrid_shared_blocks * (self._attn_params() + self._mlp_params())
        return float(total)

    def active_param_count(self) -> float:
        """Active params per token (== param_count for dense)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        active_ffn = 3 * d * self.moe_d_ff * (self.top_k + self.n_shared_experts)
        router = d * self.n_experts
        per_layer = self._attn_params() + active_ffn + router
        return float(emb + self.n_layers * per_layer)

    def _attn_params(self) -> float:
        d, hd = self.d_model, self.resolved_head_dim
        if self.use_mla:
            rd, nd, vd = self.rope_head_dim, self.nope_head_dim, self.v_head_dim
            q_in = self.q_lora_rank or d
            q = (d * self.q_lora_rank if self.q_lora_rank else 0) + q_in * self.n_heads * (nd + rd)
            kv = d * (self.kv_lora_rank + rd) + self.kv_lora_rank * self.n_heads * (nd + vd)
            o = self.n_heads * vd * d
            return q + kv + o
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _mlp_params(self) -> float:
        d = self.d_model
        if self.family == "moe":
            expert = 3 * d * self.moe_d_ff
            return (self.n_experts + self.n_shared_experts) * expert + d * self.n_experts
        mult = 3 if self.mlp == "swiglu" else 2
        return mult * d * self.d_ff

    def _ssm_layer_params(self) -> float:
        d = self.d_model
        d_inner = self.ssm_expand * d
        n_heads = d_inner // self.ssm_head_dim
        in_proj = d * (2 * d_inner + 2 * self.ssm_n_groups * self.ssm_state + n_heads)
        out_proj = d_inner * d
        conv = self.ssm_conv_width * (d_inner + 2 * self.ssm_n_groups * self.ssm_state)
        return in_proj + out_proj + conv + 2 * n_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    step: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment skip rules. Returns (runnable, reason-if-skipped)."""
    if shape.step == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention (pure full-attention arch)"
    return True, ""
