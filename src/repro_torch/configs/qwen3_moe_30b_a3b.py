"""Qwen3-30B-A3B — 128 routed experts top-8, GQA(kv=4), qk-norm
[hf:Qwen/Qwen3-30B-A3B]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab=151936,
    rope_theta=1e6, qk_norm=True,
    n_experts=128, n_shared_experts=0, top_k=8, moe_d_ff=768,
)
SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, vocab=128, n_experts=8, top_k=2,
    moe_d_ff=32, d_ff=32,
)
