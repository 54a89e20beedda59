"""Qwen2.5-14B — GQA(kv=8), QKV bias, SwiGLU, RMSNorm [hf:Qwen/Qwen2.5-14B]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=13824, vocab=152064,
    rope_theta=1e6, qkv_bias=True,
)
SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=128,
)
