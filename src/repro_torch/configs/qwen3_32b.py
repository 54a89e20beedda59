"""Qwen3-32B — GQA(kv=8), qk-norm, head_dim=128, SwiGLU [hf:Qwen/Qwen3-32B]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=25600, vocab=151936,
    rope_theta=1e6, qk_norm=True,
)
SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
)
