"""OPT-30B (paper's primary model). OPT uses learned absolute positions;
we substitute RoPE (positional scheme is irrelevant to offload economics —
DESIGN.md §2)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="opt-30b", family="dense", n_layers=48, d_model=7168,
    n_heads=56, n_kv_heads=56, d_ff=28672, vocab=50272,
    mlp="gelu", norm="layernorm",
)
SMOKE = dataclasses.replace(
    CONFIG, name="opt30b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=128,
)
