"""OPT-6.7B (paper model)."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="opt-6.7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=16384, vocab=50272,
    mlp="gelu", norm="layernorm",
)
SMOKE = dataclasses.replace(
    CONFIG, name="opt6.7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=128,
)
