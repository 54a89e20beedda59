"""StarCoder2-3B — GQA(kv=2), RoPE, GELU MLP, LayerNorm+bias [arXiv:2402.19173]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab=49152,
    rope_theta=1e5, mlp="gelu", norm="layernorm", qkv_bias=True,
)
SMOKE = dataclasses.replace(
    CONFIG, name="starcoder2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=128,
)
