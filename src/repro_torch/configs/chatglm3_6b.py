"""ChatGLM3-6B — GQA(kv=2), 2d/partial RoPE (half head dim), QKV bias
[arXiv:2406.12793]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024,
    rope_fraction=0.5, qkv_bias=True,
)
SMOKE = dataclasses.replace(
    CONFIG, name="chatglm3-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=128,
)
