"""Llama-2-7B (paper model) [arXiv:2307.09288]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab=32000,
)
SMOKE = dataclasses.replace(
    CONFIG, name="llama2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=128,
)
