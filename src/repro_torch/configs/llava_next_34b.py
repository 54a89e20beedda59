"""LLaVA-NeXT-34B backbone (Yi-34B-class LM) — anyres vision frontend is a
STUB per assignment: input_specs() provides precomputed patch embeddings
[hf:llava-hf/llava-v1.6-34b-hf]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab=64000,
    rope_theta=5e6, frontend="vision_patches",
)
SMOKE = dataclasses.replace(
    CONFIG, name="llava-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=128,
)
