"""HuBERT-XLarge — encoder-only (w2v2-family backbone); conv feature
extractor is a STUB per assignment: input_specs() provides precomputed frame
embeddings [arXiv:2106.07447]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504,
    mlp="gelu", norm="layernorm", is_causal=False, frontend="audio_frames",
)
SMOKE = dataclasses.replace(
    CONFIG, name="hubert-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=64,
)
