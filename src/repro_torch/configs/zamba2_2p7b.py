"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks every 6 layers
(2 alternating shared blocks) [arXiv:2411.15242]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, d_ff=10240, vocab=32000,
    ssm_state=64, ssm_n_groups=1, ssm_conv_width=4, ssm_expand=2,
    ssm_head_dim=64, hybrid_attn_every=6, hybrid_shared_blocks=2,
)
SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=128, ssm_state=16, ssm_head_dim=16,
    hybrid_attn_every=2, hybrid_shared_blocks=2,
)
