"""Mamba2-370M — attention-free SSD [arXiv:2405.21060]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280, head_dim=64,
    ssm_state=128, ssm_n_groups=1, ssm_conv_width=4, ssm_expand=2,
    ssm_head_dim=64,
)
SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab=128,
    ssm_state=16, ssm_head_dim=16,
)
