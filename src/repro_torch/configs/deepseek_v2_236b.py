"""DeepSeek-V2 236B — MLA (kv_lora=512, decoupled RoPE 64), MoE 160 routed
top-6 + 2 shared experts [arXiv:2405.04434]."""
import dataclasses
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv_heads=128, d_ff=12288, vocab=102400,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
)
SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-v2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, vocab=128, kv_lora_rank=32, q_lora_rank=48,
    rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
    n_experts=8, n_shared_experts=2, top_k=2, moe_d_ff=32, d_ff=64,
)
