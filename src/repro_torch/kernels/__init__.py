"""Direct-access kernels (CUDA sources in csrc/) and their plain versions,
plus causal flash-prefill attention."""
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.ops import (
    paged_decode_attention,
    tiered_decode_attention,
    tiered_matmul,
)

__all__ = ["flash_prefill", "paged_decode_attention", "tiered_decode_attention",
           "tiered_matmul"]
