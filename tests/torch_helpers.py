"""Shared helpers of the PyTorch-port tests (test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU.  Tolerances are the reference's own kernel tolerances
(tests/test_kernels.py): 2e-4 relative in fp32.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

FP32_TOL = 2e-4


def as_np(a) -> np.ndarray:
    """A torch tensor or a JAX array as a float32/int numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (tests/test_kernels.py's measure)."""
    a, b = as_np(a), as_np(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)) if b.size else 0.0


@pytest.fixture
def cuda_device() -> torch.device:
    """The card, for tests marked `gpu`; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run `pytest -m gpu` on the card)")
    return torch.device("cuda")
