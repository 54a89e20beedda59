"""Optimizers."""
from repro_torch.optim import adamw
__all__ = ["adamw"]
