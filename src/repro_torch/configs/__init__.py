"""Architecture configs: the 10 assigned archs + the paper's own models.

Each assigned arch gets its own module (``repro/configs/<id>.py``) exporting
``CONFIG`` (exact assigned dims) and ``SMOKE`` (a reduced same-family config
for CPU smoke tests). ``get(name)`` resolves either.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, cell_applicable

ARCH_IDS = [
    "starcoder2_3b",
    "qwen2p5_14b",
    "chatglm3_6b",
    "qwen3_32b",
    "llava_next_34b",
    "mamba2_370m",
    "deepseek_v2_236b",
    "qwen3_moe_30b_a3b",
    "hubert_xlarge",
    "zamba2_2p7b",
]

PAPER_IDS = ["opt_30b", "opt_6p7b", "llama2_7b"]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS + PAPER_IDS}


def get(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ALIAS.get(name, name)}")
    return mod.CONFIG


def get_smoke(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_ALIAS.get(name, name)}")
    return mod.SMOKE


__all__ = ["ARCH_IDS", "PAPER_IDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "cell_applicable", "get", "get_smoke"]
