"""Deterministic synthetic data pipeline.

Produces seeded, reproducible batches for any architecture family — token
LM batches, audio-frame batches (encoder), or token+patch batches (VLM).
The iterator state is a single integer step, so checkpoint/restore and
elastic re-sharding are trivial: every host computes the full global batch
deterministically and slices its shard (no inter-host data service needed
at this scale; swap `_global_batch` for a real loader in production).

Documents are "packed": sequences are segmented by EOS tokens drawn with
probability 1/mean_doc_len, mimicking packed-LM pretraining streams.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import AUDIO_FRAME_DIM, VISION_EMBED_DIM


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class SyntheticPipeline:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeConfig,
        seed: int = 0,
        mean_doc_len: int = 512,
        eos_id: int = 2,
    ):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.mean_doc_len = mean_doc_len
        self.eos_id = eos_id
        self.state = PipelineState()

    # -- deterministic batch for a given step ------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng((self.seed << 32) ^ step)
        b, t = shape.global_batch, shape.seq_len
        if cfg.family == "encoder":
            frames = rng.standard_normal((b, t, AUDIO_FRAME_DIM), dtype=np.float32)
            labels = rng.integers(0, cfg.vocab, (b, t), dtype=np.int32)
            return {"frames": frames, "labels": labels}
        tokens = rng.integers(3, cfg.vocab, (b, t), dtype=np.int32)
        # packed documents: EOS boundaries
        eos = rng.random((b, t)) < (1.0 / self.mean_doc_len)
        tokens = np.where(eos, self.eos_id, tokens)
        if cfg.family == "vlm":
            t_img = t // 2
            patches = rng.standard_normal((b, t_img, VISION_EMBED_DIM),
                                          dtype=np.float32)
            labels = np.concatenate(
                [np.full((b, t_img), -0, dtype=np.int32), tokens[:, t_img:]], axis=1)
            return {"tokens": tokens[:, : t - t_img], "patches": patches,
                    "labels": labels}
        labels = np.roll(tokens, -1, axis=1)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.state.step)
            self.state.step += 1

    # -- checkpoint integration --------------------------------------------
    def snapshot(self) -> dict:
        return {"step": self.state.step, "seed": self.seed}

    def restore(self, snap: dict) -> None:
        self.state.step = int(snap["step"])
        self.seed = int(snap.get("seed", self.seed))
