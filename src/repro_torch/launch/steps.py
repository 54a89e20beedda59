"""Prefill and decode step functions and their inputs.

Counterpart of the inference half of ``src/repro/launch/steps.py``: the
step makers close over a config and take ``mm``, the tier-aware matmul (the
plain per-tier product by default, or the direct-access kernel as the
serving engine passes it), so a step runs over tiered weights.  For the
encoder, which has no decode step, "prefill" is the whole forward pass:
`make_prefill_step` is the encoder's entry point.  Where the reference's
`input_specs` returns shape stand-ins, the port's draws real tensors from a
`torch.Generator`.  The training step waits for the training stack.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig, mm: L.Matmul = L.matmul) -> Callable:
    """``step(params, batch)``: (logits, cache) of `models.prefill`; for the
    encoder, (the logits of `models.forward` at every position, {})."""
    if not cfg.has_decoder:
        def encoder_step(params, batch):
            return M.forward(cfg, params, batch, mm=mm), {}
        return encoder_step

    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, mm=mm)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mm: L.Matmul = L.matmul) -> Callable:
    """``step(params, cache, tokens, pos)``: one `models.decode_step`."""
    def decode_fn(params, cache, tokens, pos):
        return M.decode_step(cfg, params, cache, tokens, pos, mm=mm)
    return decode_fn


def input_specs(cfg: ModelConfig, shape: ShapeConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict[str, Any]:
    """The inputs of a prefill or decode step at `shape`, drawn from
    `generator` (on `device`): the encoder's frame embeddings ``frames``
    [B, T, AUDIO_FRAME_DIM]; a VLM's ``tokens`` [B, T - T/2] after its patch
    embeddings ``patches`` [B, T/2, VISION_EMBED_DIM]; every other family's
    ``tokens`` [B, T].  Embeddings are N(0, 1) in `dtype`, tokens uniform
    over the vocabulary.  A decode step takes one token a row and ``pos``,
    the last position of a seq_len-deep cache."""
    b, t = shape.global_batch, shape.seq_len

    def tokens(n):
        return torch.randint(0, cfg.vocab, (b, n), generator=generator, device=device,
                             dtype=torch.int32)

    def embeddings(n, width):
        return torch.randn((b, n, width), generator=generator, device=device).to(dtype)

    if shape.step == "train":
        raise NotImplementedError("the training step is not ported yet")
    if shape.step == "prefill":
        if cfg.family == "encoder":
            return {"frames": embeddings(t, M.AUDIO_FRAME_DIM)}
        if cfg.family == "vlm":
            t_img = t // 2
            return {"tokens": tokens(t - t_img),
                    "patches": embeddings(t_img, M.VISION_EMBED_DIM)}
        return {"tokens": tokens(t)}
    return {"tokens": tokens(1), "pos": t - 1}
