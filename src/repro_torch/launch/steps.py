"""Train, prefill and decode step functions and their inputs.

Counterpart of ``src/repro/launch/steps.py``.  The train step runs the
plain products and the plain attention that the reference runs outside any
Pallas kernel: `make_loss_and_grads` is one backward pass over leaf tensors
(remat on by default, microbatches strided into an fp32 accumulator), and
`make_train_step` adds `optim.adamw.update`.  The compressed data-parallel
step runs one rank of a `launch.mesh.Mesh` over ``torch.distributed``.

The inference step makers close over a config and take ``mm``, the
tier-aware matmul (the plain per-tier product by default, or the
direct-access kernel as the serving engine passes it), so a step runs over
tiered weights.  For the encoder, which has no decode step, "prefill" is
the whole forward pass: `make_prefill_step` is the encoder's entry point.
Where the reference's `input_specs` returns shape stand-ins, the port's
draws real tensors from a `torch.Generator`.

Not ported here: the dry run's ``grad_specs`` (a no-op without a mesh in
the reference) and the ``eval_shape`` helpers (`cache_shapes`,
`params_shapes`, `opt_shapes`).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import tree_map


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over every position of logsumexp - the gold logit, in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def _value_and_grad(cfg: ModelConfig, params: Any, batch: dict[str, torch.Tensor],
                    remat: bool) -> tuple[torch.Tensor, Any]:
    """(loss, grads) of one backward pass: every leaf a detached view of the
    parameter that requires grad, gradients in the parameters' dtype (zeros
    where the loss does not reach a leaf)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        # Encoder/VLM logits cover the full (frame/patch+token) sequence;
        # labels are provided at matching length by the pipeline.
        loss = cross_entropy(M.forward(cfg, leaves, batch, remat=remat), batch["labels"])
        loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), leaves)
    return loss.detach(), grads


def make_loss_and_grads(cfg: ModelConfig, num_microbatches: int = 1,
                        remat: bool = True) -> Callable:
    """``fn(params, batch) -> (loss, grads)``, the train step before the
    optimizer.  With more than one microbatch, microbatch i takes rows {i,
    i + n, ...} (the reference's strided split, which keeps every data
    shard in every microbatch); their losses and fp32 gradients are summed
    and scaled by 1/n."""
    n = num_microbatches

    def loss_and_grads(params, batch):
        if n == 1:
            return _value_and_grad(cfg, params, batch, remat)
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} microbatches")
        loss = torch.zeros((), dtype=torch.float32, device=batch["labels"].device)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params)
        for i in range(n):
            l, g = _value_and_grad(cfg, params, {k: v[i::n] for k, v in batch.items()}, remat)
            loss = loss + l
            tree_map(lambda a, gi: a.add_(gi.float()), acc, g)
            del g
        inv = 1.0 / n
        return loss * inv, tree_map(lambda a: a.mul_(inv), acc)

    return loss_and_grads


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    num_microbatches: int = 1,
    remat: bool = True,
) -> Callable:
    """``step(params, opt_state, batch) -> (loss, params, opt_state, gnorm)``;
    params and the moments are updated in place."""
    loss_and_grads = make_loss_and_grads(cfg, num_microbatches, remat)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        params, opt_state, gnorm = adamw.update(params, grads, opt_state, opt_cfg)
        return loss, params, opt_state, gnorm

    return train_step


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
    over the vocabulary.  A train step adds ``labels`` [B, T] over the whole
    sequence.  A decode step takes one token a row and ``pos``, the last
    position of a seq_len-deep cache."""
    b, t = shape.global_batch, shape.seq_len

    def tokens(n):
        return torch.randint(0, cfg.vocab, (b, n), generator=generator, device=device,
                             dtype=torch.int32)

    def embeddings(n, width):
        return torch.randn((b, n, width), generator=generator, device=device).to(dtype)

    if shape.step == "train":
        if cfg.family == "encoder":
            return {"frames": embeddings(t, M.AUDIO_FRAME_DIM), "labels": tokens(t)}
        if cfg.family == "vlm":
            t_img = t // 2
            return {"tokens": tokens(t - t_img),
                    "patches": embeddings(t_img, M.VISION_EMBED_DIM), "labels": tokens(t)}
        return {"tokens": tokens(t), "labels": tokens(t)}
    if shape.step == "prefill":
        if cfg.family == "encoder":
            return {"frames": embeddings(t, M.AUDIO_FRAME_DIM)}
        if cfg.family == "vlm":
            t_img = t // 2
            return {"tokens": tokens(t - t_img),
                    "patches": embeddings(t_img, M.VISION_EMBED_DIM)}
        return {"tokens": tokens(t)}
    return {"tokens": tokens(1), "pos": t - 1}


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig, n_data: int) -> int:
    """Size grad-accumulation so per-chip layer-boundary activations stay
    under ~2 GB: bytes ≈ B_local · T · d · 2 · n_layers."""
    if shape.step != "train":
        return 1
    b_local = max(1, shape.global_batch // n_data)
    boundary = b_local * shape.seq_len * cfg.d_model * 2 * cfg.n_layers
    budget = 2e9
    mb = 1
    while boundary / mb > budget and mb < b_local:
        mb *= 2
    return mb


# --------------------------------------------------------------------------
# Distributed-optimization variant: an explicit data-parallel train step
# with int8-compressed gradient all-reduce + error feedback
# (distributed.collectives).  4x less gradient traffic per step; the
# residual carries the quantization error into the next step.
# --------------------------------------------------------------------------
def make_dp_train_step_compressed(
    cfg: ModelConfig,
    mesh,
    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    axis: str = "data",
) -> Callable:
    """``step(params, opt_state, residual, batch) -> (loss, params,
    opt_state, residual, gnorm)`` on this rank of `mesh` (every rank calls
    it with the same global batch and replicated state): the rank takes its
    contiguous block of the batch (the reference's ``P(axis, None)``),
    compresses its gradients with error feedback, sums them over `axis`
    with `collectives.compressed_psum` and divides by P; the loss is the
    mean over ranks."""
    group = mesh.group(axis)
    n, r = mesh.shape[axis], mesh.axis_index(axis)
    loss_and_grads = make_loss_and_grads(cfg, remat=True)

    def step(params, opt_state, residual, batch):
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not shard over {n} ranks of {axis!r}")
        rows = b // n
        loss, grads = loss_and_grads(params, {k: v[r * rows:(r + 1) * rows]
                                              for k, v in batch.items()})
        grads, residual = collectives.ErrorFeedback.apply(grads, residual)
        grads = tree_map(lambda g: collectives.compressed_psum(g, group) / n, grads)
        dist.all_reduce(loss, group=group)
        loss = loss / n
        params, opt_state, gnorm = adamw.update(params, grads, opt_state, opt_cfg)
        return loss, params, opt_state, residual, gnorm

    return step
