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

For the dry run (`launch.dryrun`): `params_shapes`, `cache_shapes` and
`opt_shapes` build trees on the meta device (shapes and dtypes, no
storage: the reference's ``eval_shape`` helpers) through the model's own
constructors; `constrain_tree` redistributes a tree of DTensors to a spec
tree's placements (a no-op on plain tensors, as the reference's is without
a mesh); `make_train_step`'s ``grad_specs`` holds the gradients and the
fp32 accumulator to them (ZeRO-1's reduce-scatter), and its ``loop`` runs
the microbatch loop (by default every trip; the dry run traces one trip
and counts it n times, the reference's scan).
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


def constrain_tree(tree: Any, spec_tree: Any) -> Any:
    """Each DTensor leaf of `tree` redistributed to its spec's placements
    (`sharding.placements` over its mesh's axis names); plain tensors and a
    None `spec_tree` pass through, as the reference's
    ``with_sharding_constraint`` does without a mesh."""
    if spec_tree is None:
        return tree
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import placements

    def constrain(x, spec):
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh, placements(x.device_mesh.mesh_dim_names, spec))

    return tree_map(constrain, tree, spec_tree)


def _every_trip(body: Callable[[int], Any], n: int) -> None:
    for i in range(n):
        body(i)


def make_loss_and_grads(cfg: ModelConfig, num_microbatches: int = 1,
                        remat: bool = True, grad_specs: Any = None,
                        loop: Callable = _every_trip) -> Callable:
    """``fn(params, batch) -> (loss, grads)``, the train step before the
    optimizer.  With more than one microbatch, microbatch i takes rows {i,
    i + n, ...} (the reference's strided split, which keeps every data
    shard in every microbatch); their losses and fp32 gradients are summed
    and scaled by 1/n.  ``loop(body, n)`` runs ``body(i)`` for the trips.
    With `grad_specs` the gradients (one microbatch) or the fp32
    accumulator (several) are held to those specs (`constrain_tree`)."""
    n = num_microbatches

    def loss_and_grads(params, batch):
        if n == 1:
            loss, grads = _value_and_grad(cfg, params, batch, remat)
            return loss, constrain_tree(grads, grad_specs)
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} microbatches")
        loss = torch.zeros((), dtype=torch.float32, device=batch["labels"].device)
        acc = constrain_tree(tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                                      params), grad_specs)

        def body(i):
            nonlocal loss
            mb = {k: v.reshape(b // n, n, *v.shape[1:])[:, i] for k, v in batch.items()}
            l, g = _value_and_grad(cfg, params, mb, remat)
            loss = loss + l
            # in place: a sharded accumulator takes its share of each
            # gradient (ZeRO-1's reduce-scatter)
            tree_map(lambda a, gi: a.add_(gi.float()), acc, g)

        loop(body, n)
        inv = 1.0 / n
        return loss * inv, tree_map(lambda a: a.mul_(inv), acc)

    return loss_and_grads


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    num_microbatches: int = 1,
    remat: bool = True,
    grad_specs: Any = None,
    loop: Callable = _every_trip,
) -> Callable:
    """``step(params, opt_state, batch) -> (loss, params, opt_state, gnorm)``;
    params and the moments are updated in place."""
    loss_and_grads = make_loss_and_grads(cfg, num_microbatches, remat, grad_specs, loop)

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


def params_shapes(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16) -> Any:
    """The full-size param tree of `models.init_params` on the meta device,
    in `dtype` (`analysis.surface.abstract_params`, cast)."""
    from repro_torch.analysis.surface import abstract_params

    return tree_map(lambda t: t.to(dtype), abstract_params(cfg))


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig,
                 dtype: torch.dtype = torch.bfloat16) -> Any:
    """`models.init_cache` at `shape` on the meta device."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len, dtype=dtype, device="meta")


def opt_shapes(params_tree: Any) -> Any:
    """`optim.adamw.init` of a (meta) param tree."""
    return adamw.init(params_tree)


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
