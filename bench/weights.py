"""Random weights of a configuration at its published widths, made on the
device from ``(seed, part)``: part 0 is everything outside the layer stack,
part i + 1 is layer i.  Each part's matrices come from one draw in the
served dtype and its vectors from one fp32 draw, on a `torch.Generator` of
the device, so the program and the reference get the same values from the
same seed.  The leaves are the published ones (no padded heads); nothing
here imports the program.

A configuration's ``init`` says how the draws are scaled: ``matrix_std``
for every matrix, ``router_std`` for a MoE router, ``norm`` = (centre, std)
for norm weights and ``bias_std`` for biases.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

TOP = 0
MATRIX, ROUTER, NORM, BIAS = "matrix", "router", "norm", "bias"


class Leaf(NamedTuple):
    name: str
    shape: tuple[int, ...]
    kind: str


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def layer_leaves(model: dict) -> list[Leaf]:
    """One layer's leaves, in draw order: attention, then the FFN (a MoE
    router and expert stacks, or the dense MLP), then the vectors."""
    d, h, kh, hd = model["d_model"], model["n_heads"], model["n_kv_heads"], head_dim(model)
    layernorm = model.get("norm") == "layernorm"
    up = model["d_ff"] * (2 if model.get("mlp") == "swiglu" else 1)
    leaves = [Leaf("wq", (d, h * hd), MATRIX), Leaf("wkv", (d, 2 * kh * hd), MATRIX),
              Leaf("wo", (h * hd, d), MATRIX)]
    if model["family"] == "moe":
        e, ff = model["n_experts"], model["moe_d_ff"]
        leaves += [Leaf("router", (d, e), ROUTER), Leaf("experts_wi", (e, d, 2 * ff), MATRIX),
                   Leaf("experts_wdown", (e, ff, d), MATRIX)]
    else:
        leaves += [Leaf("wi", (d, up), MATRIX), Leaf("wdown", (model["d_ff"], d), MATRIX)]
    leaves += [Leaf("ln1_w", (d,), NORM), Leaf("ln2_w", (d,), NORM)]
    if layernorm:
        leaves += [Leaf("ln1_b", (d,), BIAS), Leaf("ln2_b", (d,), BIAS)]
    if model.get("qk_norm"):
        leaves += [Leaf("q_norm_w", (hd,), NORM), Leaf("k_norm_w", (hd,), NORM)]
    if layernorm and model["family"] != "moe":
        leaves += [Leaf("bi", (up,), BIAS), Leaf("bdown", (d,), BIAS)]
    return leaves


def top_leaves(model: dict) -> list[Leaf]:
    """The leaves outside the layer stack: embedding, final norm, lm_head."""
    d, v = model["d_model"], model["vocab"]
    leaves = [Leaf("embed", (v, d), MATRIX)]
    if not model.get("tie_embeddings"):
        leaves.append(Leaf("lm_head", (d, v), MATRIX))
    leaves.append(Leaf("final_w", (d,), NORM))
    if model.get("norm") == "layernorm":
        leaves.append(Leaf("final_b", (d,), BIAS))
    return leaves


def part_seed(seed: int, part: int) -> int:
    """A generator seed for one part of one run's weights."""
    s = int(seed) % (1 << 64)
    state = np.random.SeedSequence([s & 0xFFFFFFFF, s >> 32, part]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) | (int(state[1]) >> 1)


def draw(model: dict, part: int, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The published leaves of `part` (TOP, or layer i as part i + 1), in
    `dtype`, on `device`.  Matrices are views into one draw."""
    leaves = top_leaves(model) if part == TOP else layer_leaves(model)
    init = model["init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(part_seed(seed, part))
    mats = [leaf for leaf in leaves if leaf.kind in (MATRIX, ROUTER)]
    vecs = [leaf for leaf in leaves if leaf.kind in (NORM, BIAS)]
    flat = torch.randn(sum(math.prod(leaf.shape) for leaf in mats), generator=gen,
                       dtype=dtype, device=device)
    out: dict[str, torch.Tensor] = {}
    off = 0
    for leaf in mats:
        n = math.prod(leaf.shape)
        std = init["router_std"] if leaf.kind == ROUTER else init["matrix_std"]
        out[leaf.name] = flat[off:off + n].view(leaf.shape).mul_(std)
        off += n
    if vecs:
        vflat = torch.randn(sum(math.prod(leaf.shape) for leaf in vecs), generator=gen,
                            dtype=torch.float32, device=device)
        off = 0
        centre, spread = init["norm"]
        for leaf in vecs:
            n = math.prod(leaf.shape)
            v = vflat[off:off + n].view(leaf.shape)
            v = v * spread + centre if leaf.kind == NORM else v * init["bias_std"]
            out[leaf.name] = v.to(dtype)
            off += n
    return out
