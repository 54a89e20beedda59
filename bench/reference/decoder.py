"""Plain PyTorch reference of a GQA decoder, dense or MoE: the
configuration's forward pass over whole sequences, in fp32 (TF32 off), with
no kernel, cache or batching.  It imports nothing of the program.

It follows the configuration as the program runs it, departures included
(the configuration file lists them under ``assumed``): pre-norm blocks
(LayerNorm with bias or RMSNorm); RoPE on interleaved pairs of each head
(``x[..., ::2]``, ``x[..., 1::2]``); query head h reads KV head h mod
n_kv_heads; per-head RMSNorm of q and k before RoPE where ``qk_norm``; the
tanh GELU MLP with biases, or SwiGLU; a MoE layer that routes each token to
its top-k experts by softmax probability (ties to the lower index), weighs
them by the renormalised top-k probabilities and drops nothing.

Each layer's weights are drawn again from ``(seed, layer)`` by
`bench.weights.draw`, in the served dtype, and widened to fp32 here.

``precision="fp8"`` is the control: every product's weight and input
rounded to float8 e4m3, the weight per output column and the input per
row, each scaled to the format's largest value 448; norms, softmax and
attention stay fp32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from bench import weights as W

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` rounded to e4m3, each slice along `dim` scaled by its own max."""
    scale = FP8_MAX / t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


class Layer:
    """One layer's (or the top's) weights in fp32, and their fp8 copies
    for the control, made when first asked for."""

    def __init__(self, leaves: dict[str, torch.Tensor]):
        self.w = {k: v.float() for k, v in leaves.items()}
        self._fp8: dict[str, torch.Tensor] = {}

    def mat(self, name: str, precision: str) -> torch.Tensor:
        if precision == "fp32":
            return self.w[name]
        if name not in self._fp8:
            self._fp8[name] = fp8_round(self.w[name], dim=-2)
        return self._fp8[name]


def linear(x: torch.Tensor, layer: Layer, name: str, precision: str) -> torch.Tensor:
    if precision == "fp8":
        x = fp8_round(x, dim=-1)
    return x @ layer.mat(name, precision)


def norm(model: dict, x: torch.Tensor, layer: Layer, prefix: str) -> torch.Tensor:
    w = layer.w[f"{prefix}_w"]
    if model.get("norm") == "layernorm":
        return F.layer_norm(x, (x.shape[-1],), w, layer.w[f"{prefix}_b"], model["norm_eps"])
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + model["norm_eps"]) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, hd] at positions 0..T-1, interleaved pairs."""
    t, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)


def attention(model: dict, hn: torch.Tensor, layer: Layer, precision: str) -> torch.Tensor:
    """Causal attention of one sequence hn [T, d]."""
    t = hn.shape[0]
    h, kh, hd = model["n_heads"], model["n_kv_heads"], W.head_dim(model)
    q = linear(hn, layer, "wq", precision).view(t, h, hd)
    k, v = linear(hn, layer, "wkv", precision).view(t, 2, kh, hd).unbind(1)
    if model.get("qk_norm"):
        eps = model["norm_eps"]
        q = q * torch.rsqrt(q.pow(2).mean(-1, keepdim=True) + eps) * layer.w["q_norm_w"]
        k = k * torch.rsqrt(k.pow(2).mean(-1, keepdim=True) + eps) * layer.w["k_norm_w"]
    q, k = rope(q, model["rope_theta"]), rope(k, model["rope_theta"])
    kv_of = torch.arange(h, device=hn.device) % kh
    k, v = k[:, kv_of], v[:, kv_of]                               # [T, H, hd]
    logits = torch.einsum("thd,shd->hts", q, k) * hd ** -0.5
    mask = torch.ones(t, t, dtype=torch.bool, device=hn.device).tril()
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("hts,shd->thd", probs, v).reshape(t, h * hd)
    return linear(out, layer, "wo", precision)


def mlp(model: dict, x: torch.Tensor, layer: Layer, precision: str) -> torch.Tensor:
    h = linear(x, layer, "wi", precision)
    if model.get("mlp") == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate) * up
    else:
        if "bi" in layer.w:
            h = h + layer.w["bi"]
        h = F.gelu(h, approximate="tanh")
    out = linear(h, layer, "wdown", precision)
    return out + layer.w["bdown"] if "bdown" in layer.w else out


def moe(model: dict, x: torch.Tensor, layer: Layer, precision: str) -> torch.Tensor:
    """Top-k routing with renormalised gates, every routed token served."""
    probs = torch.softmax(linear(x, layer, "router", precision), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = model["top_k"]
    gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
    idx = idx[:, :k]
    wi, wdown = layer.mat("experts_wi", precision), layer.mat("experts_wdown", precision)
    y = torch.zeros_like(x)
    for e in torch.unique(idx).tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        xe = x[rows]
        if precision == "fp8":
            xe = fp8_round(xe, dim=-1)
        gate, up = (xe @ wi[e]).chunk(2, dim=-1)
        he = F.silu(gate) * up
        if precision == "fp8":
            he = fp8_round(he, dim=-1)
        y.index_add_(0, rows, (he @ wdown[e]) * gates[rows, slot, None])
    return y


def logits_at(model: dict, seed: int, seqs: list[torch.Tensor], score: list[torch.Tensor],
              device, precisions: tuple[str, ...] = ("fp32",),
              dtype=torch.bfloat16) -> dict[str, list[torch.Tensor]]:
    """Logits [len(score[i]), vocab] at positions `score[i]` of each
    sequence `seqs[i]` (token ids), for each precision: the layers run one
    at a time over every sequence, each layer's weights drawn once."""
    with exact_fp32(), torch.no_grad():
        top = Layer(W.draw(model, W.TOP, seed, device, dtype))
        lens = [len(s) for s in seqs]
        flat = torch.cat(seqs).to(device).long()
        x0 = top.w["embed"][flat]
        xs = {p: x0.clone() for p in precisions}
        for i in range(model["n_layers"]):
            layer = Layer(W.draw(model, i + 1, seed, device, dtype))
            for p in precisions:
                x = xs[p]
                hn = norm(model, x, layer, "ln1")
                x = x + torch.cat([attention(model, part, layer, p)
                                   for part in hn.split(lens)])
                hn = norm(model, x, layer, "ln2")
                ffn = moe if model["family"] == "moe" else mlp
                xs[p] = x + ffn(model, hn, layer, p)
            del layer
        out: dict[str, list[torch.Tensor]] = {}
        starts = torch.tensor([0] + lens[:-1]).cumsum(0).tolist()
        if "lm_head" not in top.w:                       # a tied head
            top.w["lm_head"] = top.w["embed"].T
        for p in precisions:
            rows = torch.cat([xs[p][s + pos.to(device)] for s, pos in zip(starts, score)])
            logits = linear(norm(model, rows, top, "final"), top, "lm_head", p)
            out[p] = list(logits.split([len(s) for s in score]))
        return out
