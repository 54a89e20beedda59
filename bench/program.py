"""The system under test, as the benchmark drives it: the port's serving
engine built from the benchmark's weights, its requests, and the counters
it keeps.  The only module of the benchmark that imports the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench import weights as W
from bench.clients import Planned


def model_config(name: str, model: dict):
    """The program's configuration of a model file's ``model`` section,
    whose keys are the program's own names."""
    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(name=name, **{k: v for k, v in model.items() if k in fields})


def layer_source(cfg, model: dict, seed: int, device, dtype=torch.bfloat16):
    """A `LayerSource` of the benchmark's weights: each layer drawn when the
    engine asks for it, checked against the program's own leaf shapes (a
    configuration whose heads the program would pad does not pass)."""
    from repro_torch.models import model as M

    shapes = M.init_layer(cfg, None, dtype, "meta")
    top_shapes = M.init_top(cfg, None, dtype, "meta")
    top = W.draw(model, W.TOP, seed, device, dtype)
    _check(top, top_shapes, "top")

    def layer(i: int) -> dict[str, torch.Tensor]:
        leaves = W.draw(model, i + 1, seed, device, dtype)
        _check(leaves, shapes, f"layer {i}")
        return leaves

    return M.LayerSource(n_layers=cfg.n_layers, top=top, shapes=shapes, layer=layer)


def _check(leaves: dict, shapes: dict, what: str) -> None:
    got = {k: tuple(v.shape) for k, v in leaves.items()}
    want = {k: tuple(v.shape) for k, v in shapes.items()}
    if got != want:
        raise ValueError(f"{what}: the benchmark's leaves {got} are not the program's {want}")


def build_engine(cfg, model: dict, mix: dict, seed: int, device):
    """The engine as a deployment builds it: the program plans the split
    itself, at the mix's HBM budget (None: the card's capacity)."""
    from repro_torch.serving.engine import ServingEngine

    eng = mix["engine"]
    dtype = getattr(torch, model.get("dtype", "bfloat16"))
    return ServingEngine(cfg, layer_source(cfg, model, seed, device, dtype),
                         max_batch=mix["clients"], max_len=mix["max_len"],
                         hbm_budget_bytes=eng["hbm_budget_bytes"],
                         page_size=eng["page_size"], device=device)


def plan_summary(engine) -> str:
    """The split the engine's planner chose, in a line."""
    plan = engine.plan
    kv = plan.kv_pages
    return (f"global offload ratio {plan.global_ratio:.4f}, footprint "
            f"{plan.footprint_bytes / 1e9:.3f} GB, KV pages {kv.local_pages} local + "
            f"{kv.remote_pages} remote")


def make_request(planned: Planned, rid: int):
    from repro_torch.serving.engine import Request

    return Request(rid=rid, prompt=planned.prompt, max_new_tokens=planned.budget)


@dataclasses.dataclass
class Counters:
    """The program's device counts, read together (one sync)."""

    gemm_host_bytes: int
    grouped_host_bytes: int
    attn_host_bytes: int
    remote_experts: int

    def __sub__(self, other: "Counters") -> "Counters":
        return Counters(*(a - b for a, b in zip(dataclasses.astuple(self),
                                                 dataclasses.astuple(other))))

    @property
    def host_bytes(self) -> int:
        return self.gemm_host_bytes + self.grouped_host_bytes + self.attn_host_bytes


def read_counters() -> Counters:
    from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn
    from repro_torch.kernels.splitk_gemm import splitk_gemm, splitk_gemm_grouped
    from repro_torch.models.layers import tiered_expert_ffn

    return Counters(int(splitk_gemm.host_bytes), int(splitk_gemm_grouped.host_bytes),
                    int(paged_splitk_flashattn.host_bytes), int(tiered_expert_ffn.remote_experts))


def remote_experts() -> int:
    from repro_torch.models.layers import tiered_expert_ffn

    return int(tiered_expert_ffn.remote_experts)


def kv_tiers(engine) -> tuple[float, float]:
    """(local, remote) KV bytes the next decode step attends, by the page
    table's tiers (the program's count), for the slots decoding now."""
    if engine.pcache is None:
        return 0.0, 0.0
    active = np.array([r is not None for r in engine.active])
    return engine.pcache.attended_bytes(engine.lens, active)
