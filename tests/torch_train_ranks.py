"""The rank side of tests/test_torch_train.py: the compressed data-parallel
train step on gloo ranks, spawned by `launch.mesh.run_ranks` on the CPU.

Each rank writes ``<dir>/dp<P>_r<rank>.json``: its losses, and the sha256 of
its final parameters' bytes (every rank must end with the same bytes).
Rank 0 also runs the plain train step on the same batches for the
comparison.  No JAX here (every rank would pay for importing it).
"""
from __future__ import annotations

import hashlib
import json
import os

import torch

import repro_torch.configs as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.distributed.collectives import ErrorFeedback
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import leaves

DP_STEPS = 6


def train_case(n: int) -> tuple:
    """(cfg, optimizer config, fresh params, pipeline): tests/test_drivers.py's
    compressed-step case on the port."""
    cfg = C.get_smoke("llama2_7b")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=20)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, opt_cfg, params, SyntheticPipeline(cfg, ShapeConfig("t", 32, 2 * n, "train"))


def batch_at(pipe, step: int) -> dict:
    return {k: torch.from_numpy(v) for k, v in pipe.batch_at(step).items()}


def dp_case(rank: int, n: int, tmp: str) -> None:
    torch.set_num_threads(1)
    mesh = make_dev_mesh(n, 1)
    cfg, opt_cfg, params, pipe = train_case(n)
    opt = adamw.init(params)
    residual = ErrorFeedback.init(params)
    step = S.make_dp_train_step_compressed(cfg, mesh, opt_cfg)
    losses = []
    for i in range(DP_STEPS):
        loss, params, opt, residual, _ = step(params, opt, residual, batch_at(pipe, i))
        losses.append(float(loss))
    digest = hashlib.sha256()
    for p in leaves(params):
        digest.update(p.numpy().tobytes())
    out = {"losses": losses, "params_sha256": digest.hexdigest()}
    if rank == 0:
        _, _, plain_params, _ = train_case(n)
        plain_opt = adamw.init(plain_params)
        plain = S.make_train_step(cfg, opt_cfg)
        out["plain_losses"] = []
        for i in range(DP_STEPS):
            loss, plain_params, plain_opt, _ = plain(plain_params, plain_opt, batch_at(pipe, i))
            out["plain_losses"].append(float(loss))
    with open(os.path.join(tmp, f"dp{n}_r{rank}.json"), "w") as fh:
        json.dump(out, fh)
