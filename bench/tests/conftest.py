"""CPU fixtures of the benchmark's tests: the repository on the path, and a
copy of the benchmark with tiny cells that the CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

INIT = {"matrix_std": 0.2, "router_std": 0.5, "norm": [1.0, 0.1], "bias_std": 0.05}
TINY_MODELS = {
    "tiny-dense": {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 3,
                   "n_kv_heads": 3, "head_dim": 16, "d_ff": 128, "vocab": 96, "mlp": "gelu",
                   "norm": "layernorm", "norm_eps": 1e-5, "rope_theta": 10000.0,
                   "tie_embeddings": True, "tp_head_multiple": 1, "dtype": "float32",
                   "init": INIT},
    "tiny-moe": {"family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                 "head_dim": 16, "d_ff": 32, "vocab": 96, "n_experts": 8, "top_k": 2,
                 "moe_d_ff": 32, "n_shared_experts": 0, "moe_capacity_factor": 4.0,
                 "qk_norm": True, "norm": "rmsnorm", "norm_eps": 1e-6, "rope_theta": 1e6,
                 "tie_embeddings": False, "tp_head_multiple": 1, "dtype": "float32",
                 "init": INIT},
}
# an HBM budget of 200 kB: the program's planner puts about half of the tiny
# dense model (0.36 MB with its cache) and two thirds of the tiny MoE (0.62
# MB) across the host link
TINY_MIX = {"source": "test", "loop": "closed", "clients": 3, "requests_per_client": 200,
            "max_len": 48, "engine": {"page_size": 4, "hbm_budget_bytes": 200_000},
            "prompt": {"median": 12, "sigma": 0.25, "min": 8, "max": 16},
            "output": {"median": 8, "sigma": 0.3, "min": 6, "max": 12}, "first_token_id": 3}
TINY_LIMIT = 1e-3       # fp32 program against the fp32 reference: rounding only


def add_tiny_cells(root: Path) -> None:
    """Tiny dense and MoE cells, as new files and new entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, model in TINY_MODELS.items():
        (root / "bench" / "configs" / f"{name}.json").write_text(json.dumps(
            {"source": "test", "reduced": [], "assumed": [], "model": model}))
        bench["configs"].append({"name": name, "source": "test", "file":
                                 f"bench/configs/{name}.json", "reduced": [], "why": "test"})
        cell = f"{name}.tiny"
        bench["workloads"].append({"name": cell, "config": name, "traffic": "tiny",
                                   "chips": 1, "why": "test"})
        (root / "bench" / "limits" / f"{cell}.json").write_text(json.dumps(
            {"logit_gap": {"limit": TINY_LIMIT}}))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (root / "bench" / "traffic" / "tiny.json").write_text(json.dumps(TINY_MIX))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def copy_bench(dst: Path) -> Path:
    """BENCHMARK.json and bench/ (no tests, no caches) under `dst`."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    return dst


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    """A tiny benchmark; the tiny engines run on one thread, so that a
    timed window serves about as much under parallel workers as alone."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = copy_bench(tmp_path)
    add_tiny_cells(root)
    yield root
    torch.set_num_threads(threads)
