"""Boundaries of the PyTorch port: it imports nothing of JAX or of the JAX
package, and its entry points run on the card unless the caller asks for
the CPU — without a card they raise instead of falling back."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request, ServingEngine

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], (ast.Constant, ast.JoinedStr)):
            arg = node.args[0]
            head = arg.value if isinstance(arg, ast.Constant) else (
                arg.values[0].value if arg.values and isinstance(arg.values[0], ast.Constant)
                else "")
            roots.add(str(head).split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_reference():
    assert len(PORT_FILES) > 20
    bad = {str(p.relative_to(REPO)): sorted(_imported_roots(p) & set(FORBIDDEN))
           for p in PORT_FILES}
    assert not {k: v for k, v in bad.items() if v}
    assert "repro_torch" in _imported_roots(REPO / "src/repro_torch/configs/__init__.py")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_smoke("llama2_7b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, max_len=32, global_offload_ratio=0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])
    eng = ServingEngine(cfg, params, max_len=32, global_offload_ratio=0.5, page_size=4,
                        device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(3, 9, dtype=np.int32), max_new_tokens=3))
    assert eng.run().served == 1
    out = serve.main(["--smoke", "--device", "cpu", "--requests", "2", "--prompt-len", "5",
                      "--new-tokens", "3", "--max-len", "16", "--offload-ratio", "0.5",
                      "--page-size", "4"])
    assert out["served"] == 2 and out["generated_tokens"] == 6
