"""The benchmark's command end to end on the card (skips without one), and
its refusal without one."""
import json
import subprocess
import sys

import pytest
import torch

from bench.tests.conftest import ROOT


def run(cell: str, seconds: float, trace: int) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "bench/run.py", "--workload", cell, "--seed",
                           str(2**31 + 3), "--seconds", str(seconds), "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run("opt30b.code", 1, 0)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["opt30b.code"])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run(cell, 5, 1)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0 and res["metrics"]
