"""Whole runs of tiny cells on the CPU: the engine, the window, the
metrics, the reference's check, and cells, mixes and metrics added as new
files only."""
import json
import time

import pytest

from bench import harness
from bench.tests.conftest import ROOT, copy_bench

SEED = 2**31 + 101


@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-moe.tiny"])
def test_run_is_correct(tiny_root, cell):
    res = harness.run_cell(cell, SEED, 1.5, False, time.perf_counter(), root=tiny_root,
                           device="cpu", log=lambda *_: None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 3
    assert set(res["metrics"]) == {"tokens_per_s", "ttft_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["checks"]["logit_gap"]["value"] <= res["checks"]["logit_gap"]["limit"]


def test_traced_run_reads_what_the_cpu_has(tiny_root):
    res = harness.run_cell("tiny-moe.tiny", SEED, 0.2, True, time.perf_counter(),
                           root=tiny_root, device="cpu", log=lambda *_: None)
    got = set(res["metrics"])
    # no device trace on the CPU: the device's metrics find nothing to read
    assert {"decode_step_ms", "prefill_pass_ms", "step_mfu", "decode_step_roofline",
            "host_mb_per_token"} <= got
    assert not got & {"device_idle_pct", "gemm_decode_roofline", "gemm_prefill_roofline",
                      "paged_attn_roofline"}
    assert res["correct"]


def test_new_files_add_a_config_a_mix_and_a_metric(tiny_root):
    """The tiny cells are themselves new configs, mixes and limits; a new
    per-layer metric is one more file and one more entry."""
    (tiny_root / "bench" / "metrics" / "rows_per_step.py").write_text(
        'LAYER, UNIT, SOURCE, MOVES, BETTER = "engine", "rows", "host_clock", '
        '"tokens_per_s", "higher"\n\n\ndef read(r):\n'
        '    return sum(len(s.ctxs) for s in r.steps) / len(r.steps)\n')
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "rows_per_step", "unit": "rows", "better": "higher",
                               "source": "host_clock", "layer": "engine",
                               "moves": "tokens_per_s", "workloads": ["tiny-dense.tiny"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = harness.run_cell("tiny-dense.tiny", SEED, 0.2, True, time.perf_counter(),
                           root=tiny_root, device="cpu", log=lambda *_: None)
    assert 0 < res["metrics"]["rows_per_step"]["value"] <= 3
    for path in (ROOT / "bench").rglob("*"):       # every file already there is unchanged
        if path.is_file() and "tests" not in path.parts and "__pycache__" not in path.parts:
            assert (tiny_root / path.relative_to(ROOT)).read_bytes() == path.read_bytes()


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and bench/ runs nothing."""
    import subprocess
    import sys

    copy_bench(tmp_path)
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "opt30b.code",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
