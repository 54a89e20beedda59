"""The readers of the program's phase ledger (`bench/spans.py` and the
four metrics on it), on a traced tiny cell on the CPU: each reads what the
ledger's window holds, a program without the ledger leaves them out, and
the readers came as new files only."""
import hashlib
import json
import time

import pytest

from bench import harness
from bench.tests.conftest import ROOT

SEED = 2**31 + 7
NEW = ("prefill_wait_ms", "prompt_write_ms", "step_host_ms", "setup_pin_s")
# every file of the benchmark before the phase readers came, by its sha256's
# first 16 hex digits
ACCEPTED = {
    "README.md": "4c5f9fe0bf5c289f",
    "__init__.py": "a57ef6cfc54dcdc5",
    "clients.py": "4c9f1f0493a03bee",
    "configs/opt-30b.json": "0e37c5364d46f213",
    "control.py": "c881cee569f517dd",
    "devtrace.py": "7e8339e0fec9ea2e",
    "harness.py": "dd318c510229fd06",
    "judge.py": "f3994dc381980edb",
    "limits/opt30b.code.json": "d9a0b791a58a79c9",
    "metrics/decode_step_ms.py": "6b6513dfd382f453",
    "metrics/decode_step_roofline.py": "16fff1bdf02b65d1",
    "metrics/device_idle_pct.py": "9ff8daa78fbb5d79",
    "metrics/gemm_decode_roofline.py": "ec1c922b38b39638",
    "metrics/gemm_prefill_roofline.py": "1b0f677000918a7f",
    "metrics/host_mb_per_token.py": "60c10c531d626510",
    "metrics/paged_attn_roofline.py": "7440b85231e44f12",
    "metrics/prefill_pass_ms.py": "f4931c17abcc7563",
    "metrics/setup_s.py": "e195227bebdb0e6e",
    "metrics/step_mfu.py": "2f885dbcc9144192",
    "metrics/tokens_per_s.py": "daf7faba4098efaa",
    "metrics/ttft_p95_ms.py": "369154abd3dadc84",
    "peaks.py": "96e4801aeb766f73",
    "program.py": "4d889ae94ef153d9",
    "reference/__init__.py": "67cae6e666beeeb4",
    "reference/decoder.py": "1be17bc084c92c6b",
    "run.py": "350e67e218599c44",
    "traffic/azure-code.json": "37a0d365f4349c61",
    "traffic/azure-conv.json": "e6b5b117aab4a9c8",
    "weights.py": "3fa889adad6159a6",
    "work.py": "f083a6620ec5df59",
}


def _run(root):
    return harness.run_cell("tiny-dense.tiny", SEED, 0.3, True, time.perf_counter(), root=root,
                            device="cpu", log=lambda *_: None)


def test_metrics_equal_the_ledger_window(tiny_root):
    from repro_torch.obs.trace import latest_ledger

    res = _run(tiny_root)
    assert res["correct"]
    got = {name: res["metrics"][name]["value"] for name in NEW}
    ledger = latest_ledger()
    steps = list(ledger.steps)
    # set-up's one step fills every slot; the window is every step after it
    assert len(steps) == ledger.n_steps >= 2 and len(steps[0].passes) == 3
    window = steps[1:]
    assert [s.index for s in window] == list(range(1, len(steps)))
    first = [p for s in window for p in s.passes if p.pos == 0]
    passes = [p for s in window for p in s.passes]
    assert first and all(p.t_submit <= p.t_prefill == p.t0 < p.t1 for p in first)
    assert got["prefill_wait_ms"] == pytest.approx(
        1e3 * sum(p.t0 - p.t_submit for p in first) / len(first))
    assert got["prompt_write_ms"] == pytest.approx(
        1e3 * sum(p.write_s for p in passes) / len(passes))
    host = [s.seconds["dak.step"] - sum(p.t1 - p.t0 for p in s.passes)
            - s.seconds["dak.fetch"] for s in window]
    assert got["step_host_ms"] == pytest.approx(1e3 * sum(host) / len(host))
    assert got["setup_pin_s"] == ledger.build.seconds["dak.pin"] > 0
    assert all(v > 0 for v in got.values())


def test_a_program_without_the_ledger_reads_nothing(tiny_root, monkeypatch):
    """The parent program has no ledger: the run completes and the four
    metrics are left out of its line."""
    from repro_torch.obs import trace

    monkeypatch.delattr(trace, "latest_ledger")
    res = _run(tiny_root)
    assert res["correct"] and not set(NEW) & set(res["metrics"])
    assert {"decode_step_ms", "prefill_pass_ms"} <= set(res["metrics"])


def test_readers_came_as_new_files_only():
    for rel, digest in ACCEPTED.items():
        assert hashlib.sha256((ROOT / "bench" / rel).read_bytes()).hexdigest()[:16] == digest, rel
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-len(NEW):] == list(NEW)
    for name in NEW:
        assert f"metrics/{name}.py" not in ACCEPTED and (ROOT / "bench" / "metrics" /
                                                         f"{name}.py").exists()


def _ev(name, start, end, on_device=False, annotation=False):
    from bench import devtrace

    return devtrace.Event(name, float(start), float(end), on_device, annotation)


def test_phases_reads_idle_by_region():
    """`bench/phases.py` on hand-made events: a window of one step whose
    device idles in a prompt write (its pageable copy and `index_put_`
    inside it), in a fetch, and after the last region."""
    from bench import devtrace, phases

    events = [
        _ev(devtrace.WINDOW, 0, 1000), _ev("engine.step", 0, 1000),
        _ev("dak.step", 0, 940), _ev("dak.prompt_write", 100, 400), _ev("dak.fetch", 500, 600),
        _ev("aten::_index_put_impl_", 150, 390), _ev("cudaStreamSynchronize", 510, 590),
        _ev("dak.prompt_write", 100, 400, on_device=True, annotation=True),
        _ev("gemm", 0, 100, on_device=True),
        _ev("Memcpy DtoH (Device -> Pageable)", 120, 140, on_device=True),
        _ev("gemm", 400, 500, on_device=True), _ev("gemm", 600, 900, on_device=True),
    ]
    got = phases.analyse(events, devtrace)
    # idle: 100-120 and 140-400 in the write, 500-600 in the fetch, 900-1000
    # whose middle (950) lies after dak.step ends
    assert got["busy_s"] == pytest.approx(520e-6) and got["steps"] == 1
    assert got["idle_engine_step_s"] == pytest.approx(480e-6)
    assert got["idle_outside_dak_s"] == pytest.approx(100e-6)
    assert dict(got["idle_by_phase"]) == pytest.approx(
        {"dak.prompt_write": 280e-6, "dak.fetch": 100e-6, "engine.step outside dak.*": 100e-6})
    assert got["index_put_idle_s"] == got["index_put_idle_in_prompt_write_s"] == \
        pytest.approx(260e-6)
    assert got["dtoh_pageable_s"] == got["dtoh_in_prompt_write_s"] == pytest.approx(20e-6)
    assert got["dak_on_device"] == {"annotation": 1} and got["dak_ranges"] == 3
    assert got["syncs_per_step"] == {"cudaStreamSynchronize": 1.0}
    assert phases.analyse(events[1:], devtrace) == {}


def test_phases_runs_a_traced_tiny_cell(tiny_root, tmp_path, monkeypatch, capsys):
    """The tool end to end on the CPU: the profiler's `dak.*` ranges in the
    window are the window steps' regions, and ``--out`` holds the ledger."""
    import sys

    from bench import phases
    from repro_torch.obs.trace import latest_ledger

    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, "unset")
    monkeypatch.setattr(sys, "path", list(sys.path))
    out = tmp_path / "phases.json"
    assert phases.main(["--workload", "tiny-dense.tiny", "--seed", str(SEED), "--seconds", "0.3",
                        "--root", str(tiny_root), "--device", "cpu", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    saved = json.loads(out.read_text())
    window = saved["ledger"][1:]
    assert line["correct"] and line["phases"]["steps"] == len(window) >= 1
    # each window step's dak.step, its five children and its passes' regions
    regions = sum(1 + len([k for k in s["seconds"] if k in (
        "dak.admit", "dak.stage", "dak.launch", "dak.fetch", "dak.finish")])
        + sum(2 + (p["write_s"] > 0) for p in s["passes"]) for s in window)
    assert line["phases"]["dak_ranges"] == regions
    assert line["phases"]["busy_s"] == 0 and line["phases"]["idle_engine_step_s"] == 0
    assert 0 < saved["region_cost_us"] < 1e3
    assert latest_ledger() is not None
