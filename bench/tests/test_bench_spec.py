"""BENCHMARK.json against the contract's rules, and each metric's reader
against its entry."""
import json
import re

import pytest

from bench import harness
from bench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"] and BENCH["command"][1] == "bench/run.py"
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_cells_and_configs():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for c in BENCH["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("bench/") and spec["reduced"] == c["reduced"]
        assert spec["source"].startswith(c["source"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        mix = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert mix["source"] and mix["engine"] == {"page_size": 16, "hbm_fraction": 0.9,
                                                   "working_bytes": 10e9}
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").exists()


def test_every_cell_reports_what_it_needs():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for cell in CELLS:
        mine = {m["name"] for m in harness.cell_metrics(BENCH, cell, trace=False)}
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.cell_metrics(BENCH, cell, trace=True)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)


def test_layers_are_named_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"engine", "device", "model step", "kernels", "host link"}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_reader_declares_its_entry(metric):
    mod = harness.load_reader(ROOT, metric["name"])
    assert mod.UNIT == metric["unit"] and mod.SOURCE == metric["source"]
    assert mod.BETTER == metric["better"]
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
    assert callable(mod.read)


def test_run_seconds_fits_the_full_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200
