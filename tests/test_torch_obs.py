"""The port's observability layer against the JAX engine's, on the modeled
clock for the same run: llama2-7b smoke with bridged weights, offload 0.5,
page 4, 2 slots, the SLO scheduler with chunks of 4, the adaptive runtime,
the TPU_V5E profile, every emission site live (the run of
tests/test_obs.py).  The Chrome trace, the metrics snapshot, the
attribution ledger and bottleneck report and the flight bundles must equal
the reference's, wall-time fields left out; with every hook off the port's
tokens and stats must be bit-identical to the instrumented run's.  Floats
on the modeled clock are held to 1e-9 relative, as the frontend's tests
hold modeled TTFT."""
from __future__ import annotations

import json
import math

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.core.hardware import TPU_V5E as J_TPU
from repro.frontend.metrics import ModeledClock as JClock
from repro.models import model as JM
from repro.obs import cli as jcli
from repro.obs.attribution import AttributionProfiler as JProfiler
from repro.obs.flight import FlightRecorder as JFlight
from repro.obs.flight import load_bundle as jload
from repro.obs.metrics import provenance as jprovenance
from repro.obs.metrics import serving_registry as jregistry
from repro.obs.trace import ChromeTraceRecorder as JTrace
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.frontend.metrics import ModeledClock as TClock
from repro_torch.obs import cli as tcli
from repro_torch.obs.attribution import AttributionProfiler as TProfiler
from repro_torch.obs.flight import FlightRecorder as TFlight
from repro_torch.obs.flight import load_bundle as tload
from repro_torch.obs.metrics import provenance as tprovenance
from repro_torch.obs.metrics import serving_registry as tregistry
from repro_torch.obs.trace import ChromeTraceRecorder as TTrace
from repro_torch.obs.trace import validate_trace
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from test_torch_hygiene import FORBIDDEN, PORT_FILES, REPO, _imported_roots

JCFG, TCFG = JC.get_smoke("llama2_7b"), TC.get_smoke("llama2_7b")
WALL_FIELDS = ("wall_ms", "tpot_ms", "git_rev")   # host-clock values: never compared
SIDES = {"jax": (JEngine, JRequest, J_TPU, JClock, JTrace, JFlight, JProfiler),
         "torch": (TEngine, TRequest, T_TPU, TClock, TTrace, TFlight, TProfiler)}


@pytest.fixture(scope="module")
def weights():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return {"jax": jparams, "torch": tparams}


def _run(side, params, *, hooks=True, flight_dir=None, slo_breach_s=None, fail_at=None):
    """The instrumented modeled-clock run; returns (engine, tokens).  With
    `fail_at` the engine step of that number raises, so the flight
    recorder dumps an error bundle."""
    engine_cls, request_cls, hw, clock, trace, flight, profiler = SIDES[side]
    kw = {"device": "cpu"} if side == "torch" else {"jit_step": True}
    if hooks:
        kw.update(recorder=trace(metadata={"arch": "llama2_7b"}), profiler=profiler())
    if flight_dir is not None:
        kw["flight"] = flight(str(flight_dir), slo_breach_s=slo_breach_s)
    eng = engine_cls(JCFG if side == "jax" else TCFG, params, max_batch=2, max_len=32, hw=hw,
                     global_offload_ratio=0.5, page_size=4, scheduler="slo", prefill_chunk=4,
                     adaptive=True, clock=clock(), **kw)
    rng = np.random.default_rng(0)
    reqs = [request_cls(rid=i, prompt=rng.integers(3, JCFG.vocab, 10).astype(np.int32),
                        max_new_tokens=4, slo_ttft_s=0.5) for i in range(4)]
    for r in reqs:
        eng.submit(r)
    if fail_at is not None:
        step, calls = eng.step, []

        def failing_step():
            calls.append(1)
            if len(calls) == fail_at:
                raise RuntimeError("injected failure")
            step()

        eng.step = failing_step
        with pytest.raises(RuntimeError, match="injected failure"):
            eng.run()
    else:
        eng.run()
    return eng, [r.out_tokens for r in reqs]


def _strip(obj):
    """`obj` without its host-clock fields (at any depth)."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in WALL_FIELDS}
    if isinstance(obj, (list, tuple)):
        return [_strip(v) for v in obj]
    return obj


def assert_same(got, want, path="") -> None:
    """Same structure, key order and values; floats to 1e-9 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        assert math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-12), (path, got, want)
    else:
        assert got == want, (path, got, want)


def _metrics(side, eng) -> dict:
    reg = (jregistry if side == "jax" else tregistry)(eng, eng.stats, 1.0, meta={
        "arch": "llama2_7b", "smoke": True, "adaptive": True, "trace": None, "requests": 4})
    return _strip(reg.nested())


@pytest.fixture(scope="module")
def runs(weights):
    return {side: _run(side, weights[side]) for side in SIDES}


def test_trace_equals_reference_trace(runs):
    """Every Chrome trace event (spans, instants, counters, track names),
    in order, with the compile span's wall time left out."""
    (jeng, jtok), (teng, ttok) = runs["jax"], runs["torch"]
    assert ttok == jtok
    want, got = jeng.recorder.to_json(), teng.recorder.to_json()
    assert validate_trace(got) == []
    names = {e["name"] for e in got["traceEvents"]}
    assert {"admission", "decode", "compile[paged/w1]", "queued", "active",
            "first_token", "link_bytes", "attribution"} <= names
    assert_same(_strip(got), _strip(want))


def test_metrics_snapshot_equals_reference(runs):
    """The registry's JSON view (the compile.* counters and jit flag among
    its fields) and the provenance stamp but for its backend."""
    (jeng, _), (teng, _) = runs["jax"], runs["torch"]
    got, want = _metrics("torch", teng), _metrics("jax", jeng)
    assert got["compile"]["jit"] is True and got["compile"]["count"] >= 1
    assert_same(got, want)
    jp, tp = jprovenance(jeng, arch="llama2_7b"), tprovenance(teng, arch="llama2_7b")
    assert jp.pop("jax") and tp.pop("torch")
    assert_same(_strip(tp), _strip(jp))


def test_attribution_ledger_and_bottleneck_report_equal_reference(runs):
    (jeng, _), (teng, _) = runs["jax"], runs["torch"]
    got, want = teng.profiler.report(), jeng.profiler.report()
    assert got["steps"] > 0
    assert_same(got, want)
    assert_same([led.components() for led in teng.profiler.ledgers],
                [led.components() for led in jeng.profiler.ledgers])


@pytest.mark.parametrize("kind", ["slo_breach", "error"])
def test_flight_bundle_equals_reference(weights, tmp_path, kind):
    """The first SLO breach's bundle, and the bundle an error mid-run
    leaves behind (its last snapshot the failing step's state)."""
    kw = dict(slo_breach_s=1e-6) if kind == "slo_breach" else dict(fail_at=5)
    bundles = {}
    for side, load in (("jax", jload), ("torch", tload)):
        eng, _ = _run(side, weights[side], flight_dir=tmp_path / side, **kw)
        assert len(eng.flight.dumped) == 1
        bundles[side] = load(eng.flight.dumped[0])
    got, want = bundles["torch"], bundles["jax"]
    assert got["reason"] == ("slo_breach" if kind == "slo_breach" else "RuntimeError")
    assert got["snapshots"] and got["trace_tail"]
    assert_same(_strip(got), _strip(want))


def test_cli_reads_the_port_trace_as_the_reference_cli(runs, tmp_path, capsys):
    """`python -m repro_torch.obs summarize` of the port's trace prints what
    the reference's prints for its own."""
    out = {}
    for side, cli in (("jax", jcli), ("torch", tcli)):
        path = tmp_path / f"{side}.json"
        runs[side][0].recorder.save(str(path))
        assert cli.main(["validate", str(path)]) == 0
        capsys.readouterr()
        assert cli.main(["summarize", str(path)]) == 0
        out[side] = json.loads(capsys.readouterr().out)
    assert_same(out["torch"], out["jax"])


def test_hooks_off_is_bitwise_identical(weights, runs):
    """No recorder, profiler or flight recorder: the same tokens and the
    same stats, field for field, as the instrumented run."""
    teng, ttok = runs["torch"]
    eng, tok = _run("torch", weights["torch"], hooks=False)
    assert tok == ttok
    assert not eng.recorder.enabled and not eng.profiler.enabled and eng.flight is None
    off, on = _metrics("torch", eng), _metrics("torch", teng)
    for block in ("attribution", "bottleneck"):     # the profiler's own report
        assert block in on and block not in off
        del on[block]
    assert off == on and list(off) == list(on)
    assert [s.duration_s for s in eng.runtime.telemetry.ring] == \
        [s.duration_s for s in teng.runtime.telemetry.ring]


def test_serve_writes_trace_metrics_and_flight_bundles(tmp_path):
    """`launch/serve.py`'s observability flags on the CPU, graphed and with
    `--no-jit`: a valid trace, the Prometheus text (rewritten every 2
    steps), the attribution line and an SLO-breach bundle."""
    from repro_torch.launch import serve
    from repro_torch.obs.flight import load_bundle

    for extra in ([], ["--no-jit"]):
        trace, prom, fdir = tmp_path / "t.json", tmp_path / "m.prom", tmp_path / f"fl{len(extra)}"
        out = serve.main(["--smoke", "--device", "cpu", "--requests", "3", "--prompt-len", "6",
                          "--new-tokens", "4", "--max-len", "32", "--offload-ratio", "0.5",
                          "--page-size", "4", "--trace-out", str(trace), "--metrics-out",
                          str(prom), "--metrics-interval", "2", "--attribution",
                          "--flight-dir", str(fdir), "--flight-slo-breach-ms", "0",
                          *extra])
        assert out["served"] == 3 and out["compile"]["jit"] == (not extra)
        assert (out["compile"]["count"] >= 1) == (not extra)
        assert validate_trace(json.loads(trace.read_text())) == []
        assert "compile_count" in prom.read_text() and "served" in prom.read_text()
        bundles = sorted(p for p in fdir.iterdir() if not p.name.endswith(".tmp"))
        assert len(bundles) == 1
        assert load_bundle(str(bundles[0]))["reason"] == "slo_breach"


def test_hygiene_covers_obs_and_the_compiled_step():
    """tests/test_torch_hygiene.py scans the new modules, which import
    neither JAX nor the reference."""
    new = sorted((REPO / "src/repro_torch/obs").glob("*.py")) + [
        REPO / "src/repro_torch/serving/compiled_step.py"]
    assert len(new) == 9 and set(new) <= set(PORT_FILES)
    assert not any(_imported_roots(p) & set(FORBIDDEN) for p in new)
