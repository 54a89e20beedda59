"""The port's training substrates against the JAX package: fault tolerance,
checkpointing, the synthetic pipeline and AdamW.

Held: the reference's own substrate cases (tests/test_substrates.py) run on
the port (checkpoint round trip, async + gc, integrity, atomic publish;
restart loop, straggler detector, elastic plan); a bf16 round trip bit
for bit; each package restoring the other's fp32 checkpoint; `batch_at`
equal to the reference's arrays for every family, with snapshot and
restore; `schedule`, `clip_by_global_norm` and `update` against the
reference on the same trees, fp32 within 2e-4 relative and bf16 within
5e-2 (the reference's kernel tolerances)."""
from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import SyntheticPipeline as JPipe
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.distributed import fault
from repro_torch.optim import adamw
from repro_torch.tree import flatten, tree_map
from torch_helpers import FP32_TOL, rel_err

BF16_TOL = 5e-2
ARCHS = ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b", "mamba2_370m",
         "zamba2_2p7b", "hubert_xlarge", "llava_next_34b"]


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def _tree(key=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(key)
    return {"a": torch.randn((8, 4), generator=g).to(dtype),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.tensor(3.5, dtype=dtype)}}


def _assert_equal(a, b) -> None:
    fa, fb = list(flatten(a)), list(flatten(b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip(tmp_path, dtype):
    mgr = CheckpointManager(tmp_path)
    t = _tree(dtype=dtype)
    res = mgr.save(5, t, extra={"pipeline": {"step": 5}})
    out, extra = mgr.restore(5, like=t)
    _assert_equal(out, t)
    assert extra["pipeline"]["step"] == 5
    assert res.bytes == sum(x.numel() * x.element_size() for _, x in flatten(t))
    manifest = json.loads((res.path / "manifest.json").read_text())
    assert manifest["leaves"]["a"]["dtype"] == ("bfloat16" if dtype == torch.bfloat16
                                                else "float32")


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert mgr.last_result.step == 4


def test_checkpoint_async_snapshots_at_the_call(tmp_path):
    """The tree may change in place right after `save_async` returns."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    want = tree_map(torch.clone, t)
    mgr.save_async(1, t)
    t["a"].add_(1.0)
    mgr.wait()
    _assert_equal(mgr.restore(1, like=want)[0], want)


def test_checkpoint_integrity_detection(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    res = mgr.save(1, t)
    victim = next(res.path.glob("leaf_*.npy"))
    raw = bytearray(victim.read_bytes())
    raw[-1] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(1, like=t)


def test_checkpoint_restore_places_on_the_device_asked(tmp_path):
    """The port's counterpart of the reference's elastic `shardings`: each
    leaf lands on `like`'s device, or on `device`; a shape mismatch raises."""
    mgr = CheckpointManager(tmp_path)
    t = {"w": torch.arange(16.0).reshape(4, 4)}
    mgr.save(1, t)
    out, _ = mgr.restore(1, like={"w": torch.empty((4, 4), device="meta")}, device="cpu")
    assert out["w"].device.type == "cpu" and torch.equal(out["w"], t["w"])
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(1, like={"w": torch.empty((2, 8))})


def test_checkpoint_atomic_publish(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, _tree())
    assert not list(Path(tmp_path).glob(".tmp_*"))
    manifest = json.loads((Path(tmp_path) / "step_7" / "manifest.json").read_text())
    assert manifest["step"] == 7


def _jax_tree(key=0):
    k = jax.random.PRNGKey(key)
    return {"a": jax.random.normal(k, (8, 4)),
            "nested": {"b": jnp.arange(6, dtype=jnp.int32), "c": jnp.float32(3.5)},
            "opt": {"m": jnp.ones((3, 2)), "step": jnp.zeros((), jnp.int32)}}


def test_each_package_restores_the_others_fp32_checkpoint(tmp_path):
    jt = _jax_tree()
    tt = bridge.params_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")
    JManager(tmp_path / "jax").save(3, jt, extra={"pipeline": {"step": 3}})
    out, extra = CheckpointManager(tmp_path / "jax").restore(3, like=tt)
    _assert_equal(out, tt)
    assert extra == {"pipeline": {"step": 3}}

    CheckpointManager(tmp_path / "torch").save(4, tt, extra={"pipeline": {"step": 4}})
    back, extra = JManager(tmp_path / "torch").restore(4, like=jt)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 back, jt)
    assert extra == {"pipeline": {"step": 4}}
    # the same files under the same names, leaf for leaf
    jm = json.loads((tmp_path / "jax" / "step_3" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "torch" / "step_4" / "manifest.json").read_text())
    assert {k: (v["file"], v["shape"]) for k, v in jm["leaves"].items()} == \
        {k: (v["file"], v["shape"]) for k, v in tm["leaves"].items()}


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def test_restart_loop_recovers():
    calls = {"n": 0}
    injector = fault.FaultInjector({3})

    def body(start):
        for step in range(start, 6):
            injector.maybe_fail(step)
            calls["n"] += 1
        return 6

    loop = fault.RestartLoop(max_restarts=2)
    final = loop.run(body, 0, on_restart=lambda: 2)
    assert final == 6 and loop.restarts == 1
    assert calls["n"] == 3 + 4          # 0,1,2 then 2,3,4,5


def test_restart_loop_bounded():
    loop = fault.RestartLoop(max_restarts=1)

    def body(start):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="exceeded"):
        loop.run(body, 0)


def test_straggler_detector():
    det = fault.StragglerDetector(threshold=2.0)
    for _ in range(10):
        det.observe(0.1)
    assert det.observe(0.5) and det.flagged == 1
    assert not det.observe(0.11)


def test_elastic_plan():
    p = fault.ElasticPlan.for_devices(512 - 32, model_axis=16)   # lost 2 hosts
    assert p.model == 16 and p.data == 16
    p2 = fault.ElasticPlan.for_devices(200, model_axis=16)
    assert p2.data == 8


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_batches_equal_the_references(arch):
    shape = (32, 4)
    ref = JPipe(JC.get_smoke(arch), JShape("t", *shape, "train"), seed=7)
    port = SyntheticPipeline(TC.get_smoke(arch), ShapeConfig("t", *shape, "train"), seed=7)
    for step in (0, 11):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_snapshot_and_restore():
    cfg = TC.get_smoke("llama2_7b")
    shape = ShapeConfig("t", 32, 4, "train")
    p1 = SyntheticPipeline(cfg, shape, seed=7)
    it = iter(p1)
    next(it), next(it)
    snap = p1.snapshot()
    assert snap == {"step": 1, "seed": 7}      # the second batch is out, not yet past
    p3 = SyntheticPipeline(cfg, shape, seed=0)
    p3.restore(snap)
    np.testing.assert_array_equal(p3.batch_at(p3.state.step)["tokens"],
                                  p1.batch_at(p1.state.step)["tokens"])


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _grad_trees(dtype: torch.dtype, seed: int = 0):
    """(jax params, jax grads, torch params, torch grads) of one tree, the
    same numbers on both sides; the gradients are large enough to clip."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "layers": {"wi": (3, 5, 7), "b": (7,)}, "s": ()}
    p = {}
    g = {}
    for key, shp in flatten(shapes):
        p[key] = rng.normal(size=shp).astype(np.float32)
        g[key] = (3.0 * rng.normal(size=shp)).astype(np.float32)

    def nest(flat):
        return {"w": flat["w"], "s": flat["s"],
                "layers": {"wi": flat["layers/wi"], "b": flat["layers/b"]}}

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), nest(p))
    jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), nest(g))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tg = bridge.params_from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
    return jp, jg, tp, tg


def test_schedule_against_the_reference():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg = jadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(jadamw.schedule(jcfg, jnp.int32(step))),
                                           rel=1e-6)
    assert float(adamw.schedule(cfg, 0)) == pytest.approx(0.1)
    assert float(adamw.schedule(cfg, 99)) == pytest.approx(0.1, rel=0.05)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_clip_by_global_norm_against_the_reference(dtype):
    jp, jg, tp, tg = _grad_trees(dtype)
    want, jnorm = jadamw.clip_by_global_norm(jg, 1.0)
    got, norm = adamw.clip_by_global_norm(tg, 1.0)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-5)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    for (k, a), (_, b) in zip(flatten(got), flatten(jax.tree.map(np.asarray, want))):
        assert a.dtype == dtype, k
        assert rel_err(a, b) < tol, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_against_the_reference(dtype, monkeypatch):
    """Three steps from the same gradients, each leaf updated in slices (a
    slice size below every leaf's): params, both moments, the counter."""
    monkeypatch.setattr(adamw, "CHUNK", 8)
    jp, jg, tp, tg = _grad_trees(dtype)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    js, ts = jadamw.init(jp), adamw.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
    for _ in range(3):
        jp, js, jnorm = jadamw.update(jp, jg, js, jcfg)
        tp, ts, norm = adamw.update(tp, tg, ts, tcfg)
        assert float(norm) == pytest.approx(float(jnorm), rel=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 3
    for name, got, want in (("params", tp, jp), ("m", ts["m"], js["m"]),
                            ("v", ts["v"], js["v"])):
        for (k, a), (_, b) in zip(flatten(got), flatten(jax.tree.map(np.asarray, want))):
            assert a.dtype == (dtype if name == "params" else torch.float32), (name, k)
            assert rel_err(a, b) < tol, (name, k)


def test_adamw_decreases_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.5
