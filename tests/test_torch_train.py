"""The port's training stack against the JAX package: the train step's loss
and gradients for every family, the optimizer step on a model's tree, the
training specs, the compressed data-parallel step and the train driver.

Weights are the reference's `init_params` draws (recurrent and norm leaves
redrawn away from their init values) carried across by
`bridge.params_from_numpy`; batches are the reference pipeline's numpy
arrays.  Remat and strided microbatching change no value (the mean over two
equal microbatches is the mean over the batch), so one reference
``jax.value_and_grad`` a family holds all four of the port's modes.  fp32
within 2e-4 relative to each leaf's max (the reference's kernel tolerance).
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import SyntheticPipeline as JPipe
from repro.distributed.collectives import ErrorFeedback as JErrorFeedback
from repro.launch import sharding as JSH
from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import bridge
from repro_torch.analysis.surface import abstract_params
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.collectives import ErrorFeedback
from repro_torch.launch import mesh as LM
from repro_torch.launch import sharding as TSH
from repro_torch.launch import steps as TS
from repro_torch.launch import train
from repro_torch.models import layers as TL
from repro_torch.optim import adamw
from repro_torch.tree import flatten, tree_map
from torch_helpers import FP32_TOL, flat_tree, redraw_recurrent_leaves, rel_err
import torch_train_ranks as R

ARCHS = ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b", "mamba2_370m",
         "zamba2_2p7b", "hubert_xlarge", "llava_next_34b"]
BIASES = ("ln1_b", "ln2_b", "final_b", "bi", "bdown", "bq", "bkv")
ALL_IDS = sorted(set(JC.ARCH_IDS) | set(JC.PAPER_IDS))
BATCH, SEQ = 4, 16


def _bridged(arch: str):
    """(jax params, torch params) of `arch`'s smoke config, recurrent leaves,
    norm weights and biases redrawn."""
    tree = jax.tree.map(np.asarray, JM.init_params(JC.get_smoke(arch), jax.random.PRNGKey(0)))
    redraw_recurrent_leaves(tree, 31)
    rng = np.random.default_rng(37)
    for path, leaf in list(flat_tree(tree)):
        *parents, key = path.split("/")
        if key in BIASES:
            node = tree
            for k in parents:
                node = node[k]
            node[key] = rng.normal(scale=0.1, size=leaf.shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), bridge.params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """Per family, once: the bridged weights, the batch, and the reference's
    (loss, grads) from ``jax.value_and_grad`` of its train-step loss."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = JC.get_smoke(arch)
            jp, tp = _bridged(arch)
            batch = JPipe(cfg, JShape("t", SEQ, BATCH, "train")).batch_at(0)

            def loss_fn(p, b):
                return JS.cross_entropy(JM.forward(cfg, p, b, remat=False), b["labels"])

            jl, jg = jax.jit(jax.value_and_grad(loss_fn))(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[arch] = (jp, tp, batch, float(jl), jax.tree.map(np.asarray, jg))
        return cache[arch]

    return get


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_cross_entropy_against_the_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(scale=3.0, size=(3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = float(JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=FP32_TOL)
    got16 = TS.cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert got16.dtype == torch.float32


@pytest.mark.parametrize("n_mb", [1, 2])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_against_value_and_grad(reference, arch, remat, n_mb):
    jp, tp, batch, jloss, jgrads = reference(arch)
    loss, grads = TS.make_loss_and_grads(TC.get_smoke(arch), n_mb, remat)(tp, _torch_batch(batch))
    assert float(loss) == pytest.approx(jloss, rel=FP32_TOL)
    want = dict(flatten(jgrads))
    got = dict(flatten(grads))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == want[key].shape, key
        assert rel_err(g, want[key]) < FP32_TOL, key
    assert all(p.grad is None and not p.requires_grad for _, p in flatten(tp))


def test_train_step_updates_params_from_the_same_gradients(reference):
    """One optimizer step of the model's whole tree from the reference's
    gradients, against the reference's `adamw.update`; and the port's train
    step is `make_loss_and_grads` then `adamw.update`."""
    jp, tp, batch, _, jgrads = reference("llama2_7b")
    opt_kw = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    jnew, _, jnorm = jax.jit(jadamw.update, static_argnums=3)(
        jp, jax.tree.map(jnp.asarray, jgrads), jadamw.init(jp), jadamw.AdamWConfig(**opt_kw))
    params = tree_map(torch.clone, tp)
    new, state, norm = adamw.update(params, bridge.params_from_numpy(jgrads, device="cpu"),
                                    adamw.init(params), adamw.AdamWConfig(**opt_kw))
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-5)
    want = dict(flatten(jax.tree.map(np.asarray, jnew)))
    for key, p in flatten(new):
        assert rel_err(p, want[key]) < FP32_TOL, key

    cfg = TC.get_smoke("llama2_7b")
    loss, grads = TS.make_loss_and_grads(cfg)(tp, _torch_batch(batch))
    direct, _, direct_norm = adamw.update(tree_map(torch.clone, tp), grads, adamw.init(tp),
                                          adamw.AdamWConfig(**opt_kw))
    params = tree_map(torch.clone, tp)
    step_loss, stepped, state, step_norm = TS.make_train_step(
        cfg, adamw.AdamWConfig(**opt_kw))(params, adamw.init(params), _torch_batch(batch))
    assert float(step_loss) == float(loss) and float(step_norm) == float(direct_norm)
    assert int(state["step"]) == 1
    for (key, a), (_, b) in zip(flatten(stepped), flatten(direct)):
        assert torch.equal(a, b), key


def test_attend_checkpoints_its_query_chunks_under_grad(monkeypatch):
    """At T = 4096 (past ATTN_CHUNK_THRESHOLD) the chunked path's gradients
    equal the unchunked attention's, each chunk runs under a checkpoint
    while autograd records, and none does without grad."""
    from torch.utils import checkpoint as ckpt

    cfg = TC.get_smoke("llama2_7b")
    t = 4096
    rng = np.random.default_rng(3)
    q0, k0, v0 = (torch.from_numpy(rng.normal(size=(1, t, h, 8)).astype(np.float32))
                  for h in (2, 1, 1))
    calls = []
    real = ckpt.checkpoint
    monkeypatch.setattr(ckpt, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        TL.attend(cfg, q0, k0, v0, causal=True)
    assert not calls
    grads = []
    for chunked in (True, False):
        q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
        out = (TL.attend(cfg, q, k, v, causal=True) if chunked
               else TL._attend_dense(cfg, q, k, v, True))
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        grads.append([q.grad, k.grad, v.grad])
    assert len(calls) == t // TL.ATTN_CHUNK_Q
    for got, want in zip(*grads):
        assert rel_err(got, want) < FP32_TOL


def test_remat_keeps_one_boundary_activation_a_layer():
    """Forward under remat saves far less for backward than without (the
    saved-tensor bytes of a 4-layer smoke model fall below a third); a
    selective policy that saves the matmuls sees them and leaves the
    gradients as they are, as plain remat does."""
    import dataclasses

    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models import model as TM

    kept = []

    def save_matmuls(ctx, op, *args, **kwargs):
        if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            kept.append(op)
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    cfg = dataclasses.replace(TC.get_smoke("llama2_7b"), n_layers=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(1))
    saved, grads = {}, {}
    for mode, kw in (("off", {}), ("remat", {"remat": True}),
                     ("matmuls", {"remat": True, "remat_policy": save_matmuls})):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        total = [0]

        def pack(t, total=total):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits = TM.forward(cfg, leaves, {"tokens": tokens}, **kw)
        saved[mode] = total[0]
        logits.float().square().mean().backward()
        grads[mode] = tree_map(lambda p: p.grad, leaves)
    assert saved["remat"] < saved["off"] / 3
    assert kept
    for mode in ("remat", "matmuls"):
        for (key, a), (_, b) in zip(flatten(grads[mode]), flatten(grads["off"])):
            assert rel_err(a, b) < FP32_TOL, (mode, key)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def _spec(p) -> tuple:
    return tuple(p)


def _port_mesh():
    return LM.Mesh(("data", "model"), (16, 16), "gloo", {}, {"data": 0, "model": 0})


@pytest.fixture(scope="module")
def meshes():
    return jax.sharding.AbstractMesh((16, 16), ("data", "model")), _port_mesh()


@pytest.mark.parametrize("arch", ALL_IDS)
def test_training_specs_equal_the_references(meshes, arch):
    jmesh, tmesh = meshes
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    jshapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    want = jax.tree_util.tree_flatten_with_path(
        JSH.param_specs(jcfg, jshapes, jmesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {"/".join(str(getattr(k, "key", k)) for k in path): _spec(s) for path, s in want}
    got = TSH.param_specs(tcfg, abstract_params(tcfg), tmesh)
    assert dict(flatten(got)) == want
    assert TSH.opt_specs(got)["step"] == () and TSH.opt_specs(got)["m"] is got
    assert TSH.train_strategy(tcfg, tmesh) == JSH.train_strategy(jcfg, jmesh)
    for name, shape in JC.SHAPES.items():
        tshape = TC.SHAPES[name]
        assert TSH.batch_specs(tcfg, tshape, tmesh) == {
            k: _spec(v) for k, v in JSH.batch_specs(jcfg, shape, jmesh).items()}
        assert TSH.cache_specs(tcfg, tshape, tmesh) == {
            k: _spec(v) for k, v in JSH.cache_specs(jcfg, shape, jmesh).items()}
        for n_data in (1, 16, 64):
            assert TS.pick_microbatches(tcfg, tshape, n_data) == \
                JS.pick_microbatches(jcfg, shape, n_data)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_train_input_specs_equal_the_references(arch):
    """The train step's inputs: names, shapes and dtypes of the reference's
    stand-ins, at a cut shape (the port draws real tensors)."""
    shape = ShapeConfig("t", 64, 4, "train")
    want = JS.input_specs(JC.get(arch), JShape("t", 64, 4, "train"))
    got = TS.input_specs(TC.get(arch), shape, torch.Generator().manual_seed(0), device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), k
    assert int(got["labels"].max()) < TC.get(arch).vocab


# ---------------------------------------------------------------------------
# the compressed data-parallel step
# ---------------------------------------------------------------------------
def test_compressed_dp_step_at_one_rank_against_the_reference(tmp_path):
    """P = 1 (a one-rank gloo group in this process) against the
    reference's step on a one-device mesh, tests/test_drivers.py's case:
    equal losses and gradient norms step by step within 2e-4."""
    import torch.distributed as dist

    cfg, opt_cfg, params, pipe = R.train_case(2)
    jcfg = JC.get_smoke("llama2_7b")
    jparams = tree_map(lambda t: jnp.asarray(t.numpy().copy()), params)
    jopt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=20)
    jstep = jax.jit(JS.make_dp_train_step_compressed(jcfg, jax.make_mesh((1,), ("data",)),
                                                     jopt_cfg))
    jopt, jres = jadamw.init(jparams), JErrorFeedback.init(jparams)
    LM.init_rank(0, 1, backend="gloo", init_method=f"file://{tmp_path / 'store'}")
    try:
        step = TS.make_dp_train_step_compressed(cfg, LM.make_dev_mesh(1, 1), opt_cfg)
        opt, residual = adamw.init(params), ErrorFeedback.init(params)
        for i in range(3):
            batch = pipe.batch_at(i)
            loss, params, opt, residual, gnorm = step(params, opt, residual,
                                                      R.batch_at(pipe, i))
            jl, jparams, jopt, jres, jn = jstep(jparams, jopt, jres,
                                                {k: jnp.asarray(v) for k, v in batch.items()})
            assert float(loss) == pytest.approx(float(jl), rel=FP32_TOL), i
            assert float(gnorm) == pytest.approx(float(jn), rel=FP32_TOL), i
    finally:
        dist.destroy_process_group()


def test_compressed_dp_step_on_two_ranks(tmp_path):
    """P = 2 gloo ranks, each its half of the batch: both end with the same
    parameters, and their losses stay within 3% of the plain step's on the
    whole batch (the reference's bound, tests/test_drivers.py)."""
    n = 2
    LM.run_ranks(R.dp_case, n, backend="gloo", init_method=f"file://{tmp_path / 'store'}",
                 args=(n, str(tmp_path)))
    got = [json.loads((tmp_path / f"dp{n}_r{r}.json").read_text()) for r in range(n)]
    assert got[0]["params_sha256"] == got[1]["params_sha256"]
    assert got[0]["losses"] == got[1]["losses"]
    for dp, plain in zip(got[0]["losses"], got[0]["plain_losses"]):
        assert abs(dp - plain) / abs(plain) < 0.03


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
DRIVER = ["--device", "cpu", "--smoke", "--steps", "8", "--batch", "2", "--seq", "32",
          "--ckpt-every", "3", "--microbatches", "2", "--log-every", "1"]


def test_driver_restarts_and_repeats_the_rerun_step_bit_for_bit(tmp_path, capsys):
    out = train.main(DRIVER + ["--fail-at", "4", "--ckpt-dir", str(tmp_path / "a")])
    assert out["final_step"] == 8 and out["restarts"] == 1
    assert [r["step"] for r in out["restores"]] == [3]
    assert [s.step for s in out["saves"]] == [3, 6, 8]
    text = capsys.readouterr().out
    assert "[restore] resumed from step 3" in text and "done: 8 steps, restarts=1" in text
    clean = train.main(DRIVER + ["--ckpt-dir", str(tmp_path / "b")])
    assert clean["restarts"] == 0 and len(clean["losses"]) == 8
    # steps 0-3, then step 3 again from the checkpoint, then 4-7
    assert out["losses"][:4] + out["losses"][5:] == clean["losses"]
    assert out["losses"][4] == out["losses"][3]
    restored, _ = CheckpointManager(tmp_path / "a").restore(8, like=out["state"])
    for (key, a), (_, b) in zip(flatten(restored), flatten(out["state"])):
        assert torch.equal(a, b), key


def test_driver_trains_every_family(tmp_path):
    for arch in ARCHS:
        out = train.main(["--arch", arch, "--device", "cpu", "--smoke", "--steps", "2",
                          "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path / arch)])
        assert out["final_step"] == 2 and np.isfinite(out["losses"]).all(), arch
