"""The port's mesh-aware planning, sharding, traffic accounting and
collectives against the JAX package's: the ten cases of
tests/test_mesh_plan.py, each on both packages where the reference has the
function, plus the layer-by-layer build under a mesh and
`distributed.collectives` (bitwise quantization against JAX; the
all-reduce family on two gloo ranks, held to numpy).

A rank's view of the mesh needs no process group until it communicates,
so the sharding cases run every rank's `launch.mesh.Mesh` in this process.
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
import torch_mesh_ranks as R
from repro.core import engine as JE
from repro.core import multicast as JMC
from repro.core import tiering as JT
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro.core.hardware import MeshSpec as JMeshSpec
from repro.core.hardware import mesh_hardware as j_mesh_hardware
from repro.distributed import collectives as JColl
from repro.models import model as JM
from repro.runtime.telemetry import weight_link_bytes as j_weight_link_bytes
from repro_torch import bridge
from repro_torch.core import engine as TE
from repro_torch.core import multicast as TMC
from repro_torch.core import tiering as TT
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.core.hardware import MeshSpec as TMeshSpec
from repro_torch.core.hardware import mesh_hardware, mesh_host_bandwidth
from repro_torch.distributed import collectives as TColl
from repro_torch.kernels import ops
from repro_torch.launch import mesh as LM
from repro_torch.launch import sharding as SH
from repro_torch.models import model as TM
from repro_torch.runtime import replan as TRP
from repro_torch.runtime.telemetry import StepSample, Telemetry, TelemetrySource
from repro_torch.runtime.telemetry import weight_link_bytes as t_weight_link_bytes
from torch_helpers import assert_trees_equal

KEY = jax.random.PRNGKey(0)
WL = dict(batch=4, seq_len=64, phase="decode")


def _plans(arch: str, n_dev: int, ratio: float = 0.5):
    """(JAX plan, port plan) of `arch` smoke at `ratio` on an n_dev mesh."""
    jmesh = JMeshSpec(n_devices=n_dev, axis_name="model") if n_dev > 1 else None
    tmesh = TMeshSpec(n_devices=n_dev, axis_name="model") if n_dev > 1 else None
    return (JE.plan(JC.get_smoke(arch), JWorkload(**WL), J_TPU, global_ratio=ratio, mesh=jmesh),
            TE.plan(TC.get_smoke(arch), TWorkload(**WL), T_TPU, global_ratio=ratio, mesh=tmesh))


def _rank_mesh(n: int, rank: int) -> LM.Mesh:
    """Rank `rank`'s view of an n-rank "model" mesh, without a process group."""
    return LM.Mesh(("model",), (n,), "gloo", {}, {"model": rank})


@pytest.fixture(scope="module")
def weights():
    """Each dense family's JAX draws and the same weights in the port."""
    out = {}
    for arch in R.DENSE_ARCHS:
        jp = JM.init_params(JC.get_smoke(arch), KEY)
        out[arch] = (jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _tiered(tree):
    """The `TieredTensor` leaves of a port params tree, in tree order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tiered(v)
        elif isinstance(v, TT.TieredTensor):
            yield v


# -- aggregate-of-links allocator ------------------------------------------
@pytest.mark.parametrize("n_dev", [2, 4])
def test_mesh_allocator_solves_on_aggregate_links(n_dev):
    jplan, plan = _plans("llama2_7b", n_dev)
    assert plan.mesh is not None and plan.mesh.n_devices == n_dev
    assert plan.mesh.aggregate_host_bw == pytest.approx(mesh_host_bandwidth(T_TPU, n_dev))
    assert plan.mesh.aggregate_host_bw == pytest.approx(jplan.mesh.aggregate_host_bw)
    assert plan.mesh.aggregate_host_bw > T_TPU.host.bandwidth
    assert plan.op_ratios == pytest.approx(jplan.op_ratios)
    total_c = sum(op.bytes for op in plan.ops)
    offloaded = sum(op.bytes * plan.op_ratios[op.name] for op in plan.ops)
    assert offloaded == pytest.approx(plan.global_ratio * total_c, rel=1e-6)
    assert plan.latency <= _plans("llama2_7b", 1)[1].latency + 1e-12
    assert plan.latency == pytest.approx(jplan.latency)


def test_mesh_hardware_view():
    hw4, jhw4 = mesh_hardware(T_TPU, 4), j_mesh_hardware(J_TPU, 4)
    assert hw4.hbm == T_TPU.hbm and hw4.peak_flops == T_TPU.peak_flops
    assert hw4.host.capacity == 4 * T_TPU.host.capacity == jhw4.host.capacity
    ici = T_TPU.ici_link_bw * T_TPU.ici_links
    assert hw4.host.bandwidth == pytest.approx(min(4 * T_TPU.host.bandwidth, ici * 4 / 3))
    assert hw4.host.bandwidth == pytest.approx(jhw4.host.bandwidth)
    assert mesh_hardware(T_TPU, 1) is T_TPU


def test_per_link_windows_match_single_link_solve():
    jplan, plan = _plans("llama2_7b", 4)
    assert len(plan.mesh.link_windows) == 4
    for w, jw in zip(plan.mesh.link_windows, jplan.mesh.link_windows, strict=True):
        assert w.n_inflight == plan.window.n_inflight == jw.n_inflight
        assert w.n_streams == 1


# -- mesh-divisible partitioning -------------------------------------------
@pytest.mark.parametrize("arch", R.DENSE_ARCHS)
@pytest.mark.parametrize("n_dev", [2, 4])
def test_partition_slices_reassemble(weights, arch, n_dev):
    """Every remote extent divides the mesh; the ranks' 1/P slices are
    disjoint, equal and concatenate back to the JAX package's host
    partition bit for bit.  The layer-by-layer build on each rank equals
    sharding the whole partition, and pins only that rank's slices."""
    jparams, tparams = weights[arch]
    jplan, plan = _plans(arch, n_dev)
    whole = plan.partition(tparams, align=32)
    jleaves = [leaf for leaf in jax.tree.leaves(
        jplan.partition(jparams, align=32), is_leaf=lambda x: isinstance(x, JT.TieredArray))
        if isinstance(leaf, JT.TieredArray)]
    shards = []
    for rank in range(n_dev):
        mesh = _rank_mesh(n_dev, rank)
        sharded = SH.shard_tiered_params(whole, mesh, "model")
        built = plan.partition_source(TM.LayerSource.from_tree(tparams), align=32, mesh=mesh)
        for got, want in zip(_tiered(built), _tiered(sharded), strict=True):
            assert got.mesh_axes == want.mesh_axes == "model"
            assert torch.equal(got.shard, want.shard) and torch.equal(got.local, want.local)
            assert got.remote.shape == want.remote.shape
        shards.append(list(_tiered(sharded)))
    assert jleaves and len(jleaves) == len(shards[0])
    for i, jleaf in enumerate(jleaves):
        dim = jleaf.remote.shape[jleaf.axis]
        assert dim % n_dev == 0, f"remote extent {dim} not divisible into {n_dev} slices"
        parts = [s[i].shard for s in shards]
        assert all(p.shape == parts[0].shape for p in parts)
        rebuilt = torch.cat(parts, dim=shards[0][i].axis)
        np.testing.assert_array_equal(rebuilt.numpy(), np.asarray(jleaf.remote))


def test_partition_zero_ratio_has_no_tiers(weights):
    _, plan = _plans("llama2_7b", 4, ratio=0.0)
    tiered = plan.partition(weights["llama2_7b"][1], align=32)
    assert not list(_tiered(tiered))
    sharded = SH.shard_tiered_params(tiered, _rank_mesh(4, 0), "model")
    assert_trees_equal(sharded, tiered)


# -- fetch-once traffic accounting vs the multicast oracle ------------------
@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_fetch_oracle_drops_per_link_traffic(n_dev):
    rep, jrep = TMC.sharded_fetch_report(1 << 20, n_dev), JMC.sharded_fetch_report(1 << 20, n_dev)
    assert rep.traffic_no_multicast == pytest.approx(
        (1 << 20) * n_dev * TMC.GRANULARITY_OVERHEAD)
    assert rep.traffic_multicast == pytest.approx((1 << 20) * TMC.GRANULARITY_OVERHEAD)
    assert rep.traffic_no_multicast / rep.traffic_multicast == pytest.approx(n_dev)
    assert (rep.traffic_multicast, rep.traffic_no_multicast) == \
        (jrep.traffic_multicast, jrep.traffic_no_multicast)


def test_weight_link_bytes_matches_oracle_within_1pct(weights):
    """The copied per-link accounting reads a rank's sharded tree (global
    remote extents) exactly as the reference reads its global arrays."""
    n_dev = 4
    jparams, tparams = weights["llama2_7b"]
    jplan, plan = _plans("llama2_7b", n_dev)
    tiered = plan.partition(tparams, align=32)
    sharded = SH.shard_tiered_params(tiered, _rank_mesh(n_dev, 1), "model")
    jtagged = jax.tree.map(
        lambda leaf: JT.TieredArray(leaf.local, leaf.remote, leaf.axis, mesh_axes="model")
        if isinstance(leaf, JT.TieredArray) else leaf,
        jplan.partition(jparams, align=32), is_leaf=lambda x: isinstance(x, JT.TieredArray))
    links = t_weight_link_bytes(sharded, n_dev)
    assert links == pytest.approx(j_weight_link_bytes(jtagged, n_dev))
    total_remote = sum(leaf.remote.nbytes for leaf in _tiered(sharded))
    assert total_remote == sum(leaf.shard.nbytes for leaf in _tiered(sharded)) * n_dev
    oracle = TMC.sharded_fetch_report(total_remote, n_dev)
    ov = TMC.GRANULARITY_OVERHEAD
    for link in links:
        assert link * ov == pytest.approx(oracle.traffic_multicast / n_dev, rel=0.01)
    assert sum(links) * ov == pytest.approx(oracle.traffic_no_multicast / n_dev, rel=0.01)
    assert t_weight_link_bytes(tiered, 1)[0] == pytest.approx(total_remote)


def test_replan_keeps_the_device_axis(weights):
    """A re-plan stays on the mesh, and its re-split leaves shard again."""
    cfg = TC.get_smoke("llama2_7b")
    _, plan = _plans("llama2_7b", 4)
    rp = TRP.Replanner(cfg, T_TPU, plan)
    tel = Telemetry()
    for step in range(6):   # all-prefill mix: forces drift past threshold
        tel.record(StepSample(step=step, duration_s=1e-3, prefill_tokens=64, decode_tokens=0,
                              queue_depth=0, active_slots=0, mean_kv_len=0.0, local_bytes=1e6,
                              remote_bytes=1e6, window=2))
    new = rp.maybe_replan(tel)
    assert new is not None and new.mesh is not None
    assert new.mesh.n_devices == 4 and new.mesh.axis_name == "model"
    tiered = plan.partition(weights["llama2_7b"][1], align=32)
    reparted, _ = TRP.repartition(tiered, new, align=32)
    for leaf in _tiered(reparted):
        assert leaf.remote.shape[leaf.axis] % 4 == 0
    # a re-plan that moves splits: the re-split leaves shard again
    moved = _plans("llama2_7b", 4, ratio=0.75)[1]
    reparted, changed = TRP.repartition(tiered, moved, align=32)
    assert changed
    resharded = SH.shard_tiered_params(reparted, _rank_mesh(4, 2), "model")
    for leaf in _tiered(resharded):
        assert leaf.remote.shape[leaf.axis] % 4 == 0 and leaf.mesh_axes == "model"


def test_telemetry_source_resolves_links():
    tel = Telemetry()
    tel.record(StepSample(step=0, duration_s=1.0, prefill_tokens=0, decode_tokens=4,
                          queue_depth=0, active_slots=4, mean_kv_len=8.0, local_bytes=0.0,
                          remote_bytes=40.0, window=2, remote_bytes_per_link=(10.0, 30.0)))
    src = TelemetrySource(tel)
    assert src.measure(2).host_bw == pytest.approx(40.0)       # aggregate
    assert src.measure_link(0, 2).host_bw == pytest.approx(10.0)
    assert src.measure_link(1, 2).host_bw == pytest.approx(30.0)
    assert src.measure_link(5, 2).host_bw == pytest.approx(40.0)  # fallback


def test_tiered_tensor_mesh_tag_survives_layer_indexing():
    """The port's counterpart of the pytree-aux case: indexing the layer
    axis keeps the tag and slices the rank's shard with the tiers."""
    t = TT.TieredTensor(torch.zeros(3, 2, 4), torch.zeros(3, 2, 4), axis=-1,
                        mesh_axes="model", shard=torch.arange(3 * 2 * 2.0).reshape(3, 2, 2))
    t1 = t[1]
    assert t1.mesh_axes == "model" and t1.axis == -1 and t1.shape == (2, 8)
    assert torch.equal(t1.shard, t.shard[1])
    assert TT.TieredTensor(torch.zeros(2), torch.zeros(2)).mesh_axes is None


def test_gather_refuses_mismatched_slices():
    """A slice that does not fit the buffer it would gather into raises
    before any rank communicates."""
    out = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="takes slices"):
        ops.gather_shards(_rank_mesh(4, 0), "model", torch.zeros(2, 3), out, -1)
    with pytest.raises(ValueError, match="takes slices"):
        ops.gather_shards(_rank_mesh(4, 0), "model", torch.zeros(2, 2, dtype=torch.float64),
                          out, -1)


# -- collectives -------------------------------------------------------------
def test_quantize_int8_matches_jax_bitwise():
    x = np.random.default_rng(3).normal(size=(5, 7)).astype(np.float32) * 3
    q, s = TColl.quantize_int8(torch.from_numpy(x))
    jq, js = JColl.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(TColl.dequantize_int8(q, s).numpy(),
                                  np.asarray(JColl.dequantize_int8(jq, js)))
    g = {"w": torch.from_numpy(x)}
    g2, e2 = TColl.ErrorFeedback.apply(g, TColl.ErrorFeedback.init(g))
    jg2, je2 = JColl.ErrorFeedback.apply({"w": jnp.asarray(x)},
                                         JColl.ErrorFeedback.init({"w": jnp.asarray(x)}))
    np.testing.assert_array_equal(g2["w"].numpy(), np.asarray(jg2["w"]))
    np.testing.assert_array_equal(e2["w"].numpy(), np.asarray(je2["w"]))


def _np_quantize(x: np.ndarray) -> tuple[np.ndarray, np.float32]:
    scale = np.float32(np.max(np.abs(x)) / np.float32(127.0) + np.float32(1e-30))
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8), scale


def test_collectives_on_two_ranks(tmp_path):
    """compressed_psum after error feedback, reduce_scatter_grads and
    all_gather_params on two gloo ranks, against numpy."""
    n = 2
    LM.run_ranks(R.collective_cases, n, backend="gloo",
                 init_method=f"file://{tmp_path / 'store'}", args=(n, str(tmp_path)))
    got = [json.loads((tmp_path / f"coll{n}_r{r}.json").read_text()) for r in range(n)]
    grads = [{"w": np.random.default_rng(r).normal(size=(4, 6)).astype(np.float32),
              "b": np.random.default_rng(100 + r).normal(size=(3,)).astype(np.float32)}
             for r in range(n)]
    for key in ("w", "b"):
        deq, qs, scales = [], [], []
        for g in grads:
            q, s = _np_quantize(g[key])
            deq.append(q.astype(np.float32) * s)       # error feedback's compressed grad
            q2, s2 = _np_quantize(deq[-1])             # compressed_psum's own quantization
            qs.append(q2.astype(np.int32))
            scales.append(s2)
        mean_scale = np.float32(sum(scales) / n)
        want = sum(qs).astype(np.float32) * mean_scale
        plain = sum(deq)
        # the int8 step of the scheme: each rank's rounding plus its scale's
        # distance from the mean scale the sum is dequantized with
        step = sum(np.abs(q) * abs(s - mean_scale) for q, s in zip(qs, scales)) + n * max(scales)
        for r in range(n):
            psum = np.asarray(got[r]["psum"][key], np.float32)
            np.testing.assert_allclose(psum, want, rtol=1e-6, atol=1e-7)
            assert np.all(np.abs(psum - plain) <= step)
            resid = np.asarray(got[r]["residual"][key], np.float32)
            np.testing.assert_allclose(resid, grads[r][key] - deq[r], atol=1e-7)
    total = {k: sum(g[k] for g in grads) for k in ("w", "b")}
    for r in range(n):
        np.testing.assert_allclose(got[r]["scattered"]["w"], total["w"][2 * r:2 * r + 2],
                                   rtol=1e-6)
        np.testing.assert_allclose(got[r]["scattered"]["b"], total["b"], rtol=1e-6)
        np.testing.assert_allclose(got[r]["gathered"]["w"], total["w"], rtol=1e-6)
        np.testing.assert_allclose(got[r]["gathered"]["b"], np.concatenate([total["b"]] * n),
                                   rtol=1e-6)
