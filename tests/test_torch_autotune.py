"""The port's autotuner (`repro_torch.kernels.autotune`) against the
reference's: the table format, lookup-only and negative caching, the
version guard, JSON entries across the two packages, the ratio bucket, the
Hopper lints over every winner, engine tokens with a tuner attached, and
the keys a served run collects."""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.core.hardware import TPU_V5E as J_TPU
from repro.kernels import autotune as JA
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.analysis.kernel_lints import check_autotune_table
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.kernels import autotune as TA
from repro_torch.kernels import splitk_gemm as G
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import serve

GEMM_SHAPES = [(4, 4096, 2048, 2048), (4, 11008, 2048, 2048), (4, 4096, 16000, 16000),
               (1, 1024, 128, 640), (16, 2048, 256, 512), (128, 4096, 2048, 2048),
               (4, 1000, 96, 32), (3, 5120, 64, 512)]


def _swept(hw=H100_SXM) -> TA.Autotuner:
    tuner = TA.Autotuner(hw)
    for dtype in ("float32", "bfloat16"):
        for shape in GEMM_SHAPES:
            tuner.best_gemm(*shape, dtype)
        tuner.best_paged(32, 32, 128, 16, 10, 0.5, dtype)
        tuner.best_paged(128, 1, 576, 16, 10, 0.4, dtype)
        tuner.best_attn(32, 8, 128, 288, 0.5, dtype)
        tuner.best_prefill(128, 2048, 2048, dtype)
    return tuner


def test_table_round_trip_is_byte_stable_and_reproduces_winners(tmp_path):
    tuner = _swept()
    path = tmp_path / "t.json"
    tuner.save(str(path))
    loaded = TA.Autotuner.load(str(path), sweep=False)
    assert loaded.hw is H100_SXM and loaded.table == tuner.table
    for key, ent in tuner.table.items():
        op, shape, dtype, ratio, _ = key
        got = {"splitk_gemm": lambda: loaded.best_gemm(*shape, dtype),
               "paged_splitk_flashattn": lambda: loaded.best_paged(*shape, ratio, dtype),
               "splitk_flashattn": lambda: loaded.best_attn(*shape, ratio, dtype),
               "flash_prefill": lambda: loaded.best_prefill(*shape, dtype)}[op]()
        assert got == ent.config
    assert loaded.counters() == {"entries": len(tuner.table), "hits": len(tuner.table),
                                 "misses": 0, "sweeps": 0}
    again = tmp_path / "again.json"
    loaded.save(str(again))
    assert again.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("hd,dtype,tiles", [(128, "bfloat16", (128, 128)),
                                             (64, "bfloat16", (128, 128)),
                                             (80, "bfloat16", (128, 64)),
                                             (128, "float32", (64, 64))])
def test_best_prefill_is_the_designs_tile(hd, dtype, tiles):
    """flash_prefill's one candidate is the tile of the design a launch at
    ``hd`` in ``dtype`` takes: the wgmma design's at bf16 hd 64 and 128."""
    got = TA.Autotuner(H100_SXM).best_prefill(hd, 2048, 2048, dtype)
    assert (got["block_q"], got["block_k"]) == tiles


def test_lookup_only_miss_and_negative_cache():
    tuner = TA.Autotuner(sweep=False)
    assert tuner.best_gemm(4, 4096, 2048, 2048) is None
    assert tuner.counters() == {"entries": 0, "hits": 0, "misses": 1, "sweeps": 0}
    sweeping = TA.Autotuner()
    assert sweeping.best_gemm(4, 4096, 0, 2048) is None      # an empty tier: no key at all
    # no candidate passes the lints (hd beyond the kernels' 1024): a negative entry
    assert sweeping.best_paged(8, 1, 2048, 16, 10) is None
    assert sweeping.counters() == {"entries": 1, "hits": 0, "misses": 1, "sweeps": 1}
    assert sweeping.best_paged(8, 1, 2048, 16, 10) is None
    assert sweeping.counters()["hits"] == 1 and sweeping.counters()["sweeps"] == 1
    assert next(iter(sweeping.table.values())).config is None
    assert sweeping.validate() == []                          # nothing is launched for it


def test_version_guard(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"version": TA.TABLE_VERSION + 1, "entries": []}))
    with pytest.raises(ValueError, match="autotune table version"):
        TA.Autotuner.load(str(path))
    assert TA.TABLE_VERSION == JA.TABLE_VERSION


def test_entries_cross_between_the_packages(tmp_path):
    """An Entry the reference writes loads in the port and the other way
    round: the JSON table format is one."""
    jt = JA.Autotuner(J_TPU)
    jt.best_gemm(128, 512, 256, 256)
    jt.best_paged(8, 2, 64, 8, 16, 0.5)
    jt.best_prefill(64, 256, 256)
    jpath = tmp_path / "jax.json"
    jt.save(str(jpath))
    tt = TA.Autotuner.load(str(jpath), sweep=False)
    assert tt.hw.name == "tpu_v5e"
    assert {k: e.to_json() for k, e in tt.table.items()} == \
        {k: e.to_json() for k, e in jt.table.items()}
    tpath = tmp_path / "torch.json"
    _swept().save(str(tpath))
    back = JA.Autotuner.load(str(tpath), sweep=False)
    assert [e.to_json() for e in back.table.values()] == \
        [TA.Entry.from_json(d).to_json() for d in json.loads(tpath.read_text())["entries"]]
    tt2 = TA.Autotuner.load(str(tpath), sweep=False)
    tt2.save(str(tmp_path / "torch2.json"))
    assert (tmp_path / "torch2.json").read_bytes() == tpath.read_bytes()


def test_ratio_bucket_equals_the_reference():
    for n_loc in range(0, 130, 7):
        for n_rem in range(0, 130, 5):
            assert TA._ratio_bucket(n_loc, n_rem) == JA._ratio_bucket(n_loc, n_rem)


@pytest.mark.parametrize("hw", [H100_SXM, T_TPU])
def test_every_winner_passes_the_hopper_lints(hw):
    tuner = _swept(hw)
    entries = [e.to_json() for e in tuner.table.values()]
    # MLA's fp32 pages of 16 x 576 leave the head-group design's ring one
    # stage under RING_MAX at any window (DAK101 names the clamp), so no
    # candidate wins: a negative entry, and the engine keeps its own window
    # there; bf16 runs the cluster design, whose ring fits
    assert [(e["shape"], e["dtype"]) for e in entries if e["config"] is None] == \
        [([128, 1, 576, 16, 10], "float32")]
    assert tuner.validate() == [] and check_autotune_table(entries) == []
    gemm = [e for e in entries if e["op"] == "splitk_gemm"]
    assert {e["config"]["window"] for e in gemm} <= set(TA.WINDOW_CANDIDATES)
    assert all(e["config"]["k_split"] % 32 == 0 for e in gemm)
    # M > 16 has no split-K candidate: fp32 takes whole K, bf16 the cluster
    # design (whole 64-row boxes), never whole K
    assert all(e["config"]["k_split"] == 0 for e in gemm
               if e["shape"][0] > 16 and e["dtype"] == "float32")
    assert all(e["config"]["k_split"] > 0 and e["config"]["k_split"] % G.CLUSTER_BK == 0
               for e in gemm if e["shape"][0] > 16 and e["dtype"] == "bfloat16")
    assert any(e["shape"][0] > 16 and e["dtype"] == "bfloat16" for e in gemm)
    # a hand-edited window past the split-K ring's shared-memory cap is refused
    bad = dict(gemm[0], config={"k_split": 4096, "window": 64}, dtype="float32")
    assert {f.rule for f in check_autotune_table([bad])} == {"DAK101"}


def test_candidates_clamped_to_one_ring_count_once():
    """K = 96: a split-K CTA has at most 3 loads, so windows 3..8 are the
    same kernel as window 3 and only the smallest is swept."""
    tuner = TA.Autotuner()
    seen = []
    tuner._gemm_ok = lambda m, k, nl, nr, ks, w, db: seen.append((ks, w)) or True
    tuner.best_gemm(4, 96, 64, 64)
    assert [w for ks, w in seen if ks == 96] == [1, 2, 3]
    assert [w for ks, w in seen if ks == 0] == [1, 2, 3]


@pytest.mark.parametrize("jit", [True, False])
def test_tuned_engine_tokens_equal_untuned(jit):
    cfg = TC.get_smoke("llama2_7b")
    tree = jax.tree.map(np.asarray, JM.init_params(JC.get_smoke("llama2_7b"),
                                                   jax.random.PRNGKey(0)))
    params = bridge.params_from_numpy(tree, device="cpu")
    runs = []
    for tuner in (None, TA.Autotuner()):
        _, reqs = serve(TEngine, TRequest, cfg, params, H100_SXM, 0.5, 7, jit_step=jit,
                        tuner=tuner, device="cpu")
        runs.append([r.out_tokens for r in reqs])
    assert runs[0] == runs[1] and all(runs[0])


def test_autotune_keys_and_counters_equal_the_jax_engine():
    """hw = TPU_V5E on both sides: the keys a port engine collects on one
    smoke llama2-7b run (graphed; lookups while a bucket first runs) equal
    those of the JAX engine's jitted step, and so do its counters."""
    jcfg, tcfg = JC.get_smoke("llama2_7b"), TC.get_smoke("llama2_7b")
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    jt, tt = JA.Autotuner(J_TPU), TA.Autotuner(T_TPU)
    serve(JEngine, JRequest, jcfg, jax.tree.map(jax.numpy.asarray, tree), J_TPU, 0.5, 7,
          new_tokens=4, jit_step=True, tuner=jt)
    serve(TEngine, TRequest, tcfg, bridge.params_from_numpy(tree, device="cpu"), T_TPU, 0.5,
          7, new_tokens=4, jit_step=True, tuner=tt, device="cpu")
    assert set(tt.table) == set(jt.table) and len(tt.table) >= 5
    assert tt.counters() == jt.counters()


@pytest.mark.parametrize("m,reads", [(512, 1), (2048, 2)])
def test_gemm_cost_reads_the_remote_tier_once_per_cluster(m, reads):
    """At bf16 past 16 rows the candidates are the cluster design's splits
    alone, whose modeled cost reads the remote tier once per cluster of M
    tiles (`gemm_tiling(...).reads`), where whole K read it once per M tile
    of 128 rows: the costs stand about in the ratio of the reads."""
    tuner = TA.Autotuner(H100_SXM)
    shape = (m, 4096, 11008, 11008)
    splits = tuner.gemm_k_splits(*shape, 2)
    assert splits and 0 not in splits and all(ks % G.CLUSTER_BK == 0 for ks in splits)
    assert [G.gemm_tiling(*shape, 2, k_split=ks).reads for ks in splits] == [reads] * len(splits)
    whole_reads = G.gemm_tiling(*shape, 2, k_split=0).reads
    assert whole_reads == m // 128
    ratio = tuner._gemm_cost(*shape, 0, 2, 2) / tuner._gemm_cost(*shape, splits[0], 2, 2)
    assert 0.9 * whole_reads / reads < ratio < 1.1 * whole_reads / reads
    assert tuner.best_gemm(*shape, "bfloat16")["k_split"] in splits
