"""The port's page-table audit and plan checks (`repro_torch.analysis`)
against the reference's (`repro.analysis`): the same plans and cache
states, corrupted ones included (as tests/test_analysis.py builds them),
give the same findings, rule, site and evidence alike.  Then the live
engine hook: ``check_invariants=True`` leaves a graphed CPU run bitwise
unchanged, raises on a corrupted free list, and ``--check-invariants``
serves every paged family's smoke config clean."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.analysis import page_table as JPT
from repro.analysis import plan_checks as JPC
from repro.core import engine as JE
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro.models import model as JM
from repro.serving.paged_cache import PagedTieredCache as JCache
from repro_torch import bridge
from repro_torch.analysis import RULES, InvariantViolation
from repro_torch.analysis import page_table as TPT
from repro_torch.analysis import plan_checks as TPC
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.paged_cache import PagedTieredCache as TCache
from torch_helpers import SERVE_PROMPT_LENS


def _same(t_findings, j_findings) -> list[tuple[str, str, str]]:
    """The findings of both sides as (rule, where, detail), asserted equal."""
    t = [(f.rule, f.where, f.detail) for f in t_findings]
    assert t == [(f.rule, f.where, f.detail) for f in j_findings]
    return t


def _plans(arch: str, ratio: float, n_dev: int = 1, smoke: bool = False):
    jcfg = (JC.get_smoke if smoke else JC.get)(arch)
    tcfg = (TC.get_smoke if smoke else TC.get)(arch)
    wl = dict(batch=4, seq_len=256, dtype_bytes=2, phase="decode")
    jmesh = JE.MeshSpec(n_devices=n_dev) if n_dev > 1 else None
    tmesh = TE.MeshSpec(n_devices=n_dev) if n_dev > 1 else None
    return (JE.plan(jcfg, JWorkload(**wl), J_TPU, global_ratio=ratio, mesh=jmesh),
            TE.plan(tcfg, TWorkload(**wl), T_TPU, global_ratio=ratio, mesh=tmesh))


def test_rule_registry_is_the_reference_one():
    from repro.analysis.findings import RULES as J_RULES

    assert RULES == J_RULES


# ---------------------------------------------------------------------------
# DAK201-205 — plan checks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def llama_plans():
    return _plans("llama2_7b", 0.5)


def _corrupt_budget(plan):
    return dataclasses.replace(plan, global_ratio=0.9)


def _corrupt_registry(plan):
    return dataclasses.replace(plan, op_ratios={**plan.op_ratios, "phantom": 0.5})


def _corrupt_window(plan):
    return dataclasses.replace(
        plan, window=dataclasses.replace(plan.window,
                                         aggregate_bw=plan.window.aggregate_bw * 0.5))


@pytest.mark.parametrize("rule,check,corrupt", [
    ("DAK201", lambda pc, plan, side: pc.check_budget(plan), _corrupt_budget),
    ("DAK202", lambda pc, plan, side: pc.check_registry(
        plan, (JC if side == "jax" else TC).get("llama2_7b")), _corrupt_registry),
    ("DAK203", lambda pc, plan, side: pc.check_window(
        plan, J_TPU if side == "jax" else T_TPU), _corrupt_window),
], ids=["DAK201", "DAK202", "DAK203"])
def test_plan_check_findings_equal_reference(llama_plans, rule, check, corrupt):
    """Clean plans give no finding on either side; the corrupted plan gives
    the reference's findings exactly."""
    jplan, tplan = llama_plans
    assert _same(check(TPC, tplan, "torch"), check(JPC, jplan, "jax")) == []
    found = _same(check(TPC, corrupt(tplan), "torch"), check(JPC, corrupt(jplan), "jax"))
    assert rule in {f[0] for f in found}


@pytest.mark.parametrize("arch", ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
                                  "mamba2_370m", "zamba2_2p7b"])
def test_check_plan_is_clean_like_reference(arch):
    """`check_plan` (DAK201/202/203/205) over every served family's full
    config at offload 0.5: no finding on either side."""
    jplan, tplan = _plans(arch, 0.5)
    assert _same(TPC.check_plan(tplan, T_TPU, TC.get(arch)),
                 JPC.check_plan(jplan, J_TPU, JC.get(arch))) == []


def test_dak204_repartition_findings_equal_reference():
    """A tree realizing the 0.5 plan is a fixed point of it and not of the
    1.0 plan: the same operands moved on both sides."""
    (jhalf, thalf), (jfull, tfull) = (_plans("llama2_7b", r, smoke=True) for r in (0.5, 1.0))
    jparams = JM.init_params(JC.get_smoke("llama2_7b"), jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    jtiered, ttiered = jhalf.partition(jparams, align=32), thalf.partition(tparams, align=32)
    assert _same(TPC.check_repartition_idempotent(ttiered, thalf, align=32),
                 JPC.check_repartition_idempotent(jtiered, jhalf, align=32)) == []
    found = _same(TPC.check_repartition_idempotent(ttiered, tfull, align=32),
                  JPC.check_repartition_idempotent(jtiered, jfull, align=32))
    assert {f[0] for f in found} == {"DAK204"}


def test_dak205_mesh_findings_equal_reference():
    jplan, tplan = _plans("llama2_7b", 0.5, n_dev=4)
    found = _same(TPC.check_mesh(tplan, T_TPU, [("w", 512, 130)]),
                  JPC.check_mesh(jplan, J_TPU, [("w", 512, 130)]))
    assert "DAK205" in {f[0] for f in found}
    assert TPC.check_mesh(tplan, T_TPU, [("w", 512, 128)]) == []
    single = _plans("llama2_7b", 0.5)[1]
    assert single.mesh is None and TPC.check_mesh(single, T_TPU, [("w", 512, 130)]) == []


# ---------------------------------------------------------------------------
# DAK301-305 — page-table invariants
# ---------------------------------------------------------------------------
def _caches():
    """The reference test's cache on both sides: two in-use local pages on
    slot 0."""
    kw = dict(page_size=4, local_pages=4, remote_pages=4, max_slots=2, max_pages_per_slot=4)
    jcache = JCache(1, 1, 4, dtype=np.float32, **kw)
    tcache = TCache(1, 1, 4, dtype=torch.float32, device="cpu", **kw)
    for c in (jcache, tcache):
        c.ensure_capacity(0, 8)
    return jcache, tcache


def _free_list(c):
    c.free[0].append(c.free[0][0])           # a duplicated free page


def _phantom_free(c):
    c.free[0].append(99)                     # a free index outside the pool


def _tier_tag(c):
    c.tier[0, 0] ^= 1                        # the tag flips, residency does not


def _alias(c):
    c.table[0, 1] = c.table[0, 0]
    c.tier[0, 1] = c.tier[0, 0]


def _elastic(c):
    c.local_limit = -1                       # bypasses set_local_limit's clamp


def _heat(c):
    c.heat._heat.clear()                     # owned pages become unevictable


@pytest.mark.parametrize("rule,corrupt", [
    ("DAK301", _free_list), ("DAK301", _phantom_free), ("DAK302", _tier_tag),
    ("DAK303", _alias), ("DAK304", _elastic), ("DAK305", _heat),
], ids=["DAK301-dup", "DAK301-phantom", "DAK302", "DAK303", "DAK304", "DAK305"])
def test_page_table_findings_equal_reference(rule, corrupt):
    """The clean cache passes every check on both sides; each corruption
    gives the reference's findings exactly (all five checks run)."""
    jcache, tcache = _caches()
    assert _same(TPT.check_page_table(tcache), JPT.check_page_table(jcache)) == []
    corrupt(jcache)
    corrupt(tcache)
    found = _same(TPT.check_page_table(tcache), JPT.check_page_table(jcache))
    assert rule in {f[0] for f in found}


def test_page_table_scenario_is_clean_like_reference():
    """Allocation, spill, shrink and demotion, growth, promotion and free,
    each followed by the audit."""
    assert TPT.run_scenario() == JPT.run_scenario() == []


# ---------------------------------------------------------------------------
# The live engine hook and the launcher flag
# ---------------------------------------------------------------------------
def _run_engine(check: bool, *, corrupt_after: int | None = None):
    """llama2-7b smoke, graphed (the CPU runs the fixed-buffer step), 3
    slots, page 4, the five prompts that force spills at offload 0.5."""
    cfg = TC.get_smoke("llama2_7b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, params, max_batch=3, max_len=32, global_offload_ratio=0.5,
                        page_size=4, check_invariants=check, device="cpu")
    rng = np.random.default_rng(7)
    reqs = [Request(rid=rid, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=6) for rid, n in enumerate(SERVE_PROMPT_LENS)]
    for r in reqs:
        eng.submit(r)
    if corrupt_after is not None:
        for _ in range(corrupt_after):
            eng.step()
        # a phantom free page at the head of the list (allocation pops the
        # tail, so no step writes it before the audit sees it)
        eng.pcache.free[TPT.LOCAL].insert(0, 99)
    stats = eng.run()
    return eng, stats, [list(r.out_tokens) for r in reqs]


def test_check_invariants_is_bitwise_neutral():
    eng_off, off, toks_off = _run_engine(False)
    eng_on, on, toks_on = _run_engine(True)
    assert eng_on.graphed and eng_on.compile_count >= 1
    assert toks_on == toks_off
    counters = ("served", "decode_steps", "generated_tokens", "spills", "local_pages_hwm",
                "remote_pages_hwm", "prefill_passes")
    assert [getattr(on, f) for f in counters] == [getattr(off, f) for f in counters]
    assert off.spills >= 1
    assert (eng_on.compile_count, eng_on.compile_cache_hits) == \
        (eng_off.compile_count, eng_off.compile_cache_hits)


def test_check_invariants_catches_live_corruption_in_a_graphed_run():
    with pytest.raises(InvariantViolation) as ei:
        _run_engine(True, corrupt_after=2)
    assert "DAK301" in str(ei.value) and "engine.step[" in str(ei.value)
    assert all(f.rule in RULES for f in ei.value.findings)


@pytest.mark.parametrize("arch", ["llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
                                  "zamba2_2p7b"])
def test_check_invariants_flag_serves_smoke_configs_clean(arch):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "4",
                      "--max-batch", "2", "--prompt-len", "6", "--new-tokens", "4",
                      "--max-len", "16", "--offload-ratio", "0.5", "--page-size", "4",
                      "--check-invariants"])
    assert out["served"] == 4 and out["generated_tokens"] == 16
