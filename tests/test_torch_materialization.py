"""The port's materialization lint, surface and CLI against the reference's
(``repro.analysis.materialization``, ``surface``, ``cli``).

Every red fixture of ``tests/test_analysis.py`` is translated to the port
and must fire the rule IDs the JAX lint fires on the JAX function; the
abstract surface must give the reference's leaves, remote flags and pools;
the lint must stay green over every family's serving entry points (at
full width; depth cut to 2 layers, Zamba2 to 12 so both shared blocks
run) and fire when a served path is made to stage a remote tier; and the
CLI keeps the reference's exit codes.  Plans use TPU_V5E on both sides."""
from __future__ import annotations

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.analysis import materialization as JMZ
from repro.analysis import surface as JS
from repro.core import engine as JE
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro_torch.analysis import RULES
from repro_torch.analysis import cli as T_cli
from repro_torch.analysis import materialization as MZ
from repro_torch.analysis import surface as TS
from repro_torch.analysis.findings import Finding
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.core.tiering import TieredTensor
from repro_torch.kernels import ops, ref, sink
from repro_torch.kernels.splitk_flashattn import scatter_rows, scatter_rows_ref
from repro_torch.kernels.splitk_gemm import splitk_gemm
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request, ServingEngine

FAMILIES = ("llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b", "mamba2_370m",
            "zamba2_2p7b")
CUT_DEPTH = {"zamba2_2p7b": 12}      # two groups: both shared blocks run


def _rules(findings) -> set[str]:
    return {f.rule for f in findings}


def _cut(get, arch: str):
    return dataclasses.replace(get(arch), n_layers=CUT_DEPTH.get(arch, 2))


def _align(cfg) -> int:
    return 32 if cfg.d_model < 1024 else 128


def _plans(jcfg, tcfg, ratio: float, n_dev: int = 1):
    wl = dict(batch=4, seq_len=256, dtype_bytes=2, phase="decode")
    jmesh = JE.MeshSpec(n_devices=n_dev) if n_dev > 1 else None
    tmesh = TE.MeshSpec(n_devices=n_dev) if n_dev > 1 else None
    return (JE.plan(jcfg, JWorkload(**wl), J_TPU, global_ratio=ratio, mesh=jmesh),
            TE.plan(tcfg, TWorkload(**wl), T_TPU, global_ratio=ratio, mesh=tmesh))


# ---------------------------------------------------------------------------
# The reference's red fixtures, translated (tests/test_analysis.py)
# ---------------------------------------------------------------------------
def _j_tiered():
    ta = JE.tiering.TieredArray(local=jax.ShapeDtypeStruct((128, 64), jnp.float32),
                                remote=JS.RemoteLeaf((128, 64), jnp.float32), axis=1)
    return jax.ShapeDtypeStruct((4, 128), jnp.float32), ta


def _t_tiered():
    ta = TieredTensor(local=torch.empty((128, 64), device="meta"),
                      remote=TS.remote_leaf((128, 64)), axis=1)
    return torch.empty((4, 128), device="meta"), ta


def _j_pool_buf(buf_shape):
    return JS.RemoteLeaf((8, 16, 4), jnp.float32), jax.ShapeDtypeStruct(buf_shape, jnp.float32)


def _t_pool_buf(buf_shape):
    return TS.remote_leaf((8, 16, 4)), torch.empty(buf_shape, device="meta")


def _j_scan(pool, buf):
    def body(c, _):
        return c, jnp.concatenate([c, pool[0]], axis=0)
    return jax.lax.scan(body, buf, jnp.arange(3))[1]


def _t_loop(pool, buf):
    return torch.stack([torch.cat([buf, pool[0]], dim=0) for _ in range(3)])


def _j_carry(pool, buf):        # taint enters the carry only on iteration 1
    def body(c, _):
        return c + pool[0], ()
    out, _ = jax.lax.scan(body, buf, jnp.arange(3))
    return jnp.concatenate([out, buf], axis=0)


def _t_carry(pool, buf):
    c = buf
    for _ in range(3):
        c = c + pool[0]
    return torch.cat([c, buf], dim=0)


def _t_inplace_carry(pool, buf):
    c = buf.clone()
    for _ in range(3):
        c.add_(pool[0])
    return torch.cat([c, buf], dim=0)


def _j_cond(pool, buf):
    return jax.lax.cond(True, lambda p, b: jnp.concatenate([b, p[0]], axis=0),
                        lambda p, b: jnp.concatenate([b, b], axis=0), pool, buf)


def _t_branch(pool, buf, take=True):
    if take:
        return torch.cat([buf, pool[0]], dim=0)
    return torch.cat([buf, buf], dim=0)


# (jax fn, jax args, port fn, port args, rule)
FIXTURES = {
    "dak001_concat": (
        lambda x, ta: x @ jnp.concatenate([ta.local, ta.remote], axis=1), _j_tiered,
        lambda x, ta: x @ torch.cat([ta.local, ta.remote], dim=1), _t_tiered, "DAK001"),
    "dak002_einsum_over_concat": (
        lambda x, ta: jnp.einsum("bk,kn->bn", x, jnp.concatenate([ta.local, ta.remote], 1)),
        _j_tiered,
        lambda x, ta: torch.einsum("bk,kn->bn", x, torch.cat([ta.local, ta.remote], 1)),
        _t_tiered, "DAK002"),
    "dak003_remote_pool_update": (
        lambda pool, buf: jax.lax.dynamic_update_slice(buf, pool[2][None], (0, 0, 0)),
        lambda: _j_pool_buf((8, 16, 4)),
        lambda pool, buf: torch.slice_scatter(buf, pool[2][None], 0, 0, 1),
        lambda: _t_pool_buf((8, 16, 4)), "DAK003"),
    "per_tier_outputs_concatenated": (
        lambda x, ta: jnp.concatenate([x @ ta.local, x @ ta.remote], axis=1), _j_tiered,
        lambda x, ta: torch.cat([x @ ta.local, x @ ta.remote], dim=1), _t_tiered, "DAK001"),
    "python_loop": (_j_scan, lambda: _j_pool_buf((16, 4)),
                    _t_loop, lambda: _t_pool_buf((16, 4)), "DAK001"),
    "carried_accumulator": (_j_carry, lambda: _j_pool_buf((16, 4)),
                            _t_carry, lambda: _t_pool_buf((16, 4)), "DAK001"),
    "in_place_carry": (_j_carry, lambda: _j_pool_buf((16, 4)),
                       _t_inplace_carry, lambda: _t_pool_buf((16, 4)), "DAK001"),
    "branch": (_j_cond, lambda: _j_pool_buf((16, 4)),
               _t_branch, lambda: _t_pool_buf((16, 4)), "DAK001"),
}


@pytest.mark.parametrize("name", list(FIXTURES))
def test_red_fixtures_report_the_reference_rules(name):
    j_fn, j_args, t_fn, t_args, rule = FIXTURES[name]
    want = JMZ.lint_traced(j_fn, j_args(), rule=rule, where=name)
    got = MZ.lint_traced(t_fn, t_args(), rule=rule, where=name)
    assert _rules(got) == _rules(want)
    assert len(got) == len(want) <= 1          # reported once, no cascade
    if name.startswith("dak001"):
        assert "concatenated" in got[0].detail
        assert "test_torch_materialization.py" in got[0].detail   # the source line


def test_dak001_device_move_fires_on_a_copy_onto_another_device():
    remote = TS.mark_remote(torch.ones(4, 8))        # host memory
    for fn in (lambda r: r.to("meta"),
               lambda r: torch.empty(4, 8, device="meta").copy_(r),
               lambda r: torch.cat([r.to("meta") @ torch.empty(8, 2, device="meta")] * 2)):
        fs = MZ.lint_traced(fn, (remote,), rule="DAK001", where="move")
        assert [(f.rule, f.context["kind"]) for f in fs] == [("DAK001", "device-move")]
        assert "onto meta" in fs[0].detail
    # a cast on the same device copies within host memory: no finding
    assert MZ.lint_traced(lambda r: r.double() @ r.double().T, (remote,),
                          rule="DAK001", where="cast") == []


def test_kernel_entry_points_are_sinks_and_their_plain_versions_are_not():
    assert set(sink.SINKS) == {"splitk_gemm", "splitk_gemm_grouped", "paged_splitk_flashattn",
                               "splitk_flashattn", "scatter_rows", "flash_prefill",
                               "gather_shards"}
    assert sink._hook is None                       # outside a lint: the entry runs as it was
    rng = np.random.default_rng(0)
    rows = TS.mark_remote(torch.tensor(rng.standard_normal((3, 2, 8)), dtype=torch.float32))
    wr_tier = torch.tensor([0, 1, 0], dtype=torch.int32)
    wr_idx = torch.tensor([0, 1, 2], dtype=torch.int32)
    wr_off = torch.tensor([1, 2, 3], dtype=torch.int32)
    out = {}
    for label, fn in (
            ("entry", lambda pool, r: scatter_rows(pool, r, wr_tier, wr_idx, wr_off, 0, 4,
                                                   remote=False)),
            ("plain", lambda pool, r: scatter_rows_ref(
                pool, r, torch.where(wr_tier == 0, wr_idx, 4), wr_off))):
        pool = torch.zeros(5, 4, 2, 8)              # a local (clean) pool
        out[label] = (MZ.lint_traced(fn, (pool, rows), rule="DAK001", where=label), pool)
    assert out["entry"][0] == []
    assert _rules(out["plain"][0]) == {"DAK001"}
    assert "update" in out["plain"][0][0].context["kind"]
    assert torch.equal(out["entry"][1], out["plain"][1])
    # the GEMM's outputs leave the lint clean and equal the plain product
    x = torch.tensor(rng.standard_normal((4, 16)), dtype=torch.float32)
    wl, wr = (torch.tensor(rng.standard_normal((16, n)), dtype=torch.float32) for n in (8, 8))
    with MZ.MaterializationLint() as lint:
        lint.seed([TS.mark_remote(wr)])
        y = splitk_gemm(x, wl, wr)
        torch.cat([y, y])
    assert lint.findings == [] and lint.sinks == 1
    assert torch.equal(y, ref.splitk_gemm_ref(x, wl, wr))


# ---------------------------------------------------------------------------
# The abstract surface
# ---------------------------------------------------------------------------
def _spec(leaf) -> tuple:
    return tuple(leaf.shape), str(leaf.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", FAMILIES)
def test_partition_abstract_and_remote_mask_equal_the_reference(arch):
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    assert TS.operand_shapes(tcfg) == JS.operand_shapes(jcfg)
    for n_dev in (1, 4):
        jplan, tplan = _plans(jcfg, tcfg, 0.5, n_dev)
        jp = JS.partition_abstract(jcfg, jplan, align=_align(jcfg))
        tp = TS.partition_abstract(tcfg, tplan, align=_align(tcfg))
        assert [_spec(leaf) for leaf, _ in TS.flatten(tp)] == \
            [_spec(leaf) for leaf in jax.tree_util.tree_leaves(jp)]
        mask = MZ.remote_mask((tp,))
        assert mask == JMZ.remote_mask((jp,)) and any(mask)
        assert all(leaf.device.type == "meta" for leaf, _ in TS.flatten(tp))


@pytest.mark.parametrize("arch", FAMILIES)
def test_abstract_kv_pools_equal_the_reference(arch):
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    kw = dict(local_pages=3, remote_pages=5, page_size=16)
    jpools, tpools = JS.abstract_kv_pools(jcfg, **kw), TS.abstract_kv_pools(tcfg, **kw)
    assert list(tpools) == list(jpools)
    assert {k: _spec(v) for k, v in tpools.items()} == {k: _spec(v) for k, v in jpools.items()}
    assert MZ.remote_mask((tpools,)) == JMZ.remote_mask((jpools,))


# ---------------------------------------------------------------------------
# The serving entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_lint_family_is_green_on_every_pass_like_the_reference(arch):
    """decode, prefill, chunked prefill and the kv-pool pass at offload
    {0, 0.5, 1}; at 0.5 the JAX lint agrees."""
    jcfg, tcfg = _cut(JC.get, arch), _cut(TC.get, arch)
    for ratio in (0.0, 0.5, 1.0):
        jplan, tplan = _plans(jcfg, tcfg, ratio)
        assert MZ.lint_family(tcfg, tplan, align=_align(tcfg), where=arch) == []
        if ratio == 0.5:
            assert JMZ.lint_family(jcfg, jplan, align=_align(jcfg), where=arch) == []


def test_lint_green_on_the_full_size_decode_path():
    cfg = TC.get("llama2_7b")
    plan = _plans(JC.get("llama2_7b"), cfg, 0.5)[1]
    assert MZ.lint_family(cfg, plan, align=128, passes=("decode",), where="green") == []


def _staging_matmul(x, w, **_):
    """The anti-pattern: the remote tier concatenated to the local one in
    HBM, then one dense product."""
    return x @ torch.cat([w.local, w.remote], dim=-1)


def _staging_attention(q, pools, table, tier, lens, **kw):
    """The anti-pattern for KV: the remote pool staged beside the local one."""
    kl = torch.cat([pools["k_local"], pools["k_remote"]])
    vl = torch.cat([pools["v_local"], pools["v_remote"]])
    table = torch.where(tier > 0, table + pools["k_local"].shape[0], table)
    return ref.paged_flashattn_ref(q, kl, vl, kl, vl, table, torch.zeros_like(tier), lens,
                                   scale=kw.get("scale"))


@pytest.mark.parametrize("arch", ["llama2_7b", "qwen3_moe_30b_a3b"])
def test_lint_family_fires_when_a_served_path_stages_a_remote_tier(arch, monkeypatch):
    cfg = _cut(TC.get, arch)
    plan = _plans(_cut(JC.get, arch), cfg, 0.5)[1]
    monkeypatch.setattr(ops, "tiered_matmul", _staging_matmul)
    fs = MZ.lint_family(cfg, plan, align=_align(cfg), passes=("decode", "prefill", "chunk"))
    assert _rules(fs) == {"DAK001", "DAK002"}
    assert {f.where for f in fs} == {"/decode", "/prefill", "/chunked-prefill"}
    assert all("concatenated" in f.detail and "_staging_matmul" in f.detail for f in fs)
    monkeypatch.undo()
    monkeypatch.setattr(ops, "paged_decode_attention", _staging_attention)
    fs = MZ.lint_family(cfg, plan, align=_align(cfg), passes=("decode",))
    assert _rules(fs) == {"DAK001", "DAK003"}
    assert {f.where for f in fs if f.rule == "DAK003"} == {"/kv-pools"}


def _serve_cpu(arch: str, lint: bool, staging: bool = False):
    cfg = TC.get_smoke(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(cfg, params, max_batch=2, max_len=32, global_offload_ratio=0.5,
                        page_size=4, jit_step=False, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(3, cfg.vocab, 6 + 3 * i).astype(np.int32),
                    max_new_tokens=4) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    findings, walked = [], 0
    while eng.active.count(None) < len(eng.active) or eng.scheduler.waiting:
        if not lint:
            eng.step()
            continue
        with MZ.MaterializationLint(rule="DAK001", where=arch) as walk:
            walk.seed(MZ.engine_remote_tensors(eng))
            eng.step()
        findings += walk.findings
        walked += walk.ops
    return [r.out_tokens for r in reqs], findings, walked


@pytest.mark.parametrize("arch", ["llama2_7b", "deepseek_v2_236b", "zamba2_2p7b"])
def test_lint_around_a_cpu_engine_is_green_and_changes_no_token(arch, monkeypatch):
    plain, _, _ = _serve_cpu(arch, lint=False)
    tokens, findings, walked = _serve_cpu(arch, lint=True)
    assert findings == [] and walked > 0
    assert tokens == plain
    monkeypatch.setattr(ops, "tiered_matmul", _staging_matmul)
    _, findings, _ = _serve_cpu(arch, lint=True)
    assert findings and _rules(findings) == {"DAK001"}


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_cli_self_test_exit_codes():
    assert T_cli.main(["--self-test", "-q"]) == 0


def test_cli_green_slice_and_seeded_failure(monkeypatch, capsys, tmp_path):
    rep = tmp_path / "report.json"
    rc = T_cli.main(["--arch", "llama2_7b", "--offload", "0.5", "--mesh", "1",
                     "--passes", "plan,kernels", "-q", "--json", str(rep)])
    assert rc == 0
    assert rep.exists()
    capsys.readouterr()
    # wire-through: any finding must flip the exit code
    monkeypatch.setattr(T_cli.page_table, "run_scenario",
                        lambda: [Finding("DAK301", "seeded", "fixture")])
    rc = T_cli.main(["--arch", "llama2_7b", "--passes", "pagetable", "-q"])
    assert rc == 1


def test_cli_materialization_pass_runs_the_family_lint(monkeypatch):
    calls = []

    def fake(cfg, plan, *, align, where):
        calls.append((cfg.name, where, align))
        return []

    monkeypatch.setattr(T_cli.materialization, "lint_family", fake)
    findings, checked = T_cli.run(("mamba2_370m",), (0.5,), (1, 4),
                                  passes=("materialization",), verbose=False)
    assert findings == [] and checked == ["mamba2_370m@0.5/P1:materialization"]
    assert [c[1:] for c in calls] == [("mamba2_370m@0.5/P1", _align(TC.get("mamba2_370m")))]


def test_every_rule_id_has_a_red_fixture():
    """Meta-test: the port's analysis tests cover the full rule registry."""
    here = pathlib.Path(__file__).parent
    src = "".join((here / f).read_text() for f in (
        "test_torch_materialization.py", "test_torch_kernel_lints.py",
        "test_torch_analysis.py"))
    covered = {rule for rule in RULES
               if f"test_{rule.lower()}" in src or f'"{rule}"' in src}
    assert covered == set(RULES), sorted(set(RULES) - covered)
