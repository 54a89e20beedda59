"""The port's serving mesh against the JAX package's, on the CPU: the seven
cases of tests/test_mesh_serving.py, with the ranks as gloo processes.

One module fixture does all the work once.  It starts the JAX reference in
a subprocess with four forced host devices (tests/torch_mesh_reference.py:
its `_serve` tokens, the 4-device mesh's traffic report and per-link
runtime), and meanwhile serves the same requests through the port: once
without a mesh in this process, then at P = 2 and P = 4 as spawned ranks
that meet through a file store (tests/torch_mesh_ranks.py).  Weights are
the JAX package's draws, bridged (the port's own for Mamba2 and Zamba2,
whose mesh tokens are held to the single-rank port engine's).  Tokens must
match exactly; traffic figures within 1%, as the reference's own tests
hold them.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
import torch_mesh_ranks as R
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.core import multicast
from repro_torch.kernels import _build
from repro_torch.launch import mesh as LM
from repro_torch.launch import serve
from repro_torch.models import model as TM

HERE = Path(__file__).resolve().parent
KEY = jax.random.PRNGKey(0)
MESH_SPEC = [None, None, "model", None, None]


def _run_reference(out: Path) -> subprocess.Popen:
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(HERE.parent / "src"), str(HERE)])}
    return subprocess.Popen([sys.executable, str(HERE / "torch_mesh_reference.py"), str(out)],
                            env=env, cwd=HERE.parent, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    proc = _run_reference(tmp / "ref.json")
    try:
        params = {arch: bridge.params_from_numpy(
            jax.tree.map(np.asarray, JM.init_params(JC.get_smoke(arch), KEY)), device="cpu")
            for arch in R.DENSE_ARCHS}
        params.update({arch: TM.init_params(TC.get_smoke(arch), torch.Generator().manual_seed(0),
                                            device="cpu") for arch in R.RECURRENT_ARCHS})
        torch.save(params, tmp / "params.pt")
        single = {}
        for arch in R.DENSE_ARCHS + R.RECURRENT_ARCHS:
            for ratio in R.RATIOS:
                single[f"{arch}/{ratio}"] = R.serve(TC.get_smoke(arch), params[arch], ratio)[1]
        ranks = {}
        for n in (2, 4):
            LM.run_ranks(R.serving_cases, n, backend="gloo",
                         init_method=f"file://{tmp / f'store{n}'}", args=(n, str(tmp)))
            ranks[n] = [json.loads((tmp / f"p{n}_r{r}.json").read_text()) for r in range(n)]
        plain = tmp / "serve_tokens.json"
        serve.main(["--device", "cpu", "--smoke", "--requests", "3", "--max-batch", "2",
                    "--prompt-len", "6", "--new-tokens", "4", "--max-len", "24",
                    "--offload-ratio", "0.5", "--page-size", "4", "--tokens-out", str(plain)])
        log, _ = proc.communicate(timeout=900)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, log
    return SimpleNamespace(ref=json.loads((tmp / "ref.json").read_text()), single=single,
                           ranks=ranks, serve_tokens=json.loads(plain.read_text()))


# -- shard -> fetch round trip ---------------------------------------------
def test_shard_fetch_roundtrip_bitwise(runs):
    for rank in runs.ranks[4]:
        assert rank["roundtrip"] == {"any_sharded": True, "shards_quarter": True,
                                     "fetched_whole": True, "bitwise": True}


# -- exact-token serving equivalence ---------------------------------------
@pytest.mark.parametrize("arch", R.DENSE_ARCHS)
def test_engine_mesh_token_parity(runs, arch):
    """2- and 4-rank mesh engines emit the single-rank port engine's tokens
    and the JAX engine's exactly, at offload 0.0 and 0.5 (dense / MoE / MLA)."""
    for ratio in R.RATIOS:
        key = f"{arch}/{ratio}"
        want = runs.single[key]
        assert want == runs.ref["tokens"][key], f"{key}: port {want} vs JAX"
        for n in (2, 4):
            for rank, got in enumerate(runs.ranks[n]):
                assert got["tokens"][key] == want, f"{key} rank {rank} of {n} diverges"
                assert got["plan_mesh"][key] and got["mesh_shape"][key] == [n]


@pytest.mark.parametrize("arch", R.RECURRENT_ARCHS)
def test_engine_mesh_token_parity_ssm_hybrid(runs, arch):
    """SSM (no KV pages) and the Zamba2 hybrid (sharded pools + recurrent
    state) take the same fetch-once path exactly."""
    key = f"{arch}/0.5"
    for rank, got in enumerate(runs.ranks[4]):
        assert got["tokens"][key] == runs.single[key], f"{key} rank {rank} diverges"


def test_engine_mesh_sharded_kv_pools(runs):
    """page_size divisible by P: each rank pins the in-page 1/P of every
    remote page; the local pools and the gathered remote pools are whole."""
    for rank in runs.ranks[4]:
        pools = rank["pools"]
        assert pools["sharded"] and pools["spec"] == MESH_SPEC
        remote, gathered = pools["remote_shape"], pools["gathered_shape"]
        assert remote[2] * 4 == gathered[2] == pools["local_shape"][2]
        assert remote[:2] == gathered[:2] and remote[3:] == gathered[3:]


def test_move_pages_preserves_remote_pool_sharding(runs):
    """Demotion, promotion and emergency growth keep the sharded layout, and
    the pages read back whole from it."""
    for rank in runs.ranks[4]:
        mp = rank["move_pages"]
        assert mp["sharded"] and mp["specs"] == [MESH_SPEC, MESH_SPEC]
        assert mp["shapes"] == [[2, 5, 1, 2, 4], [2, 9, 1, 2, 4]]
        assert mp["local_shape"] == [2, 5, 4, 2, 4]
        assert mp["moved_back"] == 1 and mp["grown"] == 8
        assert len(mp["remote_pages"]) == 2 and mp["gather_exact"]


# -- per-link host traffic vs the multicast oracle --------------------------
def test_per_device_traffic_matches_multicast_oracle(runs):
    """Per-link host bytes drop ~1/P against naive replication, with
    `core.multicast` as the oracle, match the JAX engine's report, and
    match what each rank counted up its own link."""
    ref = runs.ref["report"]
    for rank in runs.ranks[4]:
        rep = rank["report"]
        per_link = max(rep["per_link_bytes"])
        assert per_link == pytest.approx(rep["oracle_per_link_multicast"], rel=0.01)
        assert rep["oracle_per_link_naive"] / per_link == pytest.approx(4, rel=0.01)
        oracle = multicast.sharded_fetch_report(rep["host_bytes"], 4)
        assert per_link == pytest.approx(oracle.traffic_multicast / 4, rel=0.01)
        assert per_link == pytest.approx(max(ref["per_link_bytes"]), rel=0.01)
        assert rep["host_bytes"] == ref["host_bytes"]
        counted = rank["link_bytes"]["weights"] / rank["fetches"]
        assert counted * multicast.GRANULARITY_OVERHEAD == pytest.approx(per_link, rel=0.01)


# -- per-link control plane -------------------------------------------------
def test_adaptive_mesh_runs_per_link_windows(runs):
    ref = runs.ref
    assert ref["adaptive_tokens"] == ref["mesh_tokens"] == runs.single["llama2_7b/0.5"]
    for rank in runs.ranks[4]:
        ad = rank["adaptive"]
        assert ad["tokens"] == ref["adaptive_tokens"]     # the window only paces copies
        assert ad["windows"] == ad["window_per_link"] == ref["windows"] == 4
        assert len(ad["bw_per_link"]) == ref["bw_per_link"] == 4
        # symmetric links under the analytical model: equal achieved EMAs
        assert all(b == pytest.approx(ad["bw_per_link"][0]) for b in ad["bw_per_link"])


# -- the serve command, backends and placements -----------------------------
def test_serve_command_mesh_devices(runs):
    """`serve.main --mesh-devices 2` (as ranks of a running process group, the
    torchrun path) emits the tokens of the same command without a mesh, and
    reports the reference's mesh fields."""
    for rank in runs.ranks[2]:
        got = rank["serve"]
        assert got["tokens"] == runs.serve_tokens
        assert got["mesh_shape"] == [2] and got["mesh_traffic"]["n_devices"] == 2
        traffic = got["mesh_traffic"]
        assert max(traffic["per_link_bytes"]) == pytest.approx(
            traffic["oracle_per_link_multicast"], rel=0.01)


def test_dev_mesh_grid_lines(runs):
    """`make_dev_mesh(2, 2)`: ranks row-major over ("data", "model"), one
    process group per line of each axis (rank = 2 * data + model)."""
    for rank, got in enumerate(r["grid"] for r in runs.ranks[4]):
        d, m = divmod(rank, 2)
        assert got["index"] == [d, m]
        assert got["sums"] == {"model": float(4 * d + 1), "data": float(2 * m + 2)}
        assert got["data_axes"] == ["data"] and got["size"] == 4


def test_backend_choice_never_falls_back():
    """NCCL with more ranks than cards (two ranks sharing one card, or none
    at all here) is refused before any process starts; no mesh without a
    process group."""
    with pytest.raises(RuntimeError, match="one card per rank"):
        LM.check_backend("nccl", 2)
    with pytest.raises(RuntimeError, match="one card per rank"):
        serve.main(["--device", "cpu", "--smoke", "--mesh-devices", "2",
                    "--mesh-backend", "nccl"])
    with pytest.raises(ValueError, match="backend"):
        LM.check_backend("mpi", 2)
    with pytest.raises(RuntimeError, match="process group"):
        LM.make_dev_mesh(1, 2)


def test_remote_operand_placements():
    """A kernel's remote operand is pinned host memory or a tensor on the
    local operands' card; unpinned host memory and other devices are not."""
    cuda0 = torch.device("cuda", 0)
    assert not _build.remote_placement_ok(torch.zeros(2), cuda0)
    assert not _build.remote_placement_ok(torch.empty(2, device="meta"), cuda0)
    assert _build.remote_placement_ok(torch.empty(2, device="meta"), torch.device("meta"))
