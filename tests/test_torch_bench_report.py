"""The port's measurement surface against the reference's: the engine's
untiered reference path (``use_kernels=False``) emits the JAX engine's
tokens on that path for four families, and `launch.serve.main`'s report
(``--bench-json``) has the reference's key tree."""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.core.hardware import TPU_V5E as J_TPU
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import redraw_recurrent_leaves, serve

# Left out of the comparison of the two reports: the backend stamps (the
# port stamps `torch`, the reference `jax`) and the git revision.  Fields
# whose values hang on the wall clock or on the hardware profile (the
# reference serves on TPU_V5E's, the port on H100_SXM's) are compared by key
# only: every other value of `VALUE_FIELDS` must be equal.
STAMPS = ("provenance.torch", "provenance.jax", "provenance.git_rev")
VALUE_FIELDS = ("arch", "smoke", "adaptive", "scheduler", "prefill_chunk", "trace",
                "mesh_shape", "requests", "served", "schema_version", "provenance.arch",
                "provenance.clock", "provenance.scheduler", "provenance.mesh_shape",
                "provenance.jit", "compile.jit")


@pytest.mark.parametrize("arch", ["llama2_7b", "qwen3_moe_30b_a3b", "mamba2_370m",
                                  "zamba2_2p7b"])
def test_untiered_reference_path_emits_the_jax_engines_tokens(arch):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    if jcfg.family == "moe":              # dropless: no capacity couples the batch
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=float(jcfg.n_experts))
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=float(tcfg.n_experts))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    if jcfg.family in ("ssm", "hybrid"):
        redraw_recurrent_leaves(tree, 11)
    jstats, jreqs = serve(JEngine, JRequest, jcfg, jax.tree.map(jax.numpy.asarray, tree),
                          J_TPU, 0.5, 7, new_tokens=3, use_kernels=False)
    tparams = bridge.params_from_numpy(tree, device="cpu")
    tstats, treqs = serve(TEngine, TRequest, tcfg, tparams, T_TPU, 0.5, 7, new_tokens=3,
                          use_kernels=False, device="cpu")
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert tstats.served == jstats.served == len(jreqs)
    assert tstats.decode_steps == jstats.decode_steps


def _flat(tree, prefix="") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) and value:
            out.update(_flat(value, f"{path}."))
        else:
            out[path] = value
    return out


def test_bench_report_has_the_reference_key_tree(tmp_path):
    """One modeled-clock smoke run (Poisson arrivals) of each serve command
    with --bench-json: the report main returns is the one written, and its
    keys, nested ones included, are the reference's."""
    args = ["--smoke", "--requests", "4", "--max-batch", "2", "--new-tokens", "3",
            "--max-len", "24", "--offload-ratio", "0.5", "--page-size", "4",
            "--arrival-rate", "2000"]
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    jrep = jserve.main([*args, "--bench-json", str(jpath)])
    trep = tserve.main([*args, "--device", "cpu", "--bench-json", str(tpath)])
    assert json.loads(tpath.read_text()) == json.loads(json.dumps(trep, default=float))
    jflat = _flat(json.loads(jpath.read_text()))
    tflat = _flat(trep)
    assert "provenance.jax" in jflat and tflat["provenance.torch"]
    assert sorted(k for k in tflat if k not in STAMPS) == \
        sorted(k for k in jflat if k not in STAMPS)
    assert {k: tflat[k] for k in VALUE_FIELDS} == {k: jflat[k] for k in VALUE_FIELDS}
    assert jrep["schema_version"] == trep["schema_version"] == 2
