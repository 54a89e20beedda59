"""The dense variants (OPT-6.7B, OPT-30B, Qwen2.5-14B, Qwen3-32B, ChatGLM3-6B,
StarCoder2-3B) served by the port's engine against the JAX package's engine,
on each arch's SMOKE config at offload {0, 0.5} (3 slots, page 4, prompts
that force spills): every request's tokens and the page high-water marks
must be equal.

Between them the archs take every dense branch: LayerNorm with biases, the
GELU MLP with ``bi``/``bdown``, ``qkv_bias``, ``rope_fraction`` 0.5, ``qk_norm``
and padded query heads.  `init_params` sets every bias to zero and every
norm weight to one, which would hide a wrong bias or norm path, so here
every bias (``bq``, ``bkv``, ``bi``, ``bdown``, ``ln*_b``, ``final_b``) and
every norm weight (``ln*_w``, ``q_norm_w``, ``k_norm_w``, ``final_w``) is
drawn from a seed with numpy into the numpy tree before it is bridged to
both packages."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.core.hardware import TPU_V5E as J_TPU
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import SERVE_PROMPT_LENS, serve

DENSE = ["opt_6p7b", "opt_30b", "qwen2p5_14b", "qwen3_32b", "chatglm3_6b", "starcoder2_3b"]
BIASES = ("bq", "bkv", "bi", "bdown", "ln1_b", "ln2_b", "final_b")
NORM_WEIGHTS = ("ln1_w", "ln2_w", "q_norm_w", "k_norm_w", "final_w")


def _weights(arch: str):
    """The reference's init with every bias and norm weight redrawn."""
    cfg = JC.get_smoke(arch)
    tree = jax.tree.map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(3)))
    rng = np.random.default_rng(11)
    drawn = []
    for node in (tree, tree["layers"]):
        for key in BIASES + NORM_WEIGHTS:
            if key in node:
                noise = rng.normal(scale=0.1, size=node[key].shape).astype(np.float32)
                node[key] = noise if key in BIASES else 1.0 + 2 * noise
                drawn.append(key)
    return tree, drawn


def test_every_dense_branch_is_covered():
    cfgs = [TC.get_smoke(a) for a in DENSE]
    assert {c.norm for c in cfgs} == {"layernorm", "rmsnorm"}
    assert {c.mlp for c in cfgs} == {"gelu", "swiglu"}
    assert any(c.qkv_bias for c in cfgs) and any(c.qk_norm for c in cfgs)
    assert any(c.rope_fraction == 0.5 for c in cfgs)
    assert any(c.padded_heads > c.n_heads for c in cfgs)
    drawn = set()
    for a in DENSE:
        drawn.update(_weights(a)[1])
    assert drawn == set(BIASES + NORM_WEIGHTS)


@pytest.mark.parametrize("ratio", [0.0, 0.5])
@pytest.mark.parametrize("arch", DENSE)
def test_engine_tokens_match_reference_engine(arch, ratio):
    tree, drawn = _weights(arch)
    assert drawn, "no bias or norm weight redrawn"
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = bridge.params_from_numpy(tree, device="cpu")
    jstats, jreqs = serve(JEngine, JRequest, JC.get_smoke(arch), jparams, J_TPU, ratio,
                          seed=17)
    tstats, treqs = serve(TEngine, TRequest, TC.get_smoke(arch), tparams, T_TPU, ratio,
                          seed=17, device="cpu")
    assert tstats.served == jstats.served == len(SERVE_PROMPT_LENS)
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, f"{arch} request {tr.rid} at offload {ratio}"
    assert (tstats.local_pages_hwm, tstats.remote_pages_hwm, tstats.spills) == \
        (jstats.local_pages_hwm, jstats.remote_pages_hwm, jstats.spills)
    if ratio == 0.5:
        assert tstats.local_pages_hwm >= 1 and tstats.remote_pages_hwm >= 1
