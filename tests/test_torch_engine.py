"""The port's tiered decode step and serving engine against the JAX
package's, on llama2-7b smoke with bridged weights: the decode step's
logits and written pools, and every request's tokens, exactly, at offload
{0, 0.5, 1} with page 4 and prompts that force spills."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import engine as JE
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro.models import model as JM
from repro.serving import tiered_decode as JTD
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.models import model as TM
from repro_torch.serving import tiered_decode as TTD
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TEngine
from torch_helpers import FP32_TOL, as_np, rel_err

JCFG, TCFG = JC.get_smoke("llama2_7b"), TC.get_smoke("llama2_7b")
PROMPT_LENS = (10, 16, 7, 14, 9)      # tests/test_serving.py: forces tier spills
NEW_TOKENS, MAX_LEN, MAX_BATCH, PAGE = 8, 32, 3, 4


@pytest.fixture(scope="module")
def weights():
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def test_paged_tiered_decode_step_matches_reference(weights):
    jparams, tparams = weights
    wl = dict(batch=3, seq_len=16, phase="decode")
    jplan = JE.plan(JCFG, JWorkload(**wl), J_TPU, global_ratio=0.5, kv_page_size=PAGE)
    tplan = TE.plan(TCFG, TWorkload(**wl), T_TPU, global_ratio=0.5, kv_page_size=PAGE)
    jp, tp = jplan.partition(jparams, align=32), tplan.partition(tparams, align=32)
    rng = np.random.default_rng(5)
    n_loc, n_rem = 4, 5
    pools = {f"{kv}_{t}": rng.normal(size=(JCFG.n_layers, n + 1, PAGE, 4, 16)).astype(np.float32)
             for kv in ("k", "v") for t, n in (("local", n_loc), ("remote", n_rem))}
    table = np.asarray([[0, 1, 2, 0], [3, 0, 1, 0], [0, 0, 0, 0]], np.int32)
    tier = np.asarray([[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([10, 9, 0], np.int32)                    # slot 2 idle
    args = dict(tokens=np.asarray([[3], [7], [0]], np.int32), positions=lens,
                attn_lens=np.where(lens > 0, lens + 1, 0).astype(np.int32),
                table=table, tier=tier,
                wr_tier=np.asarray([0, 1, 0], np.int32),      # page 2 of slot 0 / 1
                wr_idx=np.asarray([2, 1, n_loc], np.int32),   # idle slot -> local sink
                wr_off=np.asarray([2, 1, 0], np.int32))
    order = ("tokens", "positions", "attn_lens", "table", "tier", "wr_tier", "wr_idx", "wr_off")
    jl, jpools = JTD.paged_tiered_decode_step(
        JCFG, jp, {k: jnp.asarray(v) for k, v in pools.items()},
        *[jnp.asarray(args[k]) for k in order],
        sink_local=n_loc, sink_remote=n_rem, window=2, use_kernel=True)
    tl, tpools = TTD.paged_tiered_decode_step(
        TCFG, tp, {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        *[torch.from_numpy(args[k]) for k in order],
        sink_local=n_loc, sink_remote=n_rem, window=2)
    assert rel_err(tl, jl) < FP32_TOL
    for key in pools:
        sink = n_loc if key.endswith("local") else n_rem
        assert rel_err(as_np(tpools[key])[:, :sink], as_np(jpools[key])[:, :sink]) < FP32_TOL


def _serve(engine_cls, request_cls, cfg, params, ratio, hw, **kw):
    eng = engine_cls(cfg, params, max_batch=MAX_BATCH, max_len=MAX_LEN, hw=hw,
                     global_offload_ratio=ratio, page_size=PAGE, **kw)
    rng = np.random.default_rng(7)
    reqs = [request_cls(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                        max_new_tokens=NEW_TOKENS) for i, n in enumerate(PROMPT_LENS)]
    for r in reqs:
        eng.submit(r)
    return eng.run(), reqs


def _top2_gaps(tparams, prompt) -> list[float]:
    """Top-2 logit gap of each token on the port's plain reference path."""
    logits, cache = TM.prefill(TCFG, tparams, {"tokens": torch.from_numpy(prompt)[None]},
                               max_len=MAX_LEN)
    gaps, pos = [], len(prompt)
    for _ in range(NEW_TOKENS):
        top = torch.topk(logits.reshape(-1), 2).values
        gaps.append(float(top[0] - top[1]))
        nxt = torch.argmax(logits.reshape(-1)).reshape(1, 1)
        logits, cache = TM.decode_step(TCFG, tparams, cache, nxt, pos)
        pos += 1
    return gaps


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_engine_tokens_match_reference_engine(weights, ratio):
    jparams, tparams = weights
    jstats, jreqs = _serve(JEngine, JRequest, JCFG, jparams, ratio, J_TPU)
    tstats, treqs = _serve(TEngine, TRequest, TCFG, tparams, ratio, T_TPU, device="cpu")
    assert tstats.served == jstats.served == len(PROMPT_LENS)
    for jr, tr in zip(jreqs, treqs):
        assert tr.out_tokens == jr.out_tokens, (
            f"request {tr.rid} at offload {ratio}: port {tr.out_tokens} vs reference "
            f"{jr.out_tokens}; top-2 logit gaps {_top2_gaps(tparams, tr.prompt)}")
    assert (tstats.local_pages_hwm, tstats.remote_pages_hwm, tstats.spills) == \
        (jstats.local_pages_hwm, jstats.remote_pages_hwm, jstats.spills)
    if ratio == 0.5:
        assert tstats.local_pages_hwm >= 1, "no page ever resident in HBM tier"
        assert tstats.remote_pages_hwm >= 1, "no page ever resident in host tier"
