"""The port's config registry and the dense variants' layouts against the
JAX package: every id of ``ARCH_IDS + PAPER_IDS`` (and its hyphenated
alias) resolves to a copy of the reference's config, full and smoke; at
full width, each dense, SSM and hybrid arch's `init_params` layout and the
split shapes of `TieringPlan.partition` (on meta tensors) and of
`partition_source` equal the reference's abstract evaluation."""
from __future__ import annotations

import dataclasses

import jax
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import engine as JE
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro.core.hardware import TPU_V5E as J_TPU
from repro.models import model as JM
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.models import model as TM

ALL_IDS = JC.ARCH_IDS + JC.PAPER_IDS
DENSE = ["opt_6p7b", "opt_30b", "qwen2p5_14b", "qwen3_32b", "chatglm3_6b", "starcoder2_3b"]


def test_registry_lists_the_reference_ids():
    assert TC.ARCH_IDS == JC.ARCH_IDS and TC.PAPER_IDS == JC.PAPER_IDS
    assert len(ALL_IDS) == 13


@pytest.mark.parametrize("arch", ALL_IDS)
def test_every_id_resolves_to_the_reference_config(arch):
    for name in (arch, arch.replace("_", "-")):
        for t, j in ((TC.get(name), JC.get(name)), (TC.get_smoke(name), JC.get_smoke(name))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.padded_heads == j.padded_heads
            assert t.param_count() == j.param_count()


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_2p7b", "hubert_xlarge",
                                  "llava_next_34b"])
def test_unported_families_resolve_but_are_refused(arch):
    """Every family's config resolves.  The encoder, which has no decode
    step, is refused by the serving entry points with the reference's
    reason; the SSM, hybrid and VLM configs are accepted, and their
    full-width caches have the reference's layout."""
    cfg = TC.get(arch)
    if cfg.family == "encoder":
        with pytest.raises(NotImplementedError, match="encoder-only arch has no decode step"):
            TM.require_served(cfg)
        return
    TM.require_served(cfg)
    jcache = jax.eval_shape(lambda: JM.init_cache(JC.get(arch), 4, 144))
    tcache = TM.init_cache(cfg, 4, 144, device="meta")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


def _shapes(tree) -> dict:
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update({f"{key}/{k}": v for k, v in _shapes(leaf).items()})
        elif hasattr(leaf, "local"):
            out[key] = (tuple(leaf.local.shape), tuple(leaf.remote.shape), leaf.axis)
        else:
            out[key] = tuple(leaf.shape)
    return out


@pytest.mark.parametrize("ratio", [0.5, 1.0])
@pytest.mark.parametrize("arch", DENSE + ["mamba2_370m", "zamba2_2p7b"])
def test_full_width_layout_and_split_shapes_match_reference(arch, ratio):
    jcfg, tcfg = JC.get(arch), TC.get(arch)
    wl = dict(batch=4, seq_len=144, phase="decode")
    jp = JE.plan(jcfg, JWorkload(**wl), J_TPU, global_ratio=ratio, kv_page_size=16)
    tp = TE.plan(tcfg, TWorkload(**wl), T_TPU, global_ratio=ratio, kv_page_size=16)
    assert tp.op_ratios == jp.op_ratios
    jshapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    meta = TM.init_params(tcfg, None, dtype=torch.bfloat16, device="meta")
    assert _shapes(meta) == _shapes(jshapes)
    jsplit = _shapes(jax.eval_shape(lambda p: jp.partition(p, align=128), jshapes))
    assert _shapes(tp.partition(meta, align=128)) == jsplit
    src = TM.layer_source(tcfg, None, dtype=torch.bfloat16, device="meta")
    assert _shapes(tp.partition_source(src, align=128)) == jsplit
