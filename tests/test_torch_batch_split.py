"""The port's batch-split tiered decode path (the paper's §5 layout)
against the JAX package's: the attention kernel's plain version against the
JAX Pallas kernel in interpret mode and its oracle, and the decode step on
llama2-7b smoke with bridged weights at S = 256, where the JAX step runs its
interpret-mode kernel (at S < 256 it takes the oracle).  Inputs come from
numpy seeds; fp32 within 2e-4 relative."""
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
from repro.kernels import ref as jref
from repro.kernels.splitk_flashattn import splitk_flashattn as j_splitk
from repro.models import model as JM
from repro.serving import tiered_decode as JTD
from repro_torch import bridge
from repro_torch.core import engine as TE
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload
from repro_torch.core.hardware import TPU_V5E as T_TPU
from repro_torch.kernels import ops as tops
from repro_torch.kernels.splitk_flashattn import splitk_flashattn
from repro_torch.serving import tiered_decode as TTD
from torch_helpers import FP32_TOL, as_np, rel_err

JCFG, TCFG = JC.get_smoke("llama2_7b"), TC.get_smoke("llama2_7b")
BATCH, PROMPT, S = 4, 8, 256


def _split_inputs(b_loc, b_rem, h, kh, hd, s, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b_loc + b_rem, h, hd)).astype(dtype)
    k = rng.normal(size=(b_loc + b_rem, s, kh, hd)).astype(dtype)
    v = rng.normal(size=(b_loc + b_rem, s, kh, hd)).astype(dtype)
    return q, {"k_local": k[:b_loc], "v_local": v[:b_loc],
               "k_remote": k[b_loc:], "v_remote": v[b_loc:]}


@pytest.mark.parametrize("b_loc,b_rem,h,kh,kv_len", [
    (2, 2, 8, 2, 64),      # GQA, whole cache
    (3, 2, 8, 2, 37),      # kv_len < S
    (0, 3, 4, 4, 50),      # every request remote (B_loc = 0)
    (3, 0, 4, 1, 64),      # every request local (B_rem = 0)
    (1, 1, 4, 4, 1),       # one position
    (4, 1, 8, 1, 63),      # one kv head for all query heads
    (1, 4, 8, 8, 33),      # more remote than local requests, H = Kh
])
def test_splitk_flashattn_matches_reference(b_loc, b_rem, h, kh, kv_len):
    q, kv = _split_inputs(b_loc, b_rem, h, kh, 16, 64, seed=b_loc * 10 + b_rem)
    got = tops.tiered_decode_attention(torch.from_numpy(q),
                                       {k: torch.from_numpy(v) for k, v in kv.items()},
                                       kv_len=kv_len, window=2)
    jkv = {k: jnp.asarray(v) for k, v in kv.items()}
    want_kernel = j_splitk(jnp.asarray(q), jkv["k_local"], jkv["v_local"], jkv["k_remote"],
                           jkv["v_remote"], kv_len=kv_len, block_s=32, window=2,
                           interpret=True)
    want_oracle = jref.splitk_flashattn_ref(jnp.asarray(q), jkv["k_local"], jkv["v_local"],
                                            jkv["k_remote"], jkv["v_remote"], kv_len)
    assert got.shape == (b_loc + b_rem, h, 16)
    assert rel_err(got, want_kernel) < FP32_TOL
    assert rel_err(got, want_oracle) < FP32_TOL


def test_splitk_flashattn_bf16_matches_reference():
    q, kv = _split_inputs(2, 2, 8, 2, 64, 128, seed=3)
    jq = jnp.asarray(q, jnp.bfloat16)
    jkv = {k: jnp.asarray(v, jnp.bfloat16) for k, v in kv.items()}
    want = j_splitk(jq, jkv["k_local"], jkv["v_local"], jkv["k_remote"], jkv["v_remote"],
                    kv_len=128, block_s=64, interpret=True)
    t = lambda a: bridge.tensor_from_numpy(np.asarray(a), device="cpu")   # noqa: E731
    got = splitk_flashattn(t(jq), *[t(jkv[k]) for k in ("k_local", "v_local", "k_remote",
                                                        "v_remote")], kv_len=128)
    assert got.dtype == torch.bfloat16
    assert rel_err(got, want) < 5e-2


def test_splitk_flashattn_validates_shapes():
    q, kv = _split_inputs(2, 1, 4, 2, 8, 16, seed=0)
    t = {k: torch.from_numpy(v) for k, v in kv.items()}
    args = (t["k_local"], t["v_local"], t["k_remote"], t["v_remote"])
    with pytest.raises(ValueError, match="kv_len"):
        splitk_flashattn(torch.from_numpy(q), *args, kv_len=17)
    with pytest.raises(ValueError, match="kv_len"):
        splitk_flashattn(torch.from_numpy(q), *args, kv_len=0)
    with pytest.raises(ValueError, match="batch mismatch"):
        splitk_flashattn(torch.from_numpy(q[:2]), *args, kv_len=4)
    # the whole cache; S = 16 is no multiple of the reference's block_s, which it demands
    out = splitk_flashattn(torch.from_numpy(q), *args, kv_len=16)
    assert rel_err(out, jref.splitk_flashattn_ref(
        jnp.asarray(q), *[jnp.asarray(kv[k]) for k in ("k_local", "v_local", "k_remote",
                                                        "v_remote")], 16)) < FP32_TOL


@pytest.fixture(scope="module")
def model():
    """Bridged smoke weights, partitioned alike on both sides, and a
    prefilled cache [L, B, S, Kh, hd] handed to both as numpy."""
    jparams = JM.init_params(JCFG, jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    wl = dict(batch=BATCH, seq_len=S, phase="decode")
    jp = JE.plan(JCFG, JWorkload(**wl), J_TPU, global_ratio=0.5).partition(jparams, align=32)
    tp = TE.plan(TCFG, TWorkload(**wl), T_TPU, global_ratio=0.5).partition(tparams, align=32)
    toks = np.random.default_rng(3).integers(3, JCFG.vocab, (BATCH, PROMPT)).astype(np.int32)
    logits, cache = JM.prefill(JCFG, jparams, {"tokens": jnp.asarray(toks)}, max_len=S)
    first = np.asarray(jnp.argmax(logits[:, -1], axis=-1)).astype(np.int32)
    return jp, tp, {k: np.asarray(v) for k, v in cache.items()}, first


def _run_both(model, kv_ratio, steps):
    jp, tp, cache, first = model
    jcache = JTD.split_cache_batch({k: jnp.asarray(v) for k, v in cache.items()}, kv_ratio)
    tcache = TTD.split_cache_batch({k: torch.from_numpy(v.copy()) for k, v in cache.items()},
                                   kv_ratio)
    jtok, ttok = first[:, None], torch.from_numpy(first[:, None].copy())
    for i in range(steps):
        jl, jcache = JTD.tiered_decode_step(JCFG, jp, jcache, jnp.asarray(jtok), PROMPT + i,
                                            window=2, use_kernel=True)
        tl, tcache = TTD.tiered_decode_step(TCFG, tp, tcache, ttok, PROMPT + i, window=2)
        assert rel_err(tl, jl) < FP32_TOL, f"step {i}"
        jtok = np.asarray(jnp.argmax(jl[:, 0], axis=-1)).astype(np.int32)[:, None]
        ttok = torch.argmax(tl[:, 0], dim=-1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
    return jcache, tcache


@pytest.mark.parametrize("kv_ratio,steps", [(0.5, 3), (0.0, 1), (1.0, 1)])
def test_tiered_decode_step_matches_reference(model, kv_ratio, steps):
    """Logits within 2e-4, the same greedy tokens, written rows within 2e-4
    and every other cache row exactly equal; offload 0 and 1 leave a tier
    empty."""
    jcache, tcache = _run_both(model, kv_ratio, steps)
    b_rem = int(round(BATCH * kv_ratio))
    written = slice(PROMPT, PROMPT + steps)
    for key in ("k_local", "v_local", "k_remote", "v_remote"):
        got, want = as_np(tcache[key]), as_np(jcache[key])
        assert got.shape == want.shape
        assert got.shape[1] == (b_rem if key.endswith("remote") else BATCH - b_rem)
        if not got.size:
            continue
        assert rel_err(got[:, :, written], want[:, :, written]) < FP32_TOL
        keep = np.ones(S, bool)
        keep[written] = False
        np.testing.assert_array_equal(got[:, :, keep], want[:, :, keep])


@pytest.mark.parametrize("kv_ratio,align,b_rem", [(0.4, 1, 2), (0.0, 1, 0), (1.0, 1, 5),
                                                   (0.5, 2, 2)])
def test_split_cache_batch_copies_both_halves(kv_ratio, align, b_rem):
    """The last round(B * kv_ratio / align) * align requests go remote, as in
    the reference; both tiers are fresh contiguous copies, so the unsplit
    cache can be freed (on the card the remote half then lives only in
    pinned memory)."""
    cache = {k: torch.randn(2, 5, 6, 2, 4) for k in ("k", "v")}
    out = TTD.split_cache_batch(cache, kv_ratio, align=align)
    jout = JTD.split_cache_batch({k: jnp.asarray(v.numpy()) for k, v in cache.items()},
                                 kv_ratio, align=align)
    assert out["k_local"].shape[1] == 5 - b_rem and out["k_remote"].shape[1] == b_rem
    for key, t in out.items():
        assert t.is_contiguous()
        assert t.untyped_storage().data_ptr() != cache[key[0]].untyped_storage().data_ptr()
        np.testing.assert_array_equal(as_np(t), as_np(jout[key]))
    torch.testing.assert_close(torch.cat([out["v_local"], out["v_remote"]], 1), cache["v"],
                               rtol=0, atol=0)

