"""The port's kernel wrappers and plain versions against the JAX package.

On the CPU every wrapper computes its plain version; those are held
against the JAX oracles (`repro.kernels.ref`) and the JAX Pallas kernels in
interpret mode (`repro.kernels.ops`), fp32 within 2e-4 relative.  The
CUDA kernels themselves are held against these plain versions on the card
by tests/test_torch_gpu.py."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tiering as JT
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import tiering as TT
from repro_torch.kernels import ops as tops
from repro_torch.kernels.splitk_flashattn import paged_splitk_flashattn, scatter_rows
from repro_torch.kernels.splitk_gemm import splitk_gemm
from torch_helpers import FP32_TOL, rel_err


def _gemm_inputs(m, k, n, ratio, seed, align=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jw = JT.partition(jnp.asarray(w), ratio, axis=1, align=align)
    tw = TT.partition(torch.from_numpy(w), ratio, axis=1, align=align)
    return x, jw, tw


@pytest.mark.parametrize("m,k,n", [(32, 128, 256), (130, 384, 640)])
@pytest.mark.parametrize("ratio", [0.0, 0.25, 0.5, 1.0])
def test_tiered_matmul_matches_reference(m, k, n, ratio):
    x, jw, tw = _gemm_inputs(m, k, n, ratio, seed=m + k + n)
    assert tuple(tw.local.shape) == tuple(jw.local.shape)
    got = tops.tiered_matmul(torch.from_numpy(x), tw, window=2)
    want_kernel = jops.tiered_matmul(jnp.asarray(x), jw, window=2)
    want_oracle = jref.splitk_gemm_ref(jnp.asarray(x), jw.local, jw.remote)
    assert rel_err(got, want_kernel) < FP32_TOL
    assert rel_err(got, want_oracle) < FP32_TOL
    assert rel_err(TT.matmul(torch.from_numpy(x), tw), want_oracle) < FP32_TOL


@pytest.mark.parametrize("window", [1, 2, 4])
def test_tiered_matmul_window_and_batched_input(window):
    """Results never depend on the window; leading dims are kept."""
    x, jw, tw = _gemm_inputs(64, 256, 384, 0.33, seed=window)
    x3 = torch.from_numpy(x).reshape(4, 16, 256)
    got = tops.tiered_matmul(x3, tw, window=window)
    assert got.shape == (4, 16, 384)
    want = jops.tiered_matmul(jnp.asarray(x).reshape(4, 16, 256), jw, window=window)
    assert rel_err(got, want) < FP32_TOL


def _paged_inputs(b, h, kh, hd, ps, mp, p_loc, p_rem, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    pools = {n: rng.normal(size=(p + 1, ps, kh, hd)).astype(np.float32)
             for n, p in (("k_local", p_loc), ("v_local", p_loc),
                          ("k_remote", p_rem), ("v_remote", p_rem))}
    tier = rng.integers(0, 2, size=(b, mp)).astype(np.int32)
    table = rng.integers(0, min(p_loc, p_rem), size=(b, mp)).astype(np.int32)
    return q, pools, table, tier


@pytest.mark.parametrize("window", [1, 2, 4])
@pytest.mark.parametrize("lens", [[5, 0, 17, 32], [1, 1, 1, 1], [32, 32, 32, 32]])
def test_paged_attention_matches_reference(window, lens):
    """Ragged lengths (with 0), random page tables, pages in both tiers."""
    q, pools, table, tier = _paged_inputs(4, 8, 2, 32, 8, 4, 6, 5, seed=window * 10 + lens[0])
    lens = np.asarray(lens, np.int32)
    t = torch.from_numpy
    got = tops.paged_decode_attention(t(q), {k: t(v) for k, v in pools.items()},
                                      t(table), t(tier), t(lens), window=window)
    jpools = {k: jnp.asarray(v) for k, v in pools.items()}
    want_kernel = jops.paged_decode_attention(
        jnp.asarray(q), jpools, jnp.asarray(table), jnp.asarray(tier), jnp.asarray(lens),
        window=window)
    want_oracle = jref.paged_flashattn_ref(
        jnp.asarray(q), jpools["k_local"], jpools["v_local"], jpools["k_remote"],
        jpools["v_remote"], jnp.asarray(table), jnp.asarray(tier), jnp.asarray(lens))
    assert rel_err(got, want_kernel) < FP32_TOL
    assert rel_err(got, want_oracle) < FP32_TOL
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(got[i] == 0)


@pytest.mark.parametrize("case", ["scale", "k_only"])
def test_paged_attention_scale_and_k_only_pools(case):
    """The `scale` override (MLA) and V read from the K pool."""
    q, pools, table, tier = _paged_inputs(3, 16, 1, 24, 4, 3, 4, 4, seed=3)
    if case == "k_only":
        pools["v_local"], pools["v_remote"] = pools["k_local"], pools["k_remote"]
    scale = 0.11 if case == "scale" else None
    lens = np.asarray([7, 12, 0], np.int32)
    t = torch.from_numpy
    got = tops.paged_decode_attention(t(q), {k: t(v) for k, v in pools.items()},
                                      t(table), t(tier), t(lens), scale=scale)
    jpools = {k: jnp.asarray(v) for k, v in pools.items()}
    want = jops.paged_decode_attention(jnp.asarray(q), jpools, jnp.asarray(table),
                                       jnp.asarray(tier), jnp.asarray(lens), scale=scale)
    assert rel_err(got, want) < FP32_TOL


def test_scatter_rows_matches_reference_scatter():
    """The decode row writer's plain version is the reference's
    `.at[i, idx, off].set` into one layer of a pool, sinks included."""
    rng = np.random.default_rng(0)
    pool = rng.normal(size=(2, 5, 4, 2, 3)).astype(np.float32)      # [L, P+1, ps, Kh, hd]
    rows = rng.normal(size=(3, 2, 3)).astype(np.float32)
    wr_tier = np.asarray([0, 1, 0], np.int32)
    wr_idx = np.asarray([1, 2, 3], np.int32)
    wr_off = np.asarray([0, 3, 2], np.int32)
    sink = 4
    got = torch.from_numpy(pool.copy())
    scatter_rows(got[1], torch.from_numpy(rows), torch.from_numpy(wr_tier),
                 torch.from_numpy(wr_idx), torch.from_numpy(wr_off), 0, sink, remote=False)
    idx = jnp.where(wr_tier == 0, wr_idx, sink)
    want = jnp.asarray(pool).at[1, idx, wr_off].set(jnp.asarray(rows))
    np.testing.assert_array_equal(got.numpy()[:, :sink], np.asarray(want)[:, :sink])


def test_wrappers_take_the_plain_version_only_on_cpu():
    """CPU tensors compute the plain version and count no launch; any
    other device raises instead of falling back."""
    before = (splitk_gemm.launches, paged_splitk_flashattn.launches)
    x = torch.ones(2, 4)
    y = splitk_gemm(x, torch.ones(4, 3), torch.ones(4, 2))
    assert torch.equal(y, torch.full((2, 5), 4.0))
    assert (splitk_gemm.launches, paged_splitk_flashattn.launches) == before
    meta = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        splitk_gemm(meta, torch.empty(4, 3, device="meta"), torch.empty(4, 2, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_splitk_flashattn(torch.empty(1, 2, 4, device="meta"),
                               *[torch.empty(2, 1, 1, 4, device="meta")] * 4,
                               *[torch.empty(1, 1, dtype=torch.int32, device="meta")] * 2,
                               torch.empty(1, dtype=torch.int32, device="meta"))
