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
from repro_torch.kernels import _build, flash_prefill
from repro_torch.kernels.splitk_flashattn import (
    paged_splitk_flashattn,
    scatter_rows,
    splitk_flashattn,
)
from repro_torch.kernels.splitk_gemm import (
    CLUSTER_MAX,
    CLUSTER_MAX_SPLITS,
    DECODE_BK,
    DECODE_BN,
    REMOTE_CTAS_PER_SM,
    decode_k_split,
    gemm_tiling,
    grouped_launch,
    grouped_tiling,
    smem_footprint_bytes,
    splitk_gemm,
)
from torch_helpers import FP32_TOL, rel_err


def _gemm_inputs(m, k, n, ratio, seed, align=128):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    jw = JT.partition(jnp.asarray(w), ratio, axis=1, align=align)
    tw = TT.partition(torch.from_numpy(w), ratio, axis=1, align=align)
    return x, jw, tw


@pytest.mark.parametrize("m,k,n", [(32, 128, 256), (130, 384, 640), (300, 128, 256)])
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
    counters = (splitk_gemm, paged_splitk_flashattn, splitk_flashattn, flash_prefill)
    before = [f.launches for f in counters]
    x = torch.ones(2, 4)
    y = splitk_gemm(x, torch.ones(4, 3), torch.ones(4, 2))
    assert torch.equal(y, torch.full((2, 5), 4.0))
    splitk_flashattn(torch.ones(2, 2, 4), *[torch.ones(1, 3, 1, 4)] * 4, kv_len=2)
    flash_prefill(torch.ones(1, 2, 3, 4), torch.ones(1, 1, 3, 4), torch.ones(1, 1, 3, 4))
    assert [f.launches for f in counters] == before
    meta = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        splitk_gemm(meta, torch.empty(4, 3, device="meta"), torch.empty(4, 2, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_splitk_flashattn(torch.empty(1, 2, 4, device="meta"),
                               *[torch.empty(2, 1, 1, 4, device="meta")] * 4,
                               *[torch.empty(1, 1, dtype=torch.int32, device="meta")] * 2,
                               torch.empty(1, dtype=torch.int32, device="meta"))


def test_batch_split_and_prefill_wrappers_raise_on_other_devices():
    """The two newer wrappers refuse a tensor that is on neither the CPU nor
    a CUDA card (here `meta`) instead of falling back."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        splitk_flashattn(torch.empty(2, 4, 8, **meta), *[torch.empty(1, 6, 2, 8, **meta)] * 4,
                         kv_len=3)
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_prefill(torch.empty(1, 4, 5, 8, **meta), torch.empty(1, 2, 5, 8, **meta),
                      torch.empty(1, 2, 5, 8, **meta))


H100_SMS = 132
# (K, N_rem) of every llama2-7b projection at offload 0.5, as the decode
# design sees them (wq, wkv, wo, wi, wdown, lm_head)
LLAMA2_7B_REMOTE = [(4096, 2048), (4096, 4096), (4096, 2048), (4096, 11008), (11008, 2048),
                    (4096, 16000)]


@pytest.mark.parametrize("k,n_loc,n_rem,sms", [(k, n, n, H100_SMS) for k, n in LLAMA2_7B_REMOTE]
                         + [(4096, 3968, 128, H100_SMS), (11008, 3968, 128, H100_SMS),
                            (100, 0, 520, H100_SMS), (32, 8, 256, H100_SMS),
                            (4096, 1024, 0, H100_SMS), (4096, 0, 0, H100_SMS),
                            (11008, 0, 300_000, H100_SMS), (4096, 64, 64, 1),
                            # wq/wo and wdown as the planner splits them at
                            # launch/serve.py's default offload 0.4 (align 128)
                            (4096, 2432, 1664, H100_SMS), (11008, 2432, 1664, H100_SMS)])
def test_decode_k_split_covers_k_and_fills_the_card(k, n_loc, n_rem, sms):
    """The decode design's K split: non-empty splits starting at multiples
    of DECODE_BK that cover [0, K) exactly and give one remote CTA per SM
    (local ones when the remote tier is empty) wherever K has enough loads;
    a remote tier of that many tiles or more is not split."""
    split = decode_k_split(n_loc, n_rem, k, sms)
    tiles = max(1, -(-(n_rem or n_loc) // DECODE_BN))
    loads = -(-k // DECODE_BK)
    assert split > 0 and split % DECODE_BK == 0
    bounds = [(b, min(k, b + split)) for b in range(0, k, split)]
    assert all(b % DECODE_BK == 0 and e > b for b, e in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(e == nb for (_, e), (nb, _) in zip(bounds, bounds[1:]))
    ctas = tiles * len(bounds)
    assert ctas >= min(REMOTE_CTAS_PER_SM * sms, tiles * loads)
    if tiles >= REMOTE_CTAS_PER_SM * sms:
        assert len(bounds) == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("m", [1, 16, 17, 64, 65, 192, 384, 513, 1100])
def test_grouped_tiling_reads_each_expert_once_per_cluster(m, dtype):
    """The grouped entry's M tiling: M <= 16 and fp32 keep the split-K
    tiling (M tiles of the power of two >= M up to 64, each reading its
    expert); bf16 past 16 rows takes clusters of at most 8 tiles of 64 rows
    (128 past 512), which read each expert once up to 8 x MB rows; every
    row is in one tile and the grid's M axis is whole clusters."""
    t = grouped_tiling(m, dtype)
    assert t.m_tiles == -(-m // t.mb) and t.m_tiles <= t.grid_z < t.m_tiles + t.cluster
    assert t.grid_z % t.cluster == 0 and 1 <= t.cluster <= CLUSTER_MAX
    if m <= 16 or dtype == torch.float32:
        mb = min(64, 1 << (m - 1).bit_length())
        assert (t.design, t.mb, t.cluster, t.grid_z) == ("split-K", mb, 1, -(-m // mb))
        assert t.reads == -(-m // 64) if m > 64 else t.reads == 1
    else:
        assert t.design == "cluster" and t.mb == (64 if m <= 512 else 128)
        assert t.reads == -(-m // (CLUSTER_MAX * t.mb))
        assert (t.reads == 1) == (m <= CLUSTER_MAX * t.mb)
        old = grouped_tiling(m, dtype, design="split-K")
        assert old.reads == -(-m // 64)


def test_grouped_launch_geometry_matches_hand_worked_numbers():
    """One Qwen3 layer's remote wi (64 experts, K 2048, N 1536) at a
    2048-token prefill (M 192) and at decode (M 1), window 1, 132 SMs."""
    bf = torch.bfloat16
    g = grouped_launch(64, 192, 2048, 1536, bf, window=1, sm_count=132)
    # clusters of 3 tiles of 64 rows; 24 x 64 tiles >= 132: one split
    assert (g.tiling.cluster, g.grid, g.threads, g.box) == (3, (24, 64, 3), 160, (64, 64))
    # ring: 3 x 1 x 4 KB in flight = 1.5 boxes of 8 KB -> 2 stages of
    # (8192 + 64*64*2) B, two mbarriers each, 1024 B of alignment slack
    assert (g.wanted, g.stages, g.cut) == (2, 2, None)
    assert g.smem_bytes == 1024 + 2 * (8192 + 8192 + 16)
    assert g.tickets == g.workspace == 0
    d = grouped_launch(64, 1, 2048, 1536, bf, window=1, sm_count=132)
    assert (d.tiling.design, d.grid, d.threads, d.box, d.stages) == \
        ("split-K", (24, 64, 1), 64, (64, 32), 1)
    # one stage of (32 * 64 + 1 * 32) * 2 = 4160 B, rounded to 128 B, and its mbarrier
    assert d.smem_bytes == 4224 + 8
    # few tiles: K splits of 64 rows with tickets per (expert, M tile, N tile)
    s = grouped_launch(3, 300, 512, 64, bf, window=2, sm_count=132)
    assert (s.k_split, s.splits, s.grid, s.tickets) == (64, 8, (8, 3, 5), 3 * 5 * 1)
    assert s.workspace == 8 * 3 * 300 * 64


@pytest.mark.parametrize("rows", ["16-byte", "ragged"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("m", [1, 16, 17, 64, 65, 128, 129, 513, 704, 2000, 2052])
def test_gemm_tiling_reads_the_remote_tier_once_per_cluster(m, dtype, rows):
    """The wrapper's design by M, dtype and operands (`gemm_tiling`): M <=
    16 takes split-K (one read); fp32 past that, and rows no tensor map
    can describe (N_rem 11002), take whole K, reading the weights once per M
    tile as before (ceil(M / 128) past 64 rows); bf16 past 16 rows the
    cluster design, once per cluster of up to 8 M tiles, on a grid of whole
    clusters and a workspace within CLUSTER_MAX_SPLITS copies of y."""
    k, n_loc, n_rem = 4096, 11008, 11008 if rows == "16-byte" else 11002
    t = gemm_tiling(m, k, n_loc, n_rem, dtype, sm_count=H100_SMS)
    if m <= 16 and rows == "16-byte":
        assert (t.design, t.reads, t.k_split) == \
            ("split-K", 1, decode_k_split(n_loc, n_rem, k, H100_SMS))
    elif dtype == torch.bfloat16 and rows == "16-byte":
        assert t.design == "cluster" and 1 <= t.cluster <= CLUSTER_MAX
        assert t.mb == (64 if m <= 512 else 128) and t.m_tiles == -(-m // t.mb)
        assert t.reads == -(-t.m_tiles // CLUSTER_MAX) and t.grid_z % t.cluster == 0
        assert t.m_tiles <= t.grid_z < t.m_tiles + t.cluster
        assert t.grid == (344 * t.splits * t.reads, 1, t.cluster)
        assert t.k_split % 64 == 0 and t.splits == -(-k // t.k_split) <= CLUSTER_MAX_SPLITS
    else:
        assert t.design == "whole-K" and t.k_split == 0 and t.workspace == 0
        assert t.reads == (1 if m <= 64 else -(-m // 128))
    assert t.workspace <= CLUSTER_MAX_SPLITS * m * (n_loc + n_rem)
    # bases off 16 bytes keep whole K at every M; a narrow remote tier takes
    # the most splits, its workspace at the cap
    assert gemm_tiling(m, k, n_loc, n_rem, dtype, aligned=False).design == "whole-K"
    narrow = gemm_tiling(m, k, 0, 64, dtype, sm_count=H100_SMS)
    if narrow.design == "cluster":
        assert narrow.splits == CLUSTER_MAX_SPLITS
        assert narrow.workspace == CLUSTER_MAX_SPLITS * m * 64


def test_gemm_tiling_geometry_matches_hand_worked_numbers():
    """llama2-7b's wi at offload 0.5 (K 4096, N 11008 | 11008) on 132 SMs."""
    bf = torch.bfloat16
    t = gemm_tiling(2048, 4096, 11008, 11008, bf, sm_count=132)
    # 2048 rows: 16 tiles of 128 (8 of 64 no longer cover M) in 2 clusters
    # of 8; 172 remote tiles x 16 M tiles >= 132 CTAs: one split
    assert (t.design, t.mb, t.cluster, t.m_tiles, t.grid_z, t.reads) == \
        ("cluster", 128, 8, 16, 16, 2)
    assert (t.k_split, t.splits, t.grid, t.workspace, t.tickets) == \
        (4096, 1, (344 * 2, 1, 8), 0, 0)
    # ring at window 1: 8 x 1 x 4 KB in flight = 4 boxes of 8 KB -> 4 stages
    # of (8192 + 128 * 64 * 2) B, two mbarriers each, 1024 B of slack
    assert smem_footprint_bytes(2048, 4096, 11008, 11008, window=1, k_split=4096,
                                dtype=bf) == 1024 + 4 * (8192 + 16384 + 16)
    # the remote tier crosses the link twice, where whole K read it 16 times
    assert gemm_tiling(2048, 4096, 11008, 11008, bf, k_split=0).reads == 16
    # wq at 128 rows: 2 tiles of 64 in one cluster; 32 remote tiles x 2 CTAs
    # = 64 CTAs a split -> 3 splits of 22 boxes (1408 rows), tickets per
    # (M tile, N tile) and a workspace of 3 copies of y
    q = gemm_tiling(128, 4096, 2048, 2048, bf, sm_count=132)
    assert (q.mb, q.cluster, q.k_split, q.splits, q.grid) == (64, 2, 1408, 3, (192, 1, 2))
    assert (q.tickets, q.workspace) == (64 * 2, 3 * 128 * 4096)


@pytest.mark.parametrize("lib,fn", [(lib, fn) for lib, fns in _build._SIGNATURES.items()
                                    for fn in fns])
def test_ctypes_signature_matches_the_c_entry_point(lib, fn):
    """Each C entry point the wrappers call through ctypes is declared with
    as many arguments as its `extern "C"` prototype takes (a list one short
    or long only fails on the card, at the first call)."""
    import re

    src = (_build.CSRC / f"{lib}.cu").read_text()
    proto = re.search(r'extern "C" int ' + fn + r"\((.*?)\)\s*\{", src, re.S)
    assert proto is not None, fn
    assert len([a for a in proto.group(1).split(",") if a.strip()]) == \
        len(_build._SIGNATURES[lib][fn]), fn
