"""Shared helpers of the PyTorch-port tests (test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU.  Tolerances are the reference's own kernel tolerances
(tests/test_kernels.py): 2e-4 relative in fp32.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.tiering import TieredTensor

FP32_TOL = 2e-4


def as_np(a) -> np.ndarray:
    """A torch tensor or a JAX array as a float32/int numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.float().numpy() if a.is_floating_point() else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (tests/test_kernels.py's measure)."""
    a, b = as_np(a), as_np(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9)) if b.size else 0.0


@pytest.fixture
def cuda_device() -> torch.device:
    """The card, for tests marked `gpu`; decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run `pytest -m gpu` on the card)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The paged decode step's inputs and the engines' traffic, shared by the
# engine tests of each family (test_torch_engine.py, _moe.py, _mla.py)
# ---------------------------------------------------------------------------
PAGED_SINKS = (4, 5)                  # (local, remote) pool pages before each sink
PAGED_STEP_ORDER = ("tokens", "positions", "attn_lens", "table", "tier", "wr_tier",
                    "wr_idx", "wr_off")
SERVE_PROMPT_LENS = (10, 16, 7, 14, 9)  # tests/test_serving.py: forces tier spills


def paged_step_inputs(n_layers: int, kv_names, kh: int, hd: int, page: int = 4):
    """Pools {name_tier: [L, P+1, page, Kh, hd]} and the paged decode step's
    arguments for 3 slots (slot 2 idle, pointed at the local sink), numpy
    from a seed; pass the arguments in `PAGED_STEP_ORDER`."""
    rng = np.random.default_rng(5)
    n_loc, n_rem = PAGED_SINKS
    pools = {f"{kv}_{t}": rng.normal(size=(n_layers, n + 1, page, kh, hd)).astype(np.float32)
             for kv in kv_names for t, n in (("local", n_loc), ("remote", n_rem))}
    lens = np.asarray([10, 9, 0], np.int32)
    args = dict(tokens=np.asarray([[3], [7], [5]], np.int32), positions=lens,
                attn_lens=np.where(lens > 0, lens + 1, 0).astype(np.int32),
                table=np.asarray([[0, 1, 2, 0], [3, 0, 1, 0], [0, 0, 0, 0]], np.int32),
                tier=np.asarray([[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0]], np.int32),
                wr_tier=np.asarray([0, 1, 0], np.int32),
                wr_idx=np.asarray([2, 1, n_loc], np.int32),
                wr_off=np.asarray([2, 1, 0], np.int32))
    return pools, args


def assert_pools_match(got: dict, want: dict) -> None:
    """Every written pool agrees below its sink page (sinks are never read)."""
    for key in want:
        sink = PAGED_SINKS[0] if key.endswith("local") else PAGED_SINKS[1]
        assert rel_err(as_np(got[key])[:, :sink], as_np(want[key])[:, :sink]) < FP32_TOL, key


def serve(engine_cls, request_cls, cfg, params, hw, ratio, seed, new_tokens=6, **kw):
    """Serve `SERVE_PROMPT_LENS` prompts (3 slots, max_len 32, page 4)
    through one engine; returns (stats, requests)."""
    eng = engine_cls(cfg, params, max_batch=3, max_len=32, hw=hw,
                     global_offload_ratio=ratio, page_size=4, **kw)
    rng = np.random.default_rng(seed)
    reqs = [request_cls(rid=i, prompt=rng.integers(3, cfg.vocab, n).astype(np.int32),
                        max_new_tokens=new_tokens) for i, n in enumerate(SERVE_PROMPT_LENS)]
    for r in reqs:
        eng.submit(r)
    return eng.run(), reqs


def assert_caches_match(jc, tc) -> None:
    """A JAX and a port `PagedTieredCache` hold the same page tables, tiers,
    free lists, owners, counters and elastic budget, pools of the same
    shapes, and equal pool contents below each sink page."""
    np.testing.assert_array_equal(tc.table, jc.table)
    np.testing.assert_array_equal(tc.tier, jc.tier)
    np.testing.assert_array_equal(tc.n_pages, jc.n_pages)
    assert tc.free == jc.free
    assert tc._owner == jc._owner
    assert (tc.spills, tc.promotions, tc.demotions) == (jc.spills, jc.promotions, jc.demotions)
    assert (tc.local_in_use, tc.remote_in_use) == (jc.local_in_use, jc.remote_in_use)
    assert (tc.n_remote, tc.local_limit, tc.local_free, tc.local_deficit) == \
        (jc.n_remote, jc.local_limit, jc.local_free, jc.local_deficit)
    for key, pool in tc.pools.items():
        assert tuple(pool.shape) == tuple(jc.pools[key].shape), key
        sink = tc.sink_local if key.endswith("local") else tc.sink_remote
        np.testing.assert_array_equal(as_np(pool)[:, :sink], as_np(jc.pools[key])[:, :sink])


# ---------------------------------------------------------------------------
# Trees: the layer-by-layer build against `partition(whole)`, and the
# recurrent families' leaves redrawn away from their init values
# ---------------------------------------------------------------------------
def flat_tree(tree, prefix=""):
    """(path, leaf) pairs of a nested params tree, in its order."""
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from flat_tree(leaf, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", leaf


def assert_trees_equal(got: dict, want: dict) -> None:
    """Same paths in the same order, every leaf (both tiers of a tiered
    one, each contiguous) bit for bit."""
    got, want = dict(flat_tree(got)), dict(flat_tree(want))
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, TieredTensor):
            assert isinstance(g, TieredTensor) and g.axis == w.axis, key
            assert torch.equal(g.local, w.local) and torch.equal(g.remote, w.remote), key
            assert g.local.is_contiguous() and g.remote.is_contiguous(), key
        else:
            assert not isinstance(g, TieredTensor) and torch.equal(g, w), key


# init_params sets these to 0 or 1, which would hide a wrong path
RECURRENT_REDRAWN = ("dt_bias", "A_log", "D", "ssm_norm_w", "ln1_w", "ln2_w", "final_w")


def redraw_recurrent_leaves(tree: dict, seed: int) -> list[str]:
    """Redraw, in place in a numpy params tree, the SSM leaves and every
    norm weight away from their init values (dt_bias and A_log around 0,
    the others around 1), from `seed`; returns the paths redrawn."""
    rng = np.random.default_rng(seed)
    drawn = []
    for path, leaf in list(flat_tree(tree)):
        if path.rsplit("/", 1)[-1] not in RECURRENT_REDRAWN:
            continue
        noise = rng.normal(scale=0.3, size=leaf.shape).astype(np.float32)
        node = tree
        *parents, key = path.split("/")
        for k in parents:
            node = node[k]
        node[key] = noise if key in ("dt_bias", "A_log") else 1.0 + noise
        drawn.append(path)
    return drawn
