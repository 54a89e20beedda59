"""flash_prefill's designs on the CPU: which design a launch takes
(`flash_prefill.design`, by head dim, dtype and alignment), each design's
tiles, and its shared memory against the kernel's arithmetic written out
from ``csrc/flash_prefill.cu`` (`fma_smem`, `tc_smem`, `wg_smem`).  The
kernel's own count is held to the same numbers on the card
(`test_torch_gpu.py`); no JAX here: the reference has one tile design."""
from __future__ import annotations

import importlib

import pytest
import torch

from repro_torch.analysis import kernel_lints as KL
from repro_torch.kernels import flash_prefill

FP = importlib.import_module("repro_torch.kernels.flash_prefill")
BF, F32 = torch.bfloat16, torch.float32
OPT_IN = 227 * 1024          # dynamic shared memory a CTA may opt into (232448 bytes)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("hd", [1, 16, 32, 63, 64, 65, 96, 127, 128, 129, 192, 256])
def test_design_by_head_dim_dtype_and_alignment(hd, aligned):
    assert FP.design(hd, F32, aligned) == "fma"
    want = "wgmma" if hd in (64, 128) and aligned else "mma"
    assert FP.design(hd, BF, aligned) == want
    assert FP.design(hd, "bfloat16", aligned) == want      # dtype names too


@pytest.mark.parametrize("hd,dtype,tiles", [
    (64, BF, (128, 128)), (128, BF, (128, 128)),            # wgmma: WG_BQ x WG_BK
    (32, BF, (128, 64)), (96, BF, (128, 64)), (256, BF, (128, 64)),   # mma: TC_BQ x TC_BK
    (64, F32, (64, 64)), (128, F32, (64, 64)),              # fma: TILE x TILE
])
def test_tiles_are_the_designs(hd, dtype, tiles):
    assert FP.tiles(hd, dtype=dtype) == tiles
    assert FP.TILES[FP.design(hd, dtype)] == tiles


def _wg_smem(hd: int) -> int:
    # WG_ALIGN + (WG_BQ + 2 * WG_STAGES * WG_BK) * hd * 2 + (1 + 4 * WG_STAGES) * 8
    return 1024 + (128 + 2 * 2 * 128) * hd * 2 + (1 + 4 * 2) * 8


def _tc_smem(hd: int) -> int:
    # (TC_BQ + 4 * TC_BK) * (padded hd + 8) * 2
    padded = 32 if hd <= 32 else 64 if hd <= 64 else 128 if hd <= 128 else 256
    return (128 + 4 * 64) * (padded + 8) * 2


def _fma_smem(hd: int) -> int:
    # (3 * TILE * (hd + 1) + TILE * (TILE + 1) + 3 * TILE) * 4
    return (3 * 64 * (hd + 1) + 64 * 65 + 3 * 64) * 4


@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_smem_is_the_kernels_arithmetic(hd):
    assert FP.smem_footprint_bytes(hd, dtype=BF) == _wg_smem(hd)
    assert FP.smem_footprint_bytes(hd, dtype=BF, which="wgmma") == _wg_smem(hd)
    # Q and two stages of K and V: 160 KB of the 227 at hd 128
    assert _wg_smem(128) == 1024 + 160 * 1024 + 72


@pytest.mark.parametrize("hd", [30, 32, 64, 80, 96, 128, 192, 256])
def test_mma_and_fma_smem_are_the_kernels_arithmetic(hd):
    assert FP.smem_footprint_bytes(hd, dtype=BF, which="mma") == _tc_smem(hd)
    assert FP.smem_footprint_bytes(hd, dtype=F32) == _fma_smem(hd)
    if hd not in (64, 128):
        assert FP.smem_footprint_bytes(hd, dtype=BF) == _tc_smem(hd)


def test_every_design_fits_a_cta_at_every_head_dim():
    for hd in range(1, 257):
        for dtype, which in ((BF, "mma"), (F32, "fma"), (BF, None)):
            assert FP.smem_footprint_bytes(hd, dtype=dtype, which=which) <= OPT_IN, (hd, which)
    for hd in FP.WGMMA_HEAD_DIMS:
        assert FP.smem_footprint_bytes(hd, dtype=BF, which="wgmma") <= OPT_IN
    assert KL.SMEM_OPTIN_BYTES == OPT_IN


def test_the_lint_reads_the_designs_footprint():
    """DAK101 sees the chosen design's bytes: clean at every served head
    dim in both dtypes."""
    from repro_torch.core.hardware import H100_SXM

    for hd in (64, 80, 96, 128, 256):
        for db in (2, 4):
            assert KL.check_prefill_launch(KL.PrefillLaunch("p", hd, 2048, 2048, dtype_bytes=db),
                                           H100_SXM) == []


def test_cpu_calls_count_no_design():
    before = dict(flash_prefill.launches_by_design)
    q = torch.ones(1, 2, 3, 64, dtype=BF)
    flash_prefill(q, torch.ones(1, 1, 3, 64, dtype=BF), torch.ones(1, 1, 3, 64, dtype=BF))
    assert flash_prefill.launches_by_design == before
    assert set(before) == {"wgmma", "mma", "fma"}
