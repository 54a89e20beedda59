"""The check's control and its faults, at a size the CPU holds: the
reference in fp8 (the precision below the configuration's) put in the
program's place, and a served token altered where the step produces it,
must both come out not correct through the run's own checks, while the
program itself reads within the limit."""
import time

import pytest
import torch

from bench import harness
from bench.tests.conftest import TINY_LIMIT

SEEDS = (2**31 + 7, 11, 4_000_000_123)


@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-moe.tiny"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_control_fails_the_limit(tiny_root, cell, seed):
    res = harness.run_cell(cell, seed, 1.0, False, time.perf_counter(), root=tiny_root,
                           device="cpu", judged="fp8", log=lambda *_: None)
    assert res["checks"]["logit_gap"]["limit"] == TINY_LIMIT
    assert res["checks"]["logit_gap"]["value"] == res["control"]["fp8"]
    assert not res["correct"]
    assert res["control"]["fp32"] <= TINY_LIMIT and res["failed"] == 0


@pytest.mark.parametrize("cell", ["tiny-dense.tiny", "tiny-moe.tiny"])
def test_altered_token_is_not_correct(tiny_root, cell, monkeypatch):
    from repro_torch.serving import engine as E

    step = E._decode_step

    def altered(cfg, *args, **kw):
        tok = step(cfg, *args, **kw)
        return torch.remainder(tok + 1, cfg.vocab).to(tok.dtype)

    monkeypatch.setattr(E, "_decode_step", altered)
    res = harness.run_cell(cell, SEEDS[0], 0.2, False, time.perf_counter(), root=tiny_root,
                           device="cpu", log=lambda *_: None)
    assert not res["correct"]
    assert res["checks"]["logit_gap"]["value"] > res["checks"]["logit_gap"]["limit"]
