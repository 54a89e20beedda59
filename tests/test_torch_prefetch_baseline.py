"""The port's copy of the prefetch baselines (FlexGen, vLLM prefetch, UVM,
direct access; modeled) against the reference's, on the H100 profile and
the TPU profile: same ops, same ratios, same latencies."""
from __future__ import annotations

import dataclasses

import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import engine as JE
from repro.core import hardware as JH
from repro.core import prefetch_baseline as JP
from repro.core.ebmodel import WorkloadSpec as JWorkload
from repro_torch.core import engine as TE
from repro_torch.core import hardware as TH
from repro_torch.core import prefetch_baseline as TP
from repro_torch.core.ebmodel import WorkloadSpec as TWorkload

RATIO_GRIDS = ([0.0], [0.25], [0.5], [1.0], "mixed")


def _hw_pair(name: str):
    """The port's profile and the same numbers as a reference HardwareSpec
    (the reference has no H100 preset)."""
    t = TH.SYSTEMS[name]
    fields = dataclasses.asdict(t)
    fields["hbm"] = JH.TierSpec(**fields["hbm"])
    fields["host"] = JH.TierSpec(**fields["host"])
    return JH.HardwareSpec(**fields), t


@pytest.mark.parametrize("hw_name", ["h100_sxm", "tpu_v5e"])
@pytest.mark.parametrize("arch", ["llama2_7b", "opt_30b", "qwen3_moe_30b_a3b"])
def test_every_baseline_equals_the_reference(hw_name, arch):
    jhw, thw = _hw_pair(hw_name)
    wl = dict(batch=4, seq_len=160, phase="decode")
    jops = JE.enumerate_ops(JC.get(arch), JWorkload(**wl))
    tops = TE.enumerate_ops(TC.get(arch), TWorkload(**wl))
    assert [dataclasses.astuple(o) for o in tops] == [dataclasses.astuple(o) for o in jops]
    assert sorted(TP.BASELINES) == sorted(JP.BASELINES)
    for grid in RATIO_GRIDS:
        ratios = ([(i % 5) / 4 for i in range(len(jops))] if grid == "mixed"
                  else grid * len(jops))
        for name in JP.BASELINES:
            jm, tm = JP.BASELINES[name](jhw), TP.BASELINES[name](thw)
            assert tm.total_latency(tops, ratios) == jm.total_latency(jops, ratios), name
            for jo, to, x in zip(jops, tops, ratios):
                assert tm.op_latency(to, x) == jm.op_latency(jo, x), (name, jo.name, x)
            if hasattr(jm, "theoretical_bound"):
                assert tm.theoretical_bound(tops, ratios) == jm.theoretical_bound(jops, ratios)
            else:
                assert tm.effective_link_bw() == jm.effective_link_bw()
        assert TP.direct_latency(tops, ratios, thw) == JP.direct_latency(jops, ratios, jhw)
