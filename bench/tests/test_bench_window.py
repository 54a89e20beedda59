"""The window's arithmetic: rates over the whole window, the tail over every
request, and the closed loop's stamps."""
import dataclasses

import numpy as np
import pytest

from bench import clients, harness, program
from bench.tests.conftest import ROOT

ZERO = program.Counters(0, 0, 0, 0)


def readings(**kw) -> harness.Readings:
    base = dict(model={}, mix={}, setup_s=12.5, window_s=40.0, tokens=500, gaps_s=[],
                ttfts_s=[], steps=[], decode_time_s=0.0, decode_steps=0, prefill_time_s=0.0,
                prefill_passes=0, counters=ZERO, trace=None)
    return harness.Readings(**{**base, **kw})


def reader(name):
    return harness.load_reader(ROOT, name)


def test_tokens_per_s_over_the_whole_window():
    assert reader("tokens_per_s").read(readings(tokens=500, window_s=40.0)) == 12.5


def test_ttft_p95_over_every_request():
    ttfts = [0.5] * 19 + [2.5]
    assert reader("ttft_p95_ms").read(readings(ttfts_s=ttfts)) == pytest.approx(600.0)
    assert reader("ttft_p95_ms").read(readings(ttfts_s=[])) is None


def test_engine_metrics_need_their_events():
    r = readings(decode_time_s=12.0, decode_steps=10, prefill_time_s=0.0, prefill_passes=0)
    assert reader("decode_step_ms").read(r) == pytest.approx(1200.0)
    assert reader("prefill_pass_ms").read(r) is None
    assert reader("prefill_pass_ms").read(dataclasses.replace(
        r, prefill_time_s=3.0, prefill_passes=2)) == pytest.approx(1500.0)
    for name in ("device_idle_pct", "gemm_decode_roofline", "gemm_prefill_roofline",
                 "paged_attn_roofline"):
        assert reader(name).read(r) is None                 # no trace, nothing to read


@dataclasses.dataclass
class FakeRequest:
    out_tokens: list
    t_done: float = 0.0


def test_closed_loop_stamps_and_resends():
    plans = [[clients.Planned(c, k, np.arange(10 + c, dtype=np.int32), 3) for k in range(3)]
             for c in range(2)]
    sent = []
    loop = clients.ClosedLoop(plans, lambda p, rid: FakeRequest([]), sent.append)
    loop.start()
    assert [t.sent for t in loop.tracks()] == [0.0, 0.0]
    assert len(sent) == 2
    a, b = sent
    a.out_tokens += [5, 6]                 # prefilled and decoded in one step
    b.out_tokens += [7, 8]
    tokens, ctxs, prefills = loop.observe(1.0, 1)
    assert (tokens, sorted(ctxs), sorted(prefills)) == (4, [11, 12], [10, 11])
    a.out_tokens.append(9)
    a.t_done = 2.0
    tokens, ctxs, prefills = loop.observe(2.0, 2)
    assert (tokens, ctxs, prefills) == (1, [12], [])
    assert len(sent) == 3 and loop.live[0].req is sent[2]   # client 0 sent its next
    assert loop.live[0].sent == 2.0                         # at the step's end
    assert loop.done[0].stamps == [1.0, 1.0, 2.0] and loop.done[0].admitted_at == 1
