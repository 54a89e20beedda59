"""Mean wait of a request admitted in the window, from its submission to
the start of its first prefill pass (`dak.prefill`): the passes ahead of it
in the same step and the step it was sent during (program span)."""
from bench import spans

LAYER, UNIT, SOURCE, MOVES, BETTER = "engine", "ms", "program_span", "ttft_p95_ms", "lower"


def read(r):
    steps = spans.window(r)
    waits = [p.t_prefill - p.t_submit for s in steps or [] for p in s.passes if p.pos == 0]
    return sum(waits) / len(waits) * 1e3 if waits else None
