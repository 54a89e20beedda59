"""Model FLOPs of every token the window decoded and prefilled, from the
published shapes, over the window at the card's bf16 peak."""
from bench import peaks, work

LAYER, UNIT, SOURCE, MOVES, BETTER = "model step", "%", "host_clock", "tokens_per_s", "higher"


def read(r):
    flops = sum(work.decode_flops(r.model, s.ctxs) + sum(work.prefill_flops(r.model, t)
                                                          for t in s.prefills)
                for s in r.steps)
    return flops / (r.window_s * peaks.BF16_FLOPS) * 100
