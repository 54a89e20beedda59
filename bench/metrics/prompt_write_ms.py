"""Mean time a prefill pass of the window spends writing its prompt's K/V
into the slot's local and remote pages (`dak.prompt_write`: the paged
cache's `write_prompt`, after the pass and before the next request's;
program span)."""
from bench import spans

LAYER, UNIT, SOURCE, MOVES, BETTER = "host link", "ms", "program_span", "ttft_p95_ms", "lower"


def read(r):
    steps = spans.window(r)
    passes = [p for s in steps or [] for p in s.passes]
    return sum(p.write_s for p in passes) / len(passes) * 1e3 if passes else None
