"""The engine's own time of a decode step (`EngineStats.decode_time` over
`decode_steps`), over the window's steps."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "engine", "ms", "program_span", "tokens_per_s", "lower"


def read(r):
    return r.decode_time_s / r.decode_steps * 1e3 if r.decode_steps else None
