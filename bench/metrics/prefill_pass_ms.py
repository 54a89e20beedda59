"""The engine's own time of a prefill pass (`EngineStats.prefill_time`
over its passes), over the admissions of the window: each pass holds every
decode row for its length."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "engine", "ms", "program_span", "tokens_per_s", "lower"


def read(r):
    return r.prefill_time_s / r.prefill_passes * 1e3 if r.prefill_passes else None
