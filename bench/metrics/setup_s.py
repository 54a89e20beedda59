"""Process start to the first timed step: weights, engine, slot fill and
graph capture (and, in a checkout's first run, the kernels' build)."""
LAYER, UNIT, SOURCE, MOVES, BETTER = None, "s", "host_clock", None, "lower"


def read(r):
    return r.setup_s
