"""Output tokens emitted in the window, over the window (host clock)."""
LAYER, UNIT, SOURCE, MOVES, BETTER = None, "tokens/s", "host_clock", None, "higher"


def read(r):
    return r.tokens / r.window_s
