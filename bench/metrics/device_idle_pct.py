"""Share of the window in which no operation ran on the device (the union
of the profiler's device intervals)."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "device", "%", "device_trace", "tokens_per_s", "lower"


def read(r):
    if r.trace is None:
        return None
    return (r.trace.window_s - r.trace.busy_s) / r.trace.window_s * 100
