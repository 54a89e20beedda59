"""95th percentile (linear interpolation) of the time to first token of
every request sent in the window that the window served a token: from the
end of the step after which its client sent it to the end of the step that
prefilled it (host clock)."""
import numpy as np

LAYER, UNIT, SOURCE, MOVES, BETTER = None, "ms", "host_clock", None, "lower"


def read(r):
    return float(np.percentile(r.ttfts_s, 95)) * 1e3 if r.ttfts_s else None
