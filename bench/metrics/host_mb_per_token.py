"""Bytes the kernels read over the host link in the window (the program's
device counts of the dense GEMM, the grouped GEMM and paged attention),
per output token."""
LAYER, UNIT, SOURCE, MOVES, BETTER = "host link", "MB/token", "program_counter", "tokens_per_s", "lower"


def read(r):
    return r.counters.host_bytes / r.tokens / 1e6 if r.tokens else None
