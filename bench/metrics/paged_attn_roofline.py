"""Paged decode attention (`paged_attn*` kernels) against its bound: the K
and V each decode row attends, from the published KV width, split between
HBM and the host link by the page table's tiers (the program's count);
over the kernels' device time in the trace."""
from bench import devtrace, work

LAYER, UNIT, SOURCE, MOVES, BETTER = "kernels", "%", "device_trace", "tokens_per_s", "higher"
KERNEL = "paged_attn"


def read(r):
    if r.trace is None:
        return None
    t = devtrace.seconds_of(r.trace.kernels, KERNEL)
    if t <= 0:
        return None
    bound = 0.0
    for s in r.steps:
        kv = sum(s.ctxs) * work.kv_bytes_per_token(r.model)
        f = s.kv_remote / (s.kv_local + s.kv_remote) if s.kv_local + s.kv_remote else 0.0
        flops = sum(work.attn_flops(r.model, c) for c in s.ctxs)
        bound += work.bound_s(kv * (1 - f), kv * f, flops)
    return bound / t * 100
