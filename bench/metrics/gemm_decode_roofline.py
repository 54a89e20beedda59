"""The split-K decode GEMM (`splitk_gemm_decode_kernel`) against its bound:
every decode step's tiered weights (`work.dense_gemm_params`), split
between HBM and the host link as the HBM budget forces, and an untied
lm_head at each prefill's last position; over the kernel's device time in
the trace."""
from bench import devtrace, work

LAYER, UNIT, SOURCE, MOVES, BETTER = "kernels", "%", "device_trace", "tokens_per_s", "higher"
KERNEL = "splitk_gemm_decode_kernel"


def read(r):
    if r.trace is None:
        return None
    t = devtrace.seconds_of(r.trace.kernels, KERNEL)
    if t <= 0:
        return None
    m, eb = r.model, work.elem_bytes(r.model)
    ratio = work.offload_ratio(m, r.mix)
    w = work.dense_gemm_params(m)
    head = 0 if m.get("tie_embeddings") else work.head_params(m)
    bound = 0.0
    for s in r.steps:
        if s.ctxs:
            bound += work.split_bound_s(w * eb, ratio, 2 * w * len(s.ctxs))
        if head:
            bound += len(s.prefills) * work.split_bound_s(head * eb, ratio, 2 * head)
    return bound / t * 100
