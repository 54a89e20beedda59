"""The cluster GEMM of prefill passes (`splitk_gemm_cluster_kernel`)
against its bound: each pass of t prompt tokens multiplies every layer's
tiered weights (`work.layer_gemm_params`) by t rows, the weights read once,
split between HBM and the host link as the HBM budget forces; over the
kernel's device time in the trace."""
from bench import devtrace, work

LAYER, UNIT, SOURCE, MOVES, BETTER = "kernels", "%", "device_trace", "tokens_per_s", "higher"
KERNEL = "splitk_gemm_cluster_kernel"


def read(r):
    if r.trace is None:
        return None
    t = devtrace.seconds_of(r.trace.kernels, KERNEL)
    if t <= 0:
        return None
    m, eb = r.model, work.elem_bytes(r.model)
    ratio = work.offload_ratio(m, r.mix)
    w = m["n_layers"] * work.layer_gemm_params(m)
    bound = sum(work.split_bound_s(w * eb, ratio, 2 * w * n)
                for s in r.steps for n in s.prefills)
    return bound / t * 100
