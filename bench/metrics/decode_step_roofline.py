"""The tiered bound of the window's decode steps over the engine's decode
time: the weights each step reads (a MoE's experts as uniform routing
reaches them), split between HBM and the host link as the HBM budget
forces (`work.offload_ratio`), and the KV it attends, split by the page
table's tiers; at HBM and host-link peaks, beside its FLOPs."""
from bench import work

LAYER, UNIT, SOURCE, MOVES, BETTER = "model step", "%", "program_span", "tokens_per_s", "higher"


def read(r):
    if not r.decode_steps:
        return None
    m, eb = r.model, work.elem_bytes(r.model)
    ratio = work.offload_ratio(m, r.mix)
    bound = 0.0
    for s in r.steps:
        if not s.ctxs:
            continue
        w = work.step_weight_params(m, len(s.ctxs)) * eb
        kv = sum(s.ctxs) * work.kv_bytes_per_token(m)
        f = s.kv_remote / (s.kv_local + s.kv_remote) if s.kv_local + s.kv_remote else 0.0
        bound += work.bound_s(w * (1 - ratio) + kv * (1 - f), w * ratio + kv * f,
                              work.decode_flops(m, s.ctxs))
    return bound / r.decode_time_s * 100
