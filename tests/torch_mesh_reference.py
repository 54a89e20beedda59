"""The JAX package's mesh serving figures that tests/test_torch_mesh.py holds
the port to, written as JSON to the path given as the only argument.

Run in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4
JAX_PLATFORMS=cpu`` (the flag must be set before JAX starts, and the test
process's JAX has started with one device).  It runs the reference's own
`_serve` (tests/test_mesh_serving.py): the single-device tokens of llama2-7b,
Qwen3 MoE and DeepSeek MLA smoke at offload {0, 0.5}, then llama2-7b at 0.5
on a 4-device mesh, static (tokens, `mesh_traffic_report()`) and adaptive
(tokens, the runtime's per-link windows and bandwidth entries).
"""
from __future__ import annotations

import json
import sys

import jax

import repro.configs as C
from repro.models import model as M
from test_mesh_serving import KEY, _mesh, _serve

ARCHS = ("llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b")


def main(out: str) -> None:
    if jax.device_count() < 4:
        raise SystemExit("needs XLA_FLAGS=--xla_force_host_platform_device_count=4")
    res: dict = {"tokens": {}}
    for arch in ARCHS:
        cfg = C.get_smoke(arch)
        params = M.init_params(cfg, KEY)
        for ratio in (0.0, 0.5):
            res["tokens"][f"{arch}/{ratio}"] = _serve(cfg, params, ratio)[1]
    cfg = C.get_smoke("llama2_7b")
    params = M.init_params(cfg, KEY)
    eng, res["mesh_tokens"] = _serve(cfg, params, 0.5, mesh=_mesh(4))
    res["report"] = eng.mesh_traffic_report()
    eng, res["adaptive_tokens"] = _serve(cfg, params, 0.5, mesh=_mesh(4), adaptive=True)
    rt = eng.runtime.report()
    res["windows"] = len(eng.runtime.windows)
    res["window_per_link"] = len(rt["window"]["per_link"])
    res["bw_per_link"] = len(rt["telemetry"]["bandwidth"]["per_link"])
    with open(out, "w") as fh:
        json.dump(res, fh, default=float)


if __name__ == "__main__":
    main(sys.argv[1])
