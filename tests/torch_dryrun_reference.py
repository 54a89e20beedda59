"""The JAX package's dry-run figures that tests/test_torch_dryrun.py holds the
port to, written as JSON to the path given as the first argument; the
second is a JSON list of cells ``[name, arch, step, seq_len, batch,
microbatches]``.

Run in a subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu`` (the flag must be set before JAX starts, and importing
the reference's own ``repro.launch.dryrun`` would ask for 512 devices).  Each
cell is a smoke config at a small `ShapeConfig` on a (data 2, model 4)
mesh, lowered and compiled as the reference's ``dryrun.lower_cell`` does
it: the same FSDP rule, ZeRO-1 grad specs and in/out shardings, built from
the reference's own `steps` and `sharding`, and counted by its
`hlo_cost.analyze`.
"""
from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp

import repro.configs as C
from repro.configs.base import ShapeConfig
from repro.launch import hlo_cost, sharding, steps
from repro.launch.mesh import axis_size, data_axes


def lower(cfg, shape: ShapeConfig, mesh, microbatches: int):
    dtype = jnp.bfloat16
    fsdp = shape.step == "train" or cfg.param_count() * 2 / mesh.shape["model"] > 10e9
    p_shapes = steps.params_shapes(cfg, dtype)
    p_spec = sharding.named(mesh, sharding.param_specs(cfg, p_shapes, mesh, fsdp=fsdp))
    b_spec = sharding.named(mesh, sharding.batch_specs(cfg, shape, mesh))
    in_specs = steps.input_specs(cfg, shape, dtype)
    with jax.sharding.set_mesh(mesh):
        if shape.step == "train":
            strategy = sharding.train_strategy(cfg, mesh)
            sharded_specs = sharding.param_specs(cfg, p_shapes, mesh, fsdp=True)
            if strategy == "zero1":
                p_spec = sharding.named(
                    mesh, sharding.param_specs(cfg, p_shapes, mesh, fsdp=False))
            o_spec = sharding.named(mesh, sharding.opt_specs(sharded_specs))
            assert microbatches == steps.pick_microbatches(
                cfg, shape, axis_size(mesh, data_axes(mesh))) or microbatches > 1
            fn = steps.make_train_step(
                cfg, num_microbatches=microbatches,
                grad_specs=sharded_specs if strategy == "zero1" else None)
            jitted = jax.jit(fn, in_shardings=(p_spec, o_spec, b_spec),
                             out_shardings=(None, p_spec, o_spec, None),
                             donate_argnums=(0, 1))
            lowered = jitted.lower(p_shapes, steps.opt_shapes(p_shapes), in_specs)
        elif shape.step == "prefill":
            c_spec = sharding.named(mesh, sharding.cache_specs(cfg, shape, mesh))
            jitted = jax.jit(steps.make_prefill_step(cfg), in_shardings=(p_spec, b_spec),
                             out_shardings=(None, c_spec))
            lowered = jitted.lower(p_shapes, in_specs)
        else:
            c_spec = sharding.named(mesh, sharding.cache_specs(cfg, shape, mesh))
            jitted = jax.jit(
                steps.make_decode_step(cfg),
                in_shardings=(p_spec, c_spec, b_spec["tokens"],
                              jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())),
                out_shardings=(None, c_spec), donate_argnums=(1,))
            lowered = jitted.lower(p_shapes, steps.cache_shapes(cfg, shape, dtype),
                                   in_specs["tokens"], in_specs["pos"])
    return hlo_cost.analyze(lowered.compile().as_text())


def main(out: str, cells: str) -> None:
    if jax.device_count() < 8:
        raise SystemExit("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    # Auto axes: the reference was written where ``make_mesh`` made them;
    # this JAX makes Explicit axes, under which its sharding hints assert
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    res = {}
    for name, arch, step, seq, batch, mb in json.loads(cells):
        cost = lower(C.get_smoke(arch), ShapeConfig(name, seq, batch, step), mesh, mb)
        res[name] = {"flops": cost.flops, "bytes": cost.bytes,
                     "collective_counts": cost.collective_counts,
                     "collective_by_kind": cost.collective_by_kind,
                     "dots": cost.dot_flops_by_shape}
    with open(out, "w") as fh:
        json.dump(res, fh)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
