"""``python -m repro_torch.analysis`` — run the static verifier over the
serving matrix and exit non-zero on any finding.

The matrix is every model family x offload ratio {0.0, 0.5, 1.0} x mesh
{1, 4 devices}.  Per point: plan checks (DAK2xx) and kernel lints (DAK1xx)
always run; the materialization taint lint (DAK0xx) traces the single-rank
program on the meta device at full size (the mesh path adds a gather over
a process group of P ranks, which a lint host does not start — its
mesh-specific invariants are covered structurally by DAK205/DAK102, and
chip phase 32 lints a one-rank mesh step on the card).  Per family: DAK204
re-partitions a real (smoke-shape) params tree and requires a fixed point.
Once per run: the page-table scenario drives a live ``PagedTieredCache``
through alloc/spill/demote/promote/free and checks DAK3xx after every
stage.

Counterpart of ``src/repro/analysis/cli.py``.  The default hardware
profile is the H100's: the kernel lints check the card's 227 KiB of shared
memory a CTA.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import configs
from repro_torch.analysis import findings as F
from repro_torch.analysis import kernel_lints, materialization, page_table, plan_checks
from repro_torch.analysis import surface
from repro_torch.core import engine as OE
from repro_torch.core.hardware import H100_SXM, HardwareSpec

FAMILIES = ("llama2_7b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
            "mamba2_370m", "zamba2_2p7b")
OFFLOADS = (0.0, 0.5, 1.0)
MESHES = (1, 4)
DTYPE_BYTES = 2     # the plans' and the kernel lints' element size: bf16, as the card serves
PASSES = ("plan", "kernels", "materialization", "repartition", "pagetable")


def _engine_align(cfg) -> int:
    # mirror ServingEngine's partition alignment choice
    return 32 if cfg.d_model < 1024 else 128


def _plan_for(cfg, hw: HardwareSpec, ratio: float, n_dev: int) -> OE.TieringPlan:
    wl = OE.WorkloadSpec(batch=4, seq_len=256, dtype_bytes=DTYPE_BYTES, phase="decode")
    mesh = OE.MeshSpec(n_devices=n_dev) if n_dev > 1 else None
    return OE.plan(cfg, wl, hw, global_ratio=ratio, mesh=mesh)


def _self_test() -> list[F.Finding]:
    """Corrupt a live cache on purpose; the checker MUST object (guards the
    CI wiring — a silently green verifier is worse than none)."""
    from repro_torch.serving.paged_cache import PagedTieredCache

    cache = PagedTieredCache(1, 1, 4, local_pages=2, remote_pages=2,
                             page_size=4, max_slots=1, max_pages_per_slot=4, device="cpu")
    cache.free[page_table.LOCAL].append(cache.free[page_table.LOCAL][0])
    return page_table.check_page_table(cache, where="self-test")


def run(archs=FAMILIES, offloads=OFFLOADS, meshes=MESHES, *,
        hw: HardwareSpec = H100_SXM, passes=PASSES,
        verbose: bool = True) -> tuple[list[F.Finding], list[str]]:
    """Run the requested passes; returns (findings, checked-site labels)."""
    out: list[F.Finding] = []
    checked: list[str] = []

    def note(msg: str) -> None:
        if verbose:
            print(msg, flush=True)

    for name in archs:
        cfg = configs.get(name)
        align = _engine_align(cfg)
        shapes = surface.operand_shapes(cfg)
        for ratio in offloads:
            for n_dev in meshes:
                site = f"{name}@{ratio}/P{n_dev}"
                plan = _plan_for(cfg, hw, ratio, n_dev)
                t0 = time.time()
                if "plan" in passes:
                    out.extend(plan_checks.check_plan(
                        plan, hw, cfg, shapes, align=align, where=site))
                    checked.append(f"{site}:plan")
                if "kernels" in passes:
                    out.extend(kernel_lints.check_kernels(
                        cfg, plan, hw, shapes, align=align, where=site,
                        dtype_bytes=DTYPE_BYTES))
                    checked.append(f"{site}:kernels")
                if "materialization" in passes:
                    if n_dev == 1:
                        out.extend(materialization.lint_family(
                            cfg, plan, align=align, where=site))
                        checked.append(f"{site}:materialization")
                    else:
                        note(f"  {site}: materialization trace skipped "
                             "(the mesh gathers over a process group of P ranks; "
                             "covered by DAK205/DAK102)")
                note(f"  {site}: done in {time.time() - t0:.1f}s")
        if "repartition" in passes:
            # DAK204 needs real tensors — smoke shapes partition in ms and
            # exercise the same split/realize arithmetic.
            cfg_s = configs.get_smoke(name)
            align_s = _engine_align(cfg_s)
            plan_s = _plan_for(cfg_s, hw, 0.5, 1)
            from repro_torch.models import model as M

            params = M.init_params(cfg_s, torch.Generator().manual_seed(0), device="cpu")
            tiered = plan_s.partition(params, align=align_s)
            out.extend(plan_checks.check_repartition_idempotent(
                tiered, plan_s, align=align_s, where=f"{name}/smoke"))
            checked.append(f"{name}/smoke:repartition")

    if "pagetable" in passes:
        out.extend(page_table.run_scenario())
        checked.append("paged-cache-scenario:pagetable")
    return out, checked


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="DAK static verifier: prove the direct-access invariants "
                    "over the serving matrix of the PyTorch port.")
    ap.add_argument("--all", action="store_true",
                    help="full matrix (default when no --arch given)")
    ap.add_argument("--arch", action="append", default=[],
                    help="restrict to a family (repeatable)")
    ap.add_argument("--offload", action="append", type=float, default=[],
                    help="restrict offload ratios (repeatable)")
    ap.add_argument("--mesh", action="append", type=int, default=[],
                    help="restrict mesh sizes (repeatable)")
    ap.add_argument("--passes", default=",".join(PASSES),
                    help="comma-separated subset of passes")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--self-test", action="store_true",
                    help="corrupt a cache on purpose and require a non-zero "
                         "exit (verifies the CI wiring can fail)")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.self_test:
        fs = _self_test()
        print(F.format_text(fs, checked=["self-test"]))
        if args.json:
            F.write_report(args.json, fs, checked=["self-test"])
        # inverted exit: the seeded corruption MUST be caught
        return 0 if fs else 1

    archs = tuple(args.arch) or FAMILIES
    offloads = tuple(args.offload) or OFFLOADS
    meshes = tuple(args.mesh) or MESHES
    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    bad = set(passes) - set(PASSES)
    if bad:
        ap.error(f"unknown pass(es): {sorted(bad)}")
    unknown = [a for a in archs if a not in set(FAMILIES)]
    if unknown:
        ap.error(f"unknown arch(es): {unknown} (families: {list(FAMILIES)})")

    findings, checked = run(archs, offloads, meshes, passes=passes,
                            verbose=not args.quiet)
    print(F.format_text(findings, checked=checked))
    if args.json:
        F.write_report(args.json, findings, checked=checked)
    return 1 if findings else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
