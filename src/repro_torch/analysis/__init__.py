"""repro_torch.analysis — the page-table audit, plan checks and kernel lints.

Copies of the reference's ``src/repro/analysis`` modules, their imports
pointed at the port, each diffable against its reference:

- :mod:`repro_torch.analysis.kernel_lints` — DAK101-103 over the port's
  CUDA kernels: shared memory against the per-CTA opt-in limit (and rings
  the kernels cut), the TMA rules, grid coverage and host-first orders;
  also the lint of an autotune table;
- :mod:`repro_torch.analysis.plan_checks` — DAK201-205, planner
  postconditions (budget conservation, registry completeness, window
  optimality, repartition idempotence, mesh structure);
- :mod:`repro_torch.analysis.page_table` — DAK301-305, paged KV cache
  invariants (also live via ``ServingEngine(check_invariants=True)``),
  which guard the page table a graphed decode step reads from fixed
  device buffers.

Not ported yet: the materialization lint, the surface and the CLI.
"""
from repro_torch.analysis.findings import (RULES, Finding, format_text, render_report,
                                           write_report)
from repro_torch.analysis.kernel_lints import (SMEM_OPTIN_BYTES, AttnLaunch, GemmLaunch,
                                               PrefillLaunch, check_alignment_invariants,
                                               check_attn_launch, check_autotune_table,
                                               check_gemm_launch, check_kernels,
                                               check_order_permutation,
                                               check_paged_slot_order, check_prefill_launch,
                                               describe_launches, operand_shapes)
from repro_torch.analysis.page_table import InvariantViolation, check_page_table

__all__ = ["RULES", "SMEM_OPTIN_BYTES", "AttnLaunch", "Finding", "GemmLaunch",
           "InvariantViolation", "PrefillLaunch", "check_alignment_invariants",
           "check_attn_launch", "check_autotune_table", "check_gemm_launch", "check_kernels",
           "check_order_permutation", "check_page_table", "check_paged_slot_order",
           "check_prefill_launch", "describe_launches", "format_text", "operand_shapes",
           "render_report", "write_report"]
