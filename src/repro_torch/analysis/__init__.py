"""repro_torch.analysis — static verifier for the DAK direct-access
invariants of the port.

Four passes, each with stable ``DAKxxx`` rule IDs (see ``findings.RULES``),
the counterparts of the reference's ``src/repro/analysis`` modules:

- :mod:`repro_torch.analysis.materialization` — DAK001-003, no
  HBM-materialization: a taint walk (a ``TorchDispatchMode``) over the aten
  ops of the serving entry points, on the meta device at full size
  (:mod:`repro_torch.analysis.surface` builds the abstract params, tiers
  and pools), on CPU tensors and around a live engine on the card;
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

``python -m repro_torch.analysis --all`` (:mod:`repro_torch.analysis.cli`)
runs every pass over the serving matrix and exits non-zero on any finding.
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
