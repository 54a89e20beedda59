"""repro_torch.analysis — the page-table audit and plan checks.

Copies of the reference's ``src/repro/analysis`` modules, their imports
pointed at the port, each diffable against its reference:

- :mod:`repro_torch.analysis.plan_checks` — DAK201-205, planner
  postconditions (budget conservation, registry completeness, window
  optimality, repartition idempotence, mesh structure);
- :mod:`repro_torch.analysis.page_table` — DAK301-305, paged KV cache
  invariants (also live via ``ServingEngine(check_invariants=True)``),
  which guard the page table a graphed decode step reads from fixed
  device buffers.

Not ported yet: the materialization lint, the kernel lints and the CLI.
"""
from repro_torch.analysis.findings import (RULES, Finding, format_text, render_report,
                                           write_report)
from repro_torch.analysis.page_table import InvariantViolation, check_page_table

__all__ = ["RULES", "Finding", "InvariantViolation", "check_page_table",
           "format_text", "render_report", "write_report"]
