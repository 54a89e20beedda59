"""Finding records and the rule registry for the DAK static verifier.

Every check in ``repro.analysis`` reports through a :class:`Finding` tagged
with a stable rule ID (``DAK001`` …).  Rule IDs are append-only: once a rule
ships it keeps its ID and meaning forever, so CI logs and suppression
comments stay interpretable across PRs.

Rule ID space:

- ``DAK0xx`` — materialization lint (the direct-access guarantee).
- ``DAK1xx`` — kernel lints (VMEM footprint, TMA alignment, grid coverage).
- ``DAK2xx`` — plan validator (budget, registry, window, repartition, mesh).
- ``DAK3xx`` — page-table invariant checker (``PagedTieredCache``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

RULES: dict[str, str] = {
    "DAK001": "decode trace materializes a full-extent remote operand into HBM",
    "DAK002": "prefill/chunked-prefill trace materializes a remote operand into HBM",
    "DAK003": "remote KV pool materialized into an HBM-resident buffer",
    "DAK101": "kernel per-block VMEM footprint exceeds the hardware profile",
    "DAK102": "block/tier extents violate TMA-style alignment or divisibility",
    "DAK103": "kernel grid does not cover operand extents exactly (OOB or dead blocks)",
    "DAK201": "plan violates byte-budget conservation vs the greedy allocator",
    "DAK202": "planned op is not realized by any registry operand (or vice versa)",
    "DAK203": "congestion window is infeasible against the congestion model",
    "DAK204": "repartition under the already-realized plan is not a no-op",
    "DAK205": "mesh plan violates divisibility or per-link structure",
    "DAK301": "page free lists overlap owned pages or leak/duplicate indices",
    "DAK302": "tier tag disagrees with pool residency (page-table vs owner map)",
    "DAK303": "page aliased by multiple slots or owner map inconsistent",
    "DAK304": "elastic local_limit/local_deficit accounting out of bounds",
    "DAK305": "heat histogram inconsistent with the set of owned pages",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one site.

    ``where`` locates the artifact (e.g. ``llama2_7b/offload=0.5/decode`` or
    ``cache.free[LOCAL]``); ``detail`` is the human-readable evidence.
    """

    rule: str
    where: str
    detail: str
    context: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.rule not in RULES:
            raise ValueError(f"unknown rule id {self.rule!r}")

    def __str__(self) -> str:
        return f"{self.rule} [{self.where}] {self.detail}"

    def to_dict(self) -> dict[str, Any]:
        return {
            "rule": self.rule,
            "title": RULES[self.rule],
            "where": self.where,
            "detail": self.detail,
            "context": self.context,
        }


def render_report(findings: list[Finding], *, checked: list[str]) -> dict[str, Any]:
    """JSON-serializable report: findings plus the matrix of checks that ran
    (so "zero findings" is distinguishable from "nothing ran")."""
    return {
        "tool": "repro.analysis",
        "rules": dict(RULES),
        "checked": list(checked),
        "n_findings": len(findings),
        "findings": [f.to_dict() for f in findings],
    }


def format_text(findings: list[Finding], *, checked: list[str]) -> str:
    """Human-readable summary for the terminal / CI log."""
    lines = [f"repro.analysis: {len(checked)} checks, "
             f"{len(findings)} finding(s)"]
    lines.extend(f"  FAIL {f}" for f in findings)
    if not findings:
        lines.append("  all direct-access invariants hold")
    return "\n".join(lines)


def write_report(path: str, findings: list[Finding], *, checked: list[str]) -> None:
    with open(path, "w") as fh:
        json.dump(render_report(findings, checked=checked), fh, indent=2)
        fh.write("\n")
