"""Structured findings for program analysis (a copy of
``paddle_tpu/analysis/diagnostics.py``, which imports no JAX): one
format for the passes, the profiler and the callers that print them.
``where`` names an operator or an argument here (the JAX package's
points at jaxpr equations)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Optional

__all__ = ["Severity", "Diagnostic", "AnalysisReport", "AnalysisError"]


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self):
        return self.name


@dataclasses.dataclass
class Diagnostic:
    """One finding: which pass, how bad, where in the program, and what
    to do about it.  ``where`` names the operator or the argument the
    finding is about; ``eqn_index`` is kept for the JAX package's field
    (the index of the equation there)."""

    pass_id: str
    severity: Severity
    message: str
    where: str = ""
    hint: str = ""
    eqn_index: Optional[int] = None
    count: int = 1

    def format(self) -> str:
        loc = f" @ {self.where}" if self.where else ""
        mult = f" (×{self.count})" if self.count > 1 else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return (f"[{self.severity}] {self.pass_id}: {self.message}"
                f"{mult}{loc}{hint}")

    def __str__(self):
        return self.format()


class AnalysisError(RuntimeError):
    """Raised by strict mode when a report carries ERROR findings."""

    def __init__(self, report: "AnalysisReport"):
        self.report = report
        errs = report.errors()
        super().__init__(
            f"{len(errs)} ERROR-severity finding(s):\n"
            + "\n".join(d.format() for d in errs))


class AnalysisReport:
    """Ordered findings from one pass-pipeline run plus per-pass extras
    (the cost model parks its roll-up under ``extras['cost']``)."""

    def __init__(self, target: str = "<program>"):
        self.target = target
        self.diagnostics: List[Diagnostic] = []
        self.extras: Dict[str, Any] = {}
        self.passes_run: List[str] = []

    def extend(self, diags: List[Diagnostic]):
        self.diagnostics.extend(diags)

    def by_pass(self, pass_id: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.pass_id == pass_id]

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= Severity.ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    @property
    def ok(self) -> bool:
        return not self.errors()

    def raise_on_error(self):
        if not self.ok:
            raise AnalysisError(self)

    def format(self, min_severity: Severity = Severity.INFO) -> str:
        shown = [d for d in self.diagnostics if d.severity >= min_severity]
        head = (f"analysis report for {self.target} — "
                f"{len(self.passes_run)} passes, "
                f"{len(self.errors())} error(s), "
                f"{len(self.warnings())} warning(s)")
        if not shown:
            return head + "\n  (clean)"
        return head + "\n" + "\n".join("  " + d.format() for d in shown)

    def __str__(self):
        return self.format()

    def __len__(self):
        return len(self.diagnostics)


def dedup(diags: List[Diagnostic]) -> List[Diagnostic]:
    """Collapse repeated findings (same pass/severity/message/where) into
    one entry with a count — a 32-layer model repeats every per-layer
    finding 32×, which would drown the report."""
    seen: Dict[tuple, Diagnostic] = {}
    out: List[Diagnostic] = []
    for d in diags:
        key = (d.pass_id, d.severity, d.message, d.where)
        if key in seen:
            seen[key].count += d.count
        else:
            seen[key] = d
            out.append(d)
    return out
