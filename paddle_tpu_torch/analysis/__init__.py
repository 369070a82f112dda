"""Program analysis (``paddle_tpu/analysis``): the cost model over one
counted run, structured findings, and recompile monitoring.

    import paddle_tpu_torch.analysis as analysis
    report = analysis.check(fn, *args, passes=["cost-model"])
    report.extras["cost"].table()        # FLOPs/bytes roll-up
    report.extras["cost"].roofline_seconds()

The JAX package traces a jaxpr abstractly; the port counts one real
eager run of the program with a ``TorchDispatchMode``
(``passes/cost_model.py``), so ``check`` runs ``fn`` once.  The other
passes of the JAX package (the linter's recompile-hazard, dtype
promotion, dead code and sharding consistency, the autoshard planner and
the kernel verifier) and the artifact linter wait (ROADMAP.md, queue 1,
item 10): asking for one raises ``NotImplementedError``."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from paddle_tpu_torch.analysis.diagnostics import (AnalysisError,
                                                   AnalysisReport,
                                                   Diagnostic, Severity,
                                                   dedup)
from paddle_tpu_torch.analysis.recompile import (SignatureMonitor,
                                                 enable_recompile_monitoring,
                                                 leaf_signature,
                                                 monitor_recompiles,
                                                 monitoring_enabled)
from paddle_tpu_torch.analysis.passes import (DEFAULT_PASSES, PassContext,
                                              all_passes, get_pass,
                                              register_pass)
from paddle_tpu_torch.analysis.passes.cost_model import (CostCounter,
                                                         CostSummary,
                                                         count_cost)

__all__ = [
    "check", "run_passes", "count_cost",
    "Diagnostic", "Severity", "AnalysisReport", "AnalysisError", "dedup",
    "PassContext", "register_pass", "all_passes", "DEFAULT_PASSES",
    "CostCounter", "CostSummary",
    "SignatureMonitor", "enable_recompile_monitoring", "leaf_signature",
    "monitor_recompiles", "monitoring_enabled", "analysis_mode",
]


def analysis_mode() -> Optional[str]:
    """The ``PADDLE_TPU_ANALYZE`` switch: None (off, the default),
    ``'warn'`` or ``'strict'``."""
    v = os.environ.get("PADDLE_TPU_ANALYZE", "").strip().lower()
    if v in ("", "0", "off", "false"):
        return None
    return "strict" if v == "strict" else "warn"


def run_passes(run: CostCounter, passes: Optional[List[str]] = None,
               options: Optional[Dict] = None,
               target: str = "<program>") -> AnalysisReport:
    """Drive the pass pipeline over a counted run."""
    fns = [(p, get_pass(p)) for p in (passes or DEFAULT_PASSES)]
    report = AnalysisReport(target=target)
    ctx = PassContext(run=run, options=dict(options or {}))
    for pass_id, fn in fns:
        report.extend(fn(ctx))
        report.passes_run.append(pass_id)
    report.extras.update(ctx.extras)
    return report


def check(fn_or_layer, *example_args, passes: Optional[List[str]] = None,
          method: Optional[str] = None, options: Optional[Dict] = None,
          strict: bool = False, **example_kwargs) -> AnalysisReport:
    """Run ``fn_or_layer(*example_args, **example_kwargs)`` once, counted
    (a Layer's ``method=`` selects e.g. ``"loss"``; a ``TrainStep``
    counts one step that keeps no update), then the pass pipeline over
    that run.  Every pass is looked up before the run, so an unported
    one raises before anything executes.  ``strict=True`` raises
    ``AnalysisError`` on an ERROR-severity finding."""
    for p in passes or DEFAULT_PASSES:
        get_pass(p)
    if hasattr(fn_or_layer, "count_cost"):
        run = fn_or_layer.count_cost(*example_args, **example_kwargs)
    else:
        fn = getattr(fn_or_layer, method) if method else fn_or_layer
        _, run = count_cost(fn, *example_args, **example_kwargs)
    target = getattr(fn_or_layer, "__name__", type(fn_or_layer).__name__)
    report = run_passes(run, passes=passes, options=options, target=target)
    if strict:
        report.raise_on_error()
    return report
