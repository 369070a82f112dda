"""The pass pipeline over a counted run (``paddle_tpu/analysis/passes``).

A pass is a callable ``(PassContext) -> List[Diagnostic]`` registered
under a string id, as in the JAX package.  The JAX package's passes read
a jaxpr; here a pass reads one eager run of the program, counted by the
cost model's dispatch mode (``PassContext.run``).  The cost model is the
one built-in pass; the JAX package's others (``recompile-hazard``,
``dtype-promotion``, ``dead-code``, ``sharding-consistency``,
``autoshard``, ``kernel-verify``) are not ported yet, and asking for one
raises ``NotImplementedError`` (ROADMAP.md, queue 1, item 10)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

from paddle_tpu_torch.analysis.diagnostics import Diagnostic

__all__ = ["PassContext", "register_pass", "get_pass", "all_passes",
           "DEFAULT_PASSES"]


@dataclasses.dataclass
class PassContext:
    """Everything a pass may look at: ``run``, the counted run (a
    ``CostCounter``); ``options``, per-run settings (the cost model's
    roofline); ``extras``, where passes park structured results (the
    cost model's ``CostSummary`` under ``"cost"``)."""

    run: Any
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def opt(self, key: str, default=None):
        return self.options.get(key, default)


_REGISTRY: Dict[str, Callable[[PassContext], List[Diagnostic]]] = {}

# the passes the port has
DEFAULT_PASSES = ["cost-model"]


def register_pass(pass_id: str):
    def deco(fn):
        _REGISTRY[pass_id] = fn
        fn.pass_id = pass_id
        return fn
    return deco


def get_pass(pass_id: str):
    try:
        return _REGISTRY[pass_id]
    except KeyError:
        raise NotImplementedError(
            f"analysis pass {pass_id!r} is not ported yet (ROADMAP.md, "
            f"queue 1, item 10); the port has {sorted(_REGISTRY)}") from None


def all_passes() -> Dict[str, Callable]:
    return dict(_REGISTRY)


from paddle_tpu_torch.analysis.passes import cost_model  # noqa: E402,F401
