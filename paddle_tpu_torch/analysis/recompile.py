"""Recompile-hazard detection: call-signature monitoring
(``paddle_tpu/analysis/recompile.py``).

A compiled step is fixed to the shapes and dtypes it was compiled for:
the JAX package's jit retraces and recompiles on a novel signature, and
the port's ``TrainStep`` runs a call whose batch does not match its
captured graph eagerly.  Either way a novel signature costs; the classic
sources are rank-varying inputs (pad-to-bucket forgotten) and python
scalars that alternate between int and float.  A tensor has no weak
type, so that leaf of the signature is always False here.

Recording is off until switched on globally (``PADDLE_TPU_ANALYZE``,
``enable_recompile_monitoring()`` or the ``monitor_recompiles()``
context manager) or for one monitor (``monitor.enabled = True``);
``record`` returns whether a signature is novel either way, which the
recompile counter reads."""

from __future__ import annotations

import contextlib
import os
from typing import List

from paddle_tpu_torch.analysis.diagnostics import Diagnostic, Severity

__all__ = ["SignatureMonitor", "enable_recompile_monitoring",
           "monitor_recompiles", "monitoring_enabled", "leaf_signature"]

_ENABLED = bool(os.environ.get("PADDLE_TPU_ANALYZE"))


def enable_recompile_monitoring(on: bool = True):
    global _ENABLED
    _ENABLED = on


def monitoring_enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def monitor_recompiles():
    """Record signatures for every monitor inside the block."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = True
    try:
        yield
    finally:
        _ENABLED = prev


def leaf_signature(x):
    if isinstance(x, bool):
        return ("pyscalar", "bool")
    if isinstance(x, int):
        return ("pyscalar", "int")
    if isinstance(x, float):
        return ("pyscalar", "float")
    if isinstance(x, complex):
        return ("pyscalar", "complex")
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return ("array", tuple(x.shape), _dtype_name(x.dtype), False)
    return ("static", type(x).__name__)


def _dtype_name(dtype) -> str:
    """``float32`` for ``torch.float32`` and numpy's ``float32`` alike
    (JAX's dtypes print so)."""
    return str(dtype).replace("torch.", "")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):      # jax.tree.leaves' order
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


class SignatureMonitor:
    """Bounded per-callable log of call signatures, turned into
    Diagnostics by the recompile-hazard pass (or ``.report()``
    directly)."""

    def __init__(self, name: str = "<program>", max_records: int = 256,
                 cache_threshold: int = 8):
        self.name = name
        self.max_records = max_records
        self.cache_threshold = cache_threshold
        self.enabled = False          # per-callable override
        self.calls = 0
        self.records: List[tuple] = []   # unique signatures, call order
        self._seen = set()

    @property
    def active(self) -> bool:
        return self.enabled or _ENABLED

    def record(self, args, kwargs=None) -> bool:
        """Returns True when this call's signature is NOVEL (i.e. it
        would retrace) — the observability recompile counter feeds off
        this return value."""
        self.calls += 1
        sig = tuple(leaf_signature(v)
                    for v in _leaves((args, kwargs or {})))
        if sig not in self._seen and len(self.records) < self.max_records:
            self._seen.add(sig)
            self.records.append(sig)
            return True
        return False

    def clear(self):
        self.calls = 0
        self.records = []
        self._seen = set()

    def report(self) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        n = len(self.records)
        if n == 0:
            return diags
        if n > self.cache_threshold:
            diags.append(Diagnostic(
                "recompile-hazard", Severity.WARNING,
                f"executable-cache churn on {self.name}: {n} distinct "
                f"call signatures across {self.calls} calls — each one "
                f"is a separate compile (or, off a captured graph, an "
                f"eager step)",
                hint="pin shapes with input_spec / pad to buckets; keep "
                     "dtypes and scalar-vs-array choices stable"))

        width = max(len(s) for s in self.records)
        for pos in range(width):
            col = [s[pos] for s in self.records if pos < len(s)]
            kinds = {c[0] for c in col}
            if "pyscalar" in kinds and "array" in kinds:
                diags.append(Diagnostic(
                    "recompile-hazard", Severity.WARNING,
                    f"argument leaf {pos} of {self.name} alternates "
                    f"between python scalar and array (weak-type flip "
                    f"→ retrace)",
                    hint="convert once at the boundary: "
                         "torch.as_tensor(x, dtype=...) on every call"))
                continue
            arrays = [c for c in col if c[0] == "array"]
            if len({len(c[1]) for c in arrays}) > 1:
                diags.append(Diagnostic(
                    "recompile-hazard", Severity.WARNING,
                    f"argument leaf {pos} of {self.name} varies in RANK "
                    f"across calls ({sorted({len(c[1]) for c in arrays})})"
                    f" — every rank is a separate executable",
                    hint="reshape/squeeze at the call boundary so the "
                         "compiled signature is stable"))
            if len({(c[2], c[3]) for c in arrays}) > 1 \
                    and len({c[2] for c in arrays}) == 1:
                diags.append(Diagnostic(
                    "recompile-hazard", Severity.WARNING,
                    f"argument leaf {pos} of {self.name} flips weak_type "
                    f"with identical shape/dtype — python-scalar capture "
                    f"forcing silent retraces",
                    hint="an explicit dtype makes the leaf the same "
                         "on every call"))
            scalar_kinds = {c[1] for c in col if c[0] == "pyscalar"}
            if len(scalar_kinds) > 1:
                diags.append(Diagnostic(
                    "recompile-hazard", Severity.WARNING,
                    f"argument leaf {pos} of {self.name} is a python "
                    f"scalar of varying type ({sorted(scalar_kinds)})",
                    hint="normalize to one numeric type before the call"))
        return diags
