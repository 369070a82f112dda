"""Measurement ledger + calibrated cost model
(``paddle_tpu/observability/calibration.py``, adapted).

A persistent corpus of measured (op, shape) -> seconds records, and a
cost model calibrated by it: the roofline predictions the device
profiler and the fusion-tier router consume are reconciled against
measured time.

**Measurement ledger** — an on-disk JSON corpus in the JAX package's
format, byte for byte (``LEDGER_VERSION``, entry fields, keys), so each
package reads the other's file:

* entries are keyed ``<op-class>|<shape-bucket>|<dtype>|<layout>@
  <backend-fingerprint>``; the shape bucket rounds each dim up to a
  power of two (leading dims flattened to a row count);
* the backend fingerprint is ``core.state.backend_fingerprint()``
  (``cuda:<card>:nN`` or ``cpu:cpu:n1``; the JAX package's are
  ``platform:device_kind:nN``): disjoint namespaces, so a CPU record can
  never answer a card's query, nor one package's backend the other's;
* a corrupt, truncated or old-schema file, or a malformed entry inside a
  valid one, is silently dropped, never raised;
* writes merge with the file and replace it atomically (tmp file +
  ``os.replace``), so concurrent processes cannot clobber each other.

Entries aggregate repeated measurements: running min (the number
queries serve), running mean, sample count, the model's prediction at
measurement time and a provenance set.

**Fed** (with ``PADDLE_TPU_CALIBRATION=1``) by ``DeviceProfiler.profile``
(each segment with its roofline prediction, under the fusion tier it ran
at); the JAX package's autotune and bench feeders have no counterpart in
the port yet.

**CalibratedCostModel** — per-(op-class, shape-bucket, backend) residual
factors ``measured / predicted`` correct ``roofline_seconds()`` where the
ledger has coverage and return the raw prediction where it has none;
``paddle_tpu_calibration_residual{segment}`` and
``paddle_tpu_calibration_coverage`` expose it (the ``calibration_drift``
watchdog rule reads the first).  ``measured_for`` answers the
``measured`` fusion tier (``ops/kernels/fused_block.py``).

Env knobs:
  PADDLE_TPU_CALIBRATION=1        feed and consult the ledger (default
                                  off: nothing recorded or calibrated)
  PADDLE_TPU_CALIBRATION_DIR=path ledger directory (default
                                  ~/.cache/paddle_tpu_torch/calibration)
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

__all__ = ["LEDGER_VERSION", "enabled", "ledger_dir", "ledger_path",
           "backend_tag", "shape_bucket", "make_key",
           "MeasurementLedger", "CalibratedCostModel", "ledger",
           "reset", "observe_residual", "set_coverage", "bench_detail"]

LEDGER_VERSION = 1

# provenance tags the feeders use (free-form strings are accepted; these
# are the three wired sources plus the test/manual tag)
PROVENANCES = ("device_profiler", "autotune", "bench", "bench_serve",
               "manual")


# -- knobs + keys ------------------------------------------------------------

def enabled() -> bool:
    """Opt-in: ``PADDLE_TPU_CALIBRATION=1``.  Default off — with the
    knob off no feeder records and no consumer calibrates."""
    return os.environ.get("PADDLE_TPU_CALIBRATION", "0") == "1"


def ledger_dir() -> str:
    return os.environ.get(
        "PADDLE_TPU_CALIBRATION_DIR",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "paddle_tpu_torch", "calibration"))


def ledger_path() -> str:
    return os.path.join(ledger_dir(), "ledger.json")


def backend_tag() -> str:
    """The backend component of every ledger key
    (:func:`~paddle_tpu_torch.core.state.backend_fingerprint`), in the
    key and implied by every default query."""
    from paddle_tpu_torch.core.state import backend_fingerprint
    return backend_fingerprint()


def _pow2(n: int) -> int:
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


def shape_bucket(shape) -> str:
    """Bucket a shape for the key: leading dims flatten to a row count
    and every component rounds up to a power of two — ``(4, 2048,
    2048)`` and ``(8, 1024, 2048)`` share ``r8192x2048``.  A string
    passes through verbatim (autotune keys are already
    content-addressed)."""
    if isinstance(shape, str):
        return shape
    dims = [int(d) for d in tuple(shape)]
    if not dims:
        return "scalar"
    if len(dims) == 1:
        return f"r{_pow2(dims[0])}"
    rows = 1
    for d in dims[:-1]:
        rows *= max(1, d)
    return f"r{_pow2(rows)}x{_pow2(dims[-1])}"


def make_key(op_class: str, shape, dtype: str = "",
             layout: str = "-", backend: Optional[str] = None) -> str:
    """``<op-class>|<shape-bucket>|<dtype>|<layout>@<backend>`` — the
    content address of one measurement population."""
    return (f"{op_class}|{shape_bucket(shape)}|{dtype or '-'}|"
            f"{layout or '-'}@{backend or backend_tag()}")


# -- telemetry ---------------------------------------------------------------

def _metrics(registry=None):
    if registry is None:
        from paddle_tpu_torch.observability.metrics import default_registry
        registry = default_registry()
    return {
        "ledger": registry.counter(
            "paddle_tpu_calibration_ledger_total",
            "measurement-ledger operations by outcome",
            labelnames=("result",)),
        "residual": registry.gauge(
            "paddle_tpu_calibration_residual",
            "measured/predicted residual factor per calibrated segment "
            "(1.0 = the model is telling the truth)",
            labelnames=("segment",)),
        "coverage": registry.gauge(
            "paddle_tpu_calibration_coverage",
            "fraction of cost-model queries the measurement ledger "
            "could serve"),
    }


def _count(result: str):
    try:
        _metrics()["ledger"].labels(result=result).inc()
    except Exception:
        pass


def observe_residual(segment: str, residual: float, registry=None):
    """Publish one residual factor to the gauge the watchdog's
    ``calibration_drift`` rule watches."""
    try:
        _metrics(registry)["residual"].labels(segment=segment).set(
            float(residual))
    except Exception:
        pass


def set_coverage(value: float, registry=None):
    try:
        _metrics(registry)["coverage"].set(float(value))
    except Exception:
        pass


# -- the ledger --------------------------------------------------------------

def _valid_entry(e) -> bool:
    """Per-entry validation applied on every load AND merge: a
    malformed entry inside an otherwise healthy file is dropped
    silently, exactly like an old-schema file."""
    try:
        return (isinstance(e, dict)
                and float(e["measured_s"]) > 0.0
                and int(e.get("n", 1)) >= 1
                and float(e.get("predicted_s", 0.0)) >= 0.0)
    except Exception:
        return False


def _parse(path: str) -> Optional[Dict[str, dict]]:
    """Entries of a ledger file, or None when the file is missing,
    truncated, corrupt or of a different schema version — silent
    invalidation, mirroring the autotune cache."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except Exception:
        return None
    if not isinstance(raw, dict) or raw.get("version") != LEDGER_VERSION:
        return None
    entries = raw.get("entries")
    if not isinstance(entries, dict):
        return None
    return {k: v for k, v in entries.items() if _valid_entry(v)}


class MeasurementLedger:
    """The persistent measured-(op, shape) → seconds corpus.

        led = MeasurementLedger()
        led.record("attention", x.shape, "bfloat16", measured_s=t,
                   predicted_s=pred, provenance="device_profiler")
        entry = led.query("attention", x.shape, "bfloat16")

    ``record`` merges into the in-memory view and (by default)
    persists via merge-then-atomic-replace; ``query`` only ever
    answers for the caller's backend fingerprint."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._mem: Dict[str, dict] = {}
        self._loaded = False
        self._lock = threading.Lock()

    @property
    def path(self) -> str:
        return self._path or ledger_path()

    # -- persistence --------------------------------------------------------
    def _load(self):
        if self._loaded:
            return
        self._loaded = True
        got = _parse(self.path)
        if got:
            self._mem.update(got)

    def reload(self):
        """Forget in-memory state so the next access re-reads the file
        (tests that swap PADDLE_TPU_CALIBRATION_DIR)."""
        with self._lock:
            self._mem.clear()
            self._loaded = False

    def clear(self):
        with self._lock:
            self._mem.clear()
            self._loaded = True
        try:
            os.remove(self.path)
        except OSError:
            pass

    def save(self):
        """Merge-then-atomic-replace, the autotune `_save` discipline:
        read whatever a concurrent process persisted, overlay this
        process's entries, land via tmp + ``os.replace``."""
        path = self.path
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with self._lock:
                merged = dict(_parse(path) or {})
                for key, mine in self._mem.items():
                    theirs = merged.get(key)
                    merged[key] = _merge(theirs, mine) \
                        if _valid_entry(theirs) else dict(mine)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump({"version": LEDGER_VERSION,
                               "entries": merged}, f, indent=0,
                              sort_keys=True)
                os.replace(tmp, path)
        except Exception:
            pass   # read-only fs: the in-memory ledger still works

    # -- record / query ------------------------------------------------------
    def record(self, op_class: str, shape, dtype: str = "", *,
               measured_s: float, predicted_s: float = 0.0,
               layout: str = "-", provenance: str = "manual",
               backend: Optional[str] = None, save: bool = True) -> str:
        """Merge one measurement into its population; returns the key.
        Non-positive measurements are rejected (a failed bench must not
        poison the corpus)."""
        measured_s = float(measured_s)
        if not (measured_s > 0.0) or measured_s != measured_s:
            return ""
        key = make_key(op_class, shape, dtype, layout, backend)
        fresh = {
            "op_class": op_class,
            "measured_s": measured_s,
            "mean_s": measured_s,
            "predicted_s": max(0.0, float(predicted_s or 0.0)),
            "n": 1,
            "provenance": [str(provenance)],
            "updated": time.time(),
        }
        with self._lock:
            self._load()
            old = self._mem.get(key)
            self._mem[key] = _merge(old, fresh) if _valid_entry(old) \
                else fresh
        _count("record")
        if save:
            self.save()
        return key

    def query(self, op_class: str, shape, dtype: str = "",
              layout: str = "-",
              backend: Optional[str] = None) -> Optional[dict]:
        """The aggregate entry for this population, or None.  The
        default backend is THIS process's fingerprint — asking from a
        CPU process can never surface a card's record, and vice
        versa."""
        key = make_key(op_class, shape, dtype, layout, backend)
        with self._lock:
            self._load()
            entry = self._mem.get(key)
        if _valid_entry(entry):
            _count("hit")
            return dict(entry)
        _count("miss")
        return None

    def entries(self, backend: Optional[str] = None) -> Dict[str, dict]:
        """Every valid entry (optionally one backend's), keyed by the
        full content address."""
        with self._lock:
            self._load()
            out = {k: dict(v) for k, v in self._mem.items()}
        if backend is not None:
            out = {k: v for k, v in out.items()
                   if k.endswith(f"@{backend}")}
        return out


def _merge(old: Optional[dict], new: dict) -> dict:
    """Aggregate two populations of the same key: min measured (the
    served number), running mean, summed count, latest nonzero
    prediction, provenance union."""
    if not old:
        return dict(new)
    n_old, n_new = int(old.get("n", 1)), int(new.get("n", 1))
    n = n_old + n_new
    mean = (float(old.get("mean_s", old["measured_s"])) * n_old
            + float(new.get("mean_s", new["measured_s"])) * n_new) / n
    prov = sorted(set(list(old.get("provenance", []))
                      + list(new.get("provenance", []))))[:8]
    return {
        "op_class": new.get("op_class", old.get("op_class", "")),
        "measured_s": min(float(old["measured_s"]),
                          float(new["measured_s"])),
        "mean_s": mean,
        "predicted_s": float(new.get("predicted_s") or 0.0)
        or float(old.get("predicted_s") or 0.0),
        "n": n,
        "provenance": prov,
        "updated": max(float(old.get("updated", 0.0)),
                       float(new.get("updated", 0.0))),
    }


# process-wide ledger (feeders write here; tests may build private
# instances or swap the env dir + reset())
_LEDGER: Optional[MeasurementLedger] = None
_LEDGER_LOCK = threading.Lock()


def ledger() -> MeasurementLedger:
    global _LEDGER
    if _LEDGER is None:
        with _LEDGER_LOCK:
            if _LEDGER is None:
                _LEDGER = MeasurementLedger()
    return _LEDGER


def reset():
    """Drop the process-wide ledger (tests that swap
    PADDLE_TPU_CALIBRATION_DIR between cases)."""
    global _LEDGER
    with _LEDGER_LOCK:
        _LEDGER = None


# -- the calibrated cost model -----------------------------------------------

class CalibratedCostModel:
    """Residual-corrected roofline: ``calibrate(predicted, op, shape)``
    multiplies the raw model's prediction by the ledger's
    measured/predicted factor for that (op-class, shape-bucket,
    backend) population — and falls back to the raw prediction when
    coverage is missing (no entry, no prediction recorded, or fewer
    than ``min_records`` samples).  Every query updates the coverage
    gauge; every served residual lands in the residual gauge the
    ``calibration_drift`` watchdog rule watches."""

    def __init__(self, ledger_: Optional[MeasurementLedger] = None,
                 min_records: int = 1, registry=None):
        self.ledger = ledger_ if ledger_ is not None else ledger()
        self.min_records = max(1, int(min_records))
        self._registry = registry
        self._queries = 0
        self._served = 0

    def residual_for(self, op_class: str, shape, dtype: str = "",
                     layout: str = "-",
                     backend: Optional[str] = None) -> Optional[float]:
        """measured/predicted for the population, or None without
        coverage.  >1 means the model is optimistic (real hardware is
        slower than the roofline), <1 pessimistic."""
        self._queries += 1
        entry = self.ledger.query(op_class, shape, dtype, layout,
                                  backend)
        res = None
        if entry and int(entry.get("n", 0)) >= self.min_records:
            pred = float(entry.get("predicted_s") or 0.0)
            if pred > 0.0:
                res = float(entry["measured_s"]) / pred
        if res is not None and res > 0.0:
            self._served += 1
            observe_residual(op_class, res, self._registry)
        else:
            res = None
        set_coverage(self.coverage(), self._registry)
        return res

    def measured_for(self, op_class: str, shape, dtype: str = "",
                     layout: str = "-",
                     backend: Optional[str] = None) -> Optional[float]:
        """The ledger's measured seconds for the population (min over
        samples), or None — for consumers that want the measurement
        itself (fusion-tier routing) rather than a correction factor."""
        entry = self.ledger.query(op_class, shape, dtype, layout,
                                  backend)
        if entry and int(entry.get("n", 0)) >= self.min_records:
            return float(entry["measured_s"])
        return None

    def calibrate(self, predicted_s: float, op_class: str, shape,
                  dtype: str = "", layout: str = "-",
                  backend: Optional[str] = None
                  ) -> Tuple[float, Optional[float]]:
        """``(calibrated_seconds, residual)`` — the coverage-gated
        correction: ``predicted × residual`` when the ledger can serve
        the query, the raw prediction (residual None) when it
        cannot."""
        res = self.residual_for(op_class, shape, dtype, layout, backend)
        if res is None or predicted_s <= 0.0:
            return float(predicted_s), res
        return float(predicted_s) * res, res

    def coverage(self) -> float:
        """Fraction of this model's queries the ledger served."""
        if not self._queries:
            return 0.0
        return self._served / self._queries


# -- overlap-fraction calibration --------------------------------------------

# the synthetic population the measured overlap fraction lives under:
# feeders that can time a collective against its compute window record
# the achieved hidden fraction here (measured_s carries the FRACTION)
OVERLAP_OP_CLASS = "overlap_fraction"


def record_overlap_fraction(fraction: float, provenance: str = "manual",
                            ledger_: Optional[MeasurementLedger] = None):
    """Persist a measured compute/collective overlap fraction (0..1) —
    the measurement source of the collective cost's
    ``overlap_fraction`` correction (which waits for the collectives:
    ROADMAP.md, queue 1, item 8)."""
    led = ledger_ if ledger_ is not None else ledger()
    led.record(OVERLAP_OP_CLASS, "global", measured_s=min(
        max(float(fraction), 1e-6), 1.0), predicted_s=0.0,
        provenance=provenance)


def calibrated_overlap_fraction(default: float,
                                ledger_: Optional[MeasurementLedger]
                                = None) -> float:
    """The measured overlap fraction for this backend when the ledger
    holds one, else ``default`` (the static table value).  Only
    consulted when calibration is enabled — knob off, the static
    default flows through untouched."""
    if not enabled():
        return float(default)
    led = ledger_ if ledger_ is not None else ledger()
    entry = led.query(OVERLAP_OP_CLASS, "global")
    if entry:
        return float(min(max(entry["mean_s"], 0.0), 1.0))
    return float(default)


# -- bench detail ------------------------------------------------------------

def bench_detail(registry=None) -> dict:
    """Ledger size and residual health for this backend, plus the
    ledger-op counters (the JAX package's bench artifacts carry this as
    ``detail.calibration``; ``chip_smoke.py``'s measured_tier line
    does)."""
    out: dict = {"enabled": enabled()}
    if not enabled():
        return out
    backend = backend_tag()
    ents = ledger().entries(backend=backend)
    residuals: Dict[str, float] = {}
    for key, e in ents.items():
        pred = float(e.get("predicted_s") or 0.0)
        if pred <= 0.0:
            continue
        res = float(e["measured_s"]) / pred
        op = e.get("op_class") or key.split("|", 1)[0]
        # worst (furthest-from-1) residual per op-class
        if op not in residuals or abs(res - 1.0) > \
                abs(residuals[op] - 1.0):
            residuals[op] = round(res, 4)
    n_pred = sum(1 for e in ents.values()
                 if float(e.get("predicted_s") or 0.0) > 0.0)
    coverage = n_pred / len(ents) if ents else 0.0
    set_coverage(coverage, registry)
    try:
        if registry is None:
            from paddle_tpu_torch.observability.metrics import default_registry
            registry = default_registry()
        m = registry.get("paddle_tpu_calibration_ledger_total")
        hits = {"/".join(k) or "all": c.value() for k, c in m.series()} \
            if m is not None else {}
    except Exception:
        hits = {}
    out.update({
        "path": ledger().path,
        "backend": backend,
        "entries": len(ents),
        "with_prediction": n_pred,
        "coverage": round(coverage, 4),
        "residuals": residuals,
        "mean_abs_residual": (round(sum(abs(r - 1.0)
                                        for r in residuals.values())
                                    / len(residuals), 4)
                              if residuals else None),
        "max_residual_factor": (round(max(max(r, 1.0 / r)
                                          for r in residuals.values()), 4)
                                if residuals else None),
        "ledger_ops": hits,
    })
    return out
