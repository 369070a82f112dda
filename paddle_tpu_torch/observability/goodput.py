"""Goodput + SLO-attainment accounting (a copy of
``paddle_tpu/observability/goodput.py``).

*Goodput* is the fraction of wall-clock time a training process spent
doing work that moved the model forward: productive step seconds over
elapsed seconds.  Everything else is **lost time**, and this module
attributes it to the causes the rest of the framework already meters:

=================  =========================================================
``compile``        XLA compile wall time (``paddle_tpu_compile_seconds``)
``checkpoint``     synchronous save/restore stalls
                   (``paddle_tpu_checkpoint_save_seconds`` + ``_restore_``)
``elastic_gap``    dead time between elastic generations
                   (``paddle_tpu_elastic_downtime_seconds_total``, debited
                   by the manager when it respawns after a failure)
``skipped_steps``  step time spent on updates the non-finite step-guard
                   discarded (``paddle_tpu_train_skipped_seconds_total``)
``other``          the remainder (data stalls, host python, eval, ...)
=================  =========================================================

The productive numerator is ``paddle_tpu_train_productive_seconds_total``
— a counter TrainStep advances by the step's wall time only when the
update was actually *applied* (a guard-skipped step is lost, not
productive).

Serving gets the analogous number: **SLO attainment**, the fraction of
retired requests that met their TTFT / TPOT targets
(``PADDLE_TPU_SLO_TTFT_TARGET`` / ``PADDLE_TPU_SLO_TPOT_TARGET``
seconds; defaults 1.0 / 0.25).  The engine counts hits and misses per
retirement into ``paddle_tpu_serving_slo_total{kind,result}``; this
module folds them into the ``paddle_tpu_slo_attainment{kind}`` gauge.

:class:`GoodputMonitor` publishes both as first-class gauges
(``paddle_tpu_goodput``, ``paddle_tpu_goodput_wall_seconds``,
``paddle_tpu_goodput_lost_seconds{cause}``,
``paddle_tpu_slo_attainment{kind}``) so they federate across hosts like
every other metric (:mod:`paddle_tpu_torch.observability.fleet`) and the
``goodput_floor`` / ``straggler`` watchdog rules can fire on them.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = ["compute_goodput", "slo_attainment", "slo_targets",
           "GoodputMonitor", "goodput_monitor"]

DEFAULT_TTFT_TARGET_S = 1.0
DEFAULT_TPOT_TARGET_S = 0.25

# wall-clock anchor for the default monitor: stamped when this module
# first loads — the observability package imports it, so any process
# that runs an instrumented TrainStep has the anchor set BEFORE its
# first step (a monitor created lazily mid-job must not report
# productive seconds against a seconds-old denominator)
_PROCESS_T0 = time.monotonic()


def slo_targets() -> Dict[str, float]:
    """Serving latency targets in seconds (<= 0 disables a kind).

    ``PADDLE_TPU_SLO_TTFT_TARGET`` — time to first token;
    ``PADDLE_TPU_SLO_TPOT_TARGET`` — mean per-output-token decode time.
    """
    return {
        "ttft": float(os.environ.get("PADDLE_TPU_SLO_TTFT_TARGET",
                                     str(DEFAULT_TTFT_TARGET_S))),
        "tpot": float(os.environ.get("PADDLE_TPU_SLO_TPOT_TARGET",
                                     str(DEFAULT_TPOT_TARGET_S))),
    }


def _registry(registry):
    if registry is not None:
        return registry
    from paddle_tpu_torch.observability.metrics import default_registry
    return default_registry()


def _counter_total(reg, name: str) -> float:
    m = reg.get(name)
    if m is None:
        return 0.0
    return sum(child.value() for _, child in m.series())


def _hist_sum(reg, name: str) -> float:
    m = reg.get(name)
    if m is None or m.kind != "histogram":
        return 0.0
    return sum(child.sum() for _, child in m.series())


def compute_goodput(registry=None, wall_s: Optional[float] = None,
                    t0: Optional[float] = None) -> Dict[str, object]:
    """One goodput ledger from the live registry.

    ``wall_s`` is the denominator; pass it explicitly (tests, bench) or
    give ``t0`` (a ``time.monotonic()`` stamp) to measure since then.
    Returns ``{"goodput", "productive_s", "wall_s", "lost": {cause: s}}``
    — ``goodput`` is NaN when no wall clock was provided."""
    reg = _registry(registry)
    if wall_s is None and t0 is not None:
        wall_s = time.monotonic() - t0
    productive = _counter_total(
        reg, "paddle_tpu_train_productive_seconds_total")
    if productive == 0.0 and reg.get(
            "paddle_tpu_train_productive_seconds_total") is None:
        # pre-fleet processes: fall back to the step-latency histogram
        # (over-counts guard-skipped steps, but degrades instead of
        # reading zero)
        productive = _hist_sum(reg, "paddle_tpu_train_step_seconds")
    lost = {
        "compile": _hist_sum(reg, "paddle_tpu_compile_seconds"),
        "checkpoint": _hist_sum(reg, "paddle_tpu_checkpoint_save_seconds")
        + _hist_sum(reg, "paddle_tpu_checkpoint_restore_seconds"),
        "elastic_gap": _counter_total(
            reg, "paddle_tpu_elastic_downtime_seconds_total"),
        "skipped_steps": _counter_total(
            reg, "paddle_tpu_train_skipped_seconds_total"),
    }
    out = {"productive_s": productive, "lost": lost}
    if wall_s is not None and wall_s > 0:
        out["wall_s"] = float(wall_s)
        out["goodput"] = productive / wall_s
        accounted = productive + sum(lost.values())
        lost["other"] = max(0.0, wall_s - accounted)
    else:
        out["wall_s"] = 0.0
        out["goodput"] = float("nan")
        lost["other"] = 0.0
    return out


def slo_attainment(registry=None) -> Dict[str, Optional[float]]:
    """Fraction of retired requests that met each latency target, from
    the engine's ``paddle_tpu_serving_slo_total{kind,result}`` counters.
    None for a kind with no samples yet."""
    reg = _registry(registry)
    m = reg.get("paddle_tpu_serving_slo_total")
    out: Dict[str, Optional[float]] = {"ttft": None, "tpot": None}
    if m is None:
        return out
    tallies: Dict[str, Dict[str, float]] = {}
    for values, child in m.series():
        labels = dict(zip(m.labelnames, values))
        kind, result = labels.get("kind"), labels.get("result")
        if kind is None or result is None:
            continue
        tallies.setdefault(kind, {})[result] = \
            tallies.get(kind, {}).get(result, 0.0) + child.value()
    for kind, t in tallies.items():
        total = t.get("hit", 0.0) + t.get("miss", 0.0)
        if total > 0:
            out[kind] = t.get("hit", 0.0) / total
    return out


class GoodputMonitor:
    """Computes the goodput ledger + SLO attainment and publishes them
    as gauges.  ``publish()`` is the synchronous core (the fleet
    publisher and the demo drive it directly); ``start(interval)`` runs
    it on a daemon thread.  The wall clock anchors at this module's
    import (``t0=`` overrides it — tests and scoped windows).
    """

    def __init__(self, registry=None, t0: Optional[float] = None):
        self.registry = _registry(registry)
        self._t0 = _PROCESS_T0 if t0 is None else t0
        reg = self.registry
        self._g_goodput = reg.gauge(
            "paddle_tpu_goodput",
            "productive train-step seconds / wall-clock seconds since "
            "the monitor started (compile, checkpoint stalls, elastic "
            "gaps and guard-skipped steps all debit it)")
        self._g_wall = reg.gauge(
            "paddle_tpu_goodput_wall_seconds",
            "wall-clock denominator behind paddle_tpu_goodput")
        self._g_lost = reg.gauge(
            "paddle_tpu_goodput_lost_seconds",
            "non-productive wall time attributed by cause",
            labelnames=("cause",))
        self._g_slo = reg.gauge(
            "paddle_tpu_slo_attainment",
            "fraction of retired serving requests meeting the latency "
            "target", labelnames=("kind",))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def publish(self) -> Dict[str, object]:
        ledger = compute_goodput(self.registry, t0=self._t0)
        g = ledger["goodput"]
        if g == g:                      # NaN-safe: wall clock armed
            self._g_goodput.set(g)
            self._g_wall.set(ledger["wall_s"])
        for cause, seconds in ledger["lost"].items():
            self._g_lost.labels(cause=cause).set(seconds)
        att = slo_attainment(self.registry)
        ledger["slo_attainment"] = att
        for kind, frac in att.items():
            if frac is not None:
                self._g_slo.labels(kind=kind).set(frac)
        return ledger

    # -- lifecycle ----------------------------------------------------------
    def start(self, interval: float = 10.0) -> "GoodputMonitor":
        def loop():
            while not self._stop.wait(interval):
                try:
                    self.publish()
                except Exception:
                    pass       # accounting must never hurt the job
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle-tpu-goodput")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_MONITOR: Optional[GoodputMonitor] = None
_MONITOR_LOCK = threading.Lock()


def goodput_monitor() -> GoodputMonitor:
    """The process-wide monitor (clock starts on first use; the fleet
    publisher ticks it before every snapshot so federated goodput is
    always fresh)."""
    global _MONITOR
    if _MONITOR is None:
        with _MONITOR_LOCK:
            if _MONITOR is None:
                _MONITOR = GoodputMonitor()
    return _MONITOR
