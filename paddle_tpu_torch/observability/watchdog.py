"""SLO watchdog — declarative rules over the metrics registry, with
auto-triage on breach (a copy of ``paddle_tpu/observability/
watchdog.py``).

Telemetry alone is passive: counters drift, histograms fill, and a
human must be looking at a dashboard at the right moment.  The watchdog
closes the loop: a daemon thread periodically evaluates a set of
declarative :class:`Rule` objects against the live registry and, on a
breach,

1. increments ``paddle_tpu_slo_breaches_total{rule=...}``,
2. records a structured ``slo_breach`` event into the flight recorder,
3. emits a one-line JSON alert (``{"slo_alert": ...}``) to stderr and to
   ``PADDLE_TPU_SLO_ALERT_PATH`` when set,
4. dumps the flight recorder's recent events (stderr +
   ``PADDLE_TPU_FLIGHT_RECORDER_PATH``) and the N slowest recent traces
   from the tracer — the "what was it doing" bundle, attached to the
   alert instead of hunted down afterwards.

Built-in rule types (see ``default_rules()``):

=================  =======================================================
``step_time_drift``   mean train-step time over the last interval vs. an
                      EMA baseline of earlier intervals (``factor``×)
``recompile_storm``   recompile counter rising faster than ``max_delta``
                      per interval
``queue_saturation``  serving admission queue depth at/above
                      ``threshold`` for ``consecutive`` intervals
``skip_streak``       non-finite step-guard skips rising faster than
                      ``max_delta`` per interval
``heartbeat_gap``     a progress counter (train steps by default) that
                      stopped moving for ``max_gap_s`` seconds
``mfu_drift``         measured MFU gauge (``paddle_tpu_train_mfu``)
                      dropping below ``factor``× its EMA baseline
``compile_storm``     fresh XLA compiles (``paddle_tpu_compile_total``)
                      rising faster than ``max_delta`` per interval
``straggler``         one host's step-time EMA gauge drifting above
                      ``factor``× the fleet median (needs the
                      host-labeled series a fleet aggregator's merged
                      registry carries; silent under ``min_hosts``)
``goodput_floor``     ``paddle_tpu_goodput`` below ``floor`` on any
                      host whose wall clock has run ``min_wall_s``
``restart_storm``     elastic restarts rising faster than ``max_delta``
                      per interval (per host after federation) —
                      generations churning instead of training
``mttr``              mean recovery gap per restart over the last
                      interval (elastic downtime delta / restart
                      delta) above ``target_s`` — recovery slower
                      than the MTTR budget (stale peer snapshots, or
                      fell back to the disk-restore path)
``calibration_drift`` a ``paddle_tpu_calibration_residual{segment}``
                      gauge (measured/predicted, from the measurement
                      ledger) outside ``[1/factor, factor]`` — fresh
                      measurements diverge from the cost model, i.e.
                      the instruments every planner/fusion decision
                      trusts are lying
=================  =======================================================

The fleet-flavored rules are registered in ``RULE_TYPES`` (spec-string
/ env constructible) but NOT in ``default_rules()`` — they only make
sense against a registry carrying fleet gauges (a single process, or
an aggregator's ``merged_registry()`` where gauges are host-labeled).

Rules are also constructible from a spec string (the env-var syntax,
``PADDLE_TPU_SLO_RULES``)::

    step_time_drift:factor=2.0,min_samples=10;queue_saturation:threshold=64

Each ``;``-separated clause is ``<rule_name>[:k=v[,k=v...]]``; values
are coerced to int/float when they parse.  ``Watchdog.from_spec`` /
the ``PADDLE_TPU_SLO_RULES`` env var (checked when the default registry
first starts its exporters) turn that line into a running watchdog.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["Rule", "StepTimeDriftRule", "RecompileStormRule",
           "QueueSaturationRule", "SkipStreakRule", "HeartbeatGapRule",
           "MfuDriftRule", "CompileStormRule", "StragglerRule",
           "GoodputFloorRule", "SloAttainmentRule", "RestartStormRule",
           "MttrRule", "CalibrationDriftRule", "TailRegressionRule",
           "Alert", "Watchdog", "default_rules", "rules_from_spec",
           "RULE_TYPES"]


def _series_total(metric) -> float:
    """Sum of a metric's children — collapses labeled counters (e.g.
    skip reasons) into one progress number."""
    return sum(child.value() for _, child in metric.series())


def _hist_totals(metric):
    count = csum = 0.0
    for _, child in metric.series():
        count += child.count()
        csum += child.sum()
    return count, csum


@dataclass
class Alert:
    rule: str
    detail: str
    time: float


class Rule:
    """One declarative SLO condition.  ``evaluate`` returns a breach
    detail string (truthy → alert) or None; rules keep their own
    interval state so the watchdog can stay stateless about them."""

    name = "rule"

    def evaluate(self, registry, now: float) -> Optional[str]:
        raise NotImplementedError


class StepTimeDriftRule(Rule):
    """Mean step time of the most recent interval vs. a rolling (EMA)
    baseline of earlier intervals.  The first interval with at least
    ``min_samples`` steps seeds the baseline; later intervals breach
    when their mean exceeds ``factor``× the baseline (the baseline is
    NOT polluted by the breaching interval)."""

    def __init__(self, metric: str = "paddle_tpu_train_step_seconds",
                 factor: float = 2.0, min_samples: int = 5,
                 alpha: float = 0.3, name: str = "step_time_drift"):
        self.name = name
        self.metric = metric
        self.factor = float(factor)
        self.min_samples = int(min_samples)
        self.alpha = float(alpha)
        self.baseline: Optional[float] = None
        self._last = (0.0, 0.0)    # (count, sum) at previous evaluation

    def evaluate(self, registry, now):
        h = registry.get(self.metric)
        if h is None or h.kind != "histogram":
            return None
        count, total = _hist_totals(h)
        dn, ds = count - self._last[0], total - self._last[1]
        if dn < self.min_samples:
            return None            # not enough fresh steps to judge
        self._last = (count, total)
        mean = ds / dn
        if self.baseline is None:
            self.baseline = mean
            return None
        if mean > self.factor * self.baseline:
            return (f"mean step time {mean * 1e3:.2f}ms over last "
                    f"{int(dn)} steps > {self.factor:g}x baseline "
                    f"{self.baseline * 1e3:.2f}ms")
        self.baseline = (1 - self.alpha) * self.baseline \
            + self.alpha * mean
        return None


class RecompileStormRule(Rule):
    """More than ``max_delta`` new recompiles in one interval — the
    silent retrace loop (drifting shapes) that eats a TPU alive."""

    def __init__(self, metric: str = "paddle_tpu_train_recompiles_total",
                 max_delta: float = 2, name: str = "recompile_storm"):
        self.name = name
        self.metric = metric
        self.max_delta = float(max_delta)
        self._last: Optional[float] = None

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        value = _series_total(m)
        last, self._last = self._last, value
        if last is None:
            return None
        delta = value - last
        if delta > self.max_delta:
            return (f"{int(delta)} recompiles in one interval "
                    f"(> {self.max_delta:g}) — input signatures are "
                    "churning")
        return None


class QueueSaturationRule(Rule):
    """Serving admission queue at/above ``threshold`` for
    ``consecutive`` intervals: the tier is shedding or about to."""

    def __init__(self, metric: str = "paddle_tpu_serving_queue_depth",
                 threshold: float = 16, consecutive: int = 3,
                 name: str = "queue_saturation"):
        self.name = name
        self.metric = metric
        self.threshold = float(threshold)
        self.consecutive = int(consecutive)
        self._streak = 0

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        depth = _series_total(m)
        if depth >= self.threshold:
            self._streak += 1
        else:
            self._streak = 0
        if self._streak >= self.consecutive:
            return (f"serving queue depth {depth:g} >= "
                    f"{self.threshold:g} for {self._streak} consecutive "
                    "intervals")
        return None


class SkipStreakRule(Rule):
    """Non-finite step-guard skips rising faster than ``max_delta`` per
    interval — the run is skating on divergence even before the guard's
    own K-consecutive-skips escape hatch fires."""

    def __init__(self,
                 metric: str = "paddle_tpu_train_step_skipped_total",
                 max_delta: float = 3, name: str = "skip_streak"):
        self.name = name
        self.metric = metric
        self.max_delta = float(max_delta)
        self._last: Optional[float] = None

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        value = _series_total(m)
        last, self._last = self._last, value
        if last is None:
            return None
        delta = value - last
        if delta > self.max_delta:
            return (f"{int(delta)} optimizer updates skipped "
                    f"(non-finite) in one interval (> "
                    f"{self.max_delta:g})")
        return None


class HeartbeatGapRule(Rule):
    """A progress counter that stopped moving: armed once the counter
    first advances, breaches after ``max_gap_s`` seconds without any
    further increase (a hung device dispatch or a deadlocked loop
    produces exactly this signature — alive process, frozen counter)."""

    def __init__(self, metric: str = "paddle_tpu_train_steps_total",
                 max_gap_s: float = 120.0, name: str = "heartbeat_gap"):
        self.name = name
        self.metric = metric
        self.max_gap_s = float(max_gap_s)
        self._last_value: Optional[float] = None
        self._last_change: Optional[float] = None

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        value = _series_total(m)
        if value != self._last_value:
            self._last_value = value
            self._last_change = now
            return None
        if not value or self._last_change is None:
            return None            # never progressed: not armed yet
        gap = now - self._last_change
        if gap > self.max_gap_s:
            return (f"{self.metric} frozen at {value:g} for "
                    f"{gap:.1f}s (> {self.max_gap_s:g}s)")
        return None


class MfuDriftRule(Rule):
    """Measured MFU (the ``paddle_tpu_train_mfu`` gauge an AOT-compiled
    TrainStep sets from XLA-counted executable FLOPs / step time /
    device peak) dropping below ``factor``× an EMA baseline.  Catches
    the step getting slower *relative to the work it does* — a
    regression step_time_drift misses when batch shape changed too, and
    the direct watch on the number the benchmark trajectory tracks."""

    def __init__(self, metric: str = "paddle_tpu_train_mfu",
                 factor: float = 0.8, alpha: float = 0.3,
                 name: str = "mfu_drift"):
        self.name = name
        self.metric = metric
        self.factor = float(factor)
        self.alpha = float(alpha)
        self.baseline: Optional[float] = None

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        value = _series_total(m)
        if value != value or value <= 0:
            return None            # gauge not armed yet (no AOT compile)
        if self.baseline is None:
            self.baseline = value
            return None
        if value < self.factor * self.baseline:
            return (f"measured MFU {value:.4f} < {self.factor:g}x "
                    f"baseline {self.baseline:.4f} — the step got "
                    "slower relative to its executable FLOPs")
        self.baseline = (1 - self.alpha) * self.baseline \
            + self.alpha * value
        return None


class CompileStormRule(Rule):
    """More than ``max_delta`` fresh XLA compiles per interval
    (``paddle_tpu_compile_total`` across all targets) — executables are
    churning: shape drift is defeating the AOT path, or serving bucket
    config makes every prompt a novel prefill."""

    def __init__(self, metric: str = "paddle_tpu_compile_total",
                 max_delta: float = 3, name: str = "compile_storm"):
        self.name = name
        self.metric = metric
        self.max_delta = float(max_delta)
        self._last: Optional[float] = None

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        value = _series_total(m)
        last, self._last = self._last, value
        if last is None:
            return None
        delta = value - last
        if delta > self.max_delta:
            return (f"{int(delta)} fresh XLA compiles in one interval "
                    f"(> {self.max_delta:g}) — executables are churning")
        return None


def _values_by_host(metric) -> Dict[str, float]:
    """Finite series values keyed by their ``host`` label — the shape a
    fleet aggregator's merged gauges have.  A metric without a ``host``
    label yields one entry keyed ``""`` (single-process)."""
    out: Dict[str, float] = {}
    names = metric.labelnames
    for values, child in metric.series():
        labels = dict(zip(names, values))
        v = child.value()
        if v != v:
            continue
        out[labels.get("host", "")] = v
    return out


class StragglerRule(Rule):
    """One host's step-time EMA
    (``paddle_tpu_train_step_ema_seconds``, host-labeled on a fleet
    aggregator's merged registry) sitting above ``factor``× the fleet
    median — the multi-controller SPMD failure mode a per-process view
    cannot see: every host runs the same program, so one slow host
    drags every collective.  Needs ``min_hosts`` live hosts to judge;
    a single process never breaches."""

    def __init__(self, metric: str = "paddle_tpu_train_step_ema_seconds",
                 factor: float = 1.75, min_hosts: int = 2,
                 name: str = "straggler"):
        self.name = name
        self.metric = metric
        self.factor = float(factor)
        self.min_hosts = int(min_hosts)

    def evaluate(self, registry, now):
        import statistics
        m = registry.get(self.metric)
        if m is None or "host" not in m.labelnames:
            return None
        per_host = {h: v for h, v in _values_by_host(m).items()
                    if h and v > 0}
        if len(per_host) < self.min_hosts:
            return None
        med = statistics.median(per_host.values())
        if med <= 0:
            return None
        worst_host, worst = max(per_host.items(), key=lambda kv: kv[1])
        if worst > self.factor * med:
            return (f"host {worst_host} step-time EMA "
                    f"{worst * 1e3:.2f}ms > {self.factor:g}x fleet "
                    f"median {med * 1e3:.2f}ms "
                    f"({len(per_host)} hosts)")
        return None


class GoodputFloorRule(Rule):
    """``paddle_tpu_goodput`` below ``floor`` on any host whose
    denominator (``paddle_tpu_goodput_wall_seconds``) has accumulated
    at least ``min_wall_s`` — young processes are still paying their
    compile tax and get grace; a mature host spending most of its wall
    clock unproductively is the page."""

    def __init__(self, metric: str = "paddle_tpu_goodput",
                 wall_metric: str = "paddle_tpu_goodput_wall_seconds",
                 floor: float = 0.5, min_wall_s: float = 60.0,
                 name: str = "goodput_floor"):
        self.name = name
        self.metric = metric
        self.wall_metric = wall_metric
        self.floor = float(floor)
        self.min_wall_s = float(min_wall_s)

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        goodput = _values_by_host(m)
        wall_m = registry.get(self.wall_metric)
        walls = _values_by_host(wall_m) if wall_m is not None else {}
        breaching = []
        for host, g in goodput.items():
            if walls.get(host, 0.0) < self.min_wall_s:
                continue
            if g < self.floor:
                breaching.append((host, g))
        if not breaching:
            return None
        host, g = min(breaching, key=lambda kv: kv[1])
        who = f"host {host}" if host else "this process"
        return (f"goodput {g:.3f} on {who} < floor {self.floor:g} "
                f"after {walls.get(host, 0.0):.0f}s of wall clock"
                + (f" ({len(breaching)} hosts below floor)"
                   if len(breaching) > 1 else ""))


class SloAttainmentRule(Rule):
    """Serving SLO attainment (the ``paddle_tpu_slo_attainment{kind}``
    gauge the goodput monitor publishes, host-labeled on a fleet
    aggregator's merged registry) below ``floor`` on any host — the
    fleet-level "users are feeling it" signal that should add serving
    capacity, not just page someone.  ``kind`` selects ttft or tpot;
    the serving-fleet router's ``SloAutoscaleRule`` subclasses this to
    spawn a replica on breach."""

    def __init__(self, metric: str = "paddle_tpu_slo_attainment",
                 kind: str = "ttft", floor: float = 0.9,
                 name: str = "slo_attainment"):
        self.name = name
        self.metric = metric
        self.kind = str(kind)
        self.floor = float(floor)

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None or "kind" not in m.labelnames:
            return None
        names = m.labelnames
        breaching: List[tuple] = []
        for values, child in m.series():
            labels = dict(zip(names, values))
            if labels.get("kind") != self.kind:
                continue
            v = child.value()
            if v != v:
                continue           # NaN: no verdicts yet
            if v < self.floor:
                breaching.append((labels.get("host", ""), v))
        if not breaching:
            return None
        host, worst = min(breaching, key=lambda kv: kv[1])
        who = f"host {host}" if host else "this process"
        return (f"{self.kind} SLO attainment {worst:.3f} on {who} < "
                f"floor {self.floor:g}"
                + (f" ({len(breaching)} hosts below floor)"
                   if len(breaching) > 1 else ""))


def _sums_by_host(metric) -> Dict[str, float]:
    """Per-host SUM over a metric's series (a counter with extra labels
    — reason, cause — collapses to one progress number per host; no
    ``host`` label yields one entry keyed ``""``)."""
    out: Dict[str, float] = {}
    names = metric.labelnames
    for values, child in metric.series():
        labels = dict(zip(names, values))
        v = child.value()
        if v != v:
            continue
        h = labels.get("host", "")
        out[h] = out.get(h, 0.0) + v
    return out


class RestartStormRule(Rule):
    """Elastic restarts (``paddle_tpu_elastic_restarts_total``, summed
    over reasons) rising faster than ``max_delta`` per interval on any
    host — the job is churning generations instead of training.  Works
    on a single process and, host-labeled on a fleet aggregator's
    merged registry, names the flapping host."""

    def __init__(self, metric: str = "paddle_tpu_elastic_restarts_total",
                 max_delta: float = 3, name: str = "restart_storm"):
        self.name = name
        self.metric = metric
        self.max_delta = float(max_delta)
        self._last: Dict[str, float] = {}

    def evaluate(self, registry, now):
        m = registry.get(self.metric)
        if m is None:
            return None
        per_host = _sums_by_host(m)
        worst: Optional[tuple] = None
        for host, value in per_host.items():
            last = self._last.get(host)
            self._last[host] = value
            if last is None:
                continue
            delta = value - last
            if delta > self.max_delta and \
                    (worst is None or delta > worst[1]):
                worst = (host, delta)
        if worst is None:
            return None
        host, delta = worst
        who = f"host {host}" if host else "this job"
        return (f"{int(delta)} elastic restarts in one interval on "
                f"{who} (> {self.max_delta:g}) — generations are "
                "churning, not training")


class MttrRule(Rule):
    """Mean recovery gap per restart over the last interval —
    ``paddle_tpu_elastic_downtime_seconds_total`` delta divided by the
    restart-count delta — above ``target_s`` on any host: recovery is
    slower than the MTTR budget (peer snapshots stale/missing, or the
    job fell back to the disk-restore path).  Silent in intervals with
    no fresh restarts; host-aware like :class:`StragglerRule`."""

    def __init__(self,
                 gap_metric: str =
                 "paddle_tpu_elastic_downtime_seconds_total",
                 restarts_metric: str =
                 "paddle_tpu_elastic_restarts_total",
                 target_s: float = 30.0, name: str = "mttr"):
        self.name = name
        self.gap_metric = gap_metric
        self.restarts_metric = restarts_metric
        self.target_s = float(target_s)
        self._last_gap: Dict[str, float] = {}
        self._last_restarts: Dict[str, float] = {}

    def evaluate(self, registry, now):
        gm = registry.get(self.gap_metric)
        rm = registry.get(self.restarts_metric)
        if gm is None or rm is None:
            return None
        gaps, restarts = _sums_by_host(gm), _sums_by_host(rm)
        worst: Optional[tuple] = None
        for host in set(gaps) | set(restarts):
            g, r = gaps.get(host, 0.0), restarts.get(host, 0.0)
            lg = self._last_gap.get(host)
            lr = self._last_restarts.get(host)
            self._last_gap[host], self._last_restarts[host] = g, r
            if lg is None or lr is None:
                continue           # first sight of this host: seed only
            dr = r - lr
            if dr <= 0:
                continue           # no fresh restarts to judge
            mttr = (g - lg) / dr
            if mttr > self.target_s and \
                    (worst is None or mttr > worst[1]):
                worst = (host, mttr, dr)
        if worst is None:
            return None
        host, mttr, dr = worst
        who = f"host {host}" if host else "this job"
        return (f"mean recovery gap {mttr:.1f}s over {int(dr)} "
                f"restart(s) on {who} > MTTR target {self.target_s:g}s")


class CalibrationDriftRule(Rule):
    """The predicted-vs-measured loop's alarm: any
    ``paddle_tpu_calibration_residual{segment}`` gauge (written by the
    calibrated cost model whenever the measurement ledger serves a
    query) outside ``[1/factor, factor]`` means fresh measurements
    diverge from the roofline model beyond the tolerated band — the
    numbers the planner ranks by and the fusion router compares are no
    longer describing the hardware (wrong roofline constants, an
    interfering co-tenant, or a kernel regression since the ledger was
    refreshed).  Silent when the gauge doesn't exist (calibration off)
    — safe in ``default_rules()``."""

    def __init__(self, metric: str = "paddle_tpu_calibration_residual",
                 factor: float = 4.0, name: str = "calibration_drift"):
        self.name = name
        self.metric = metric
        self.factor = float(factor)

    def evaluate(self, registry, now: float) -> Optional[str]:
        m = registry.get(self.metric)
        if m is None:
            return None
        worst = None
        for labels, child in m.series():
            v = child.value()
            if not (v > 0.0):        # absent/zero/NaN: no measurement
                continue
            drift = max(v, 1.0 / v)
            if drift > self.factor and \
                    (worst is None or drift > worst[1]):
                worst = ("/".join(labels) or "?", drift, v)
        if worst is None:
            return None
        seg, _, v = worst
        return (f"calibration residual {v:.2f}x on {seg} outside "
                f"[1/{self.factor:g}, {self.factor:g}] — measured time "
                f"diverges from the cost model; refresh the ledger "
                f"(sweep day) or fix the roofline constants")


class TailRegressionRule(Rule):
    """Tail-latency regression with the dominant cause NAMED in the
    alert.  Watches the per-cause SLO overage counter the forensics
    layer feeds at every retirement
    (``paddle_tpu_slo_overage_seconds_total{kind,cause}`` — see
    :func:`~paddle_tpu_torch.observability.forensics.observe_retirement`)
    and fires when one interval accrues at least ``min_overage_s`` of
    fresh overage AND that is more than ``growth`` times the baseline
    (EMA of healthy intervals) — p99 regressed, and the breach detail
    says WHY: the cause with the largest share of the window's
    overage, plus a note when the dominant cause flipped since the
    last window.  Fleet-flavored (needs the serving overage counter),
    so registered in ``RULE_TYPES`` but not ``default_rules()``."""

    def __init__(self,
                 metric: str = "paddle_tpu_slo_overage_seconds_total",
                 min_overage_s: float = 0.5, growth: float = 3.0,
                 name: str = "tail_regression"):
        self.name = name
        self.metric = metric
        self.min_overage_s = float(min_overage_s)
        self.growth = float(growth)
        self._last: Optional[Dict[tuple, float]] = None
        self._baseline: Optional[float] = None
        self._last_dominant: Optional[str] = None

    def evaluate(self, registry, now: float) -> Optional[str]:
        m = registry.get(self.metric)
        if m is None:
            return None
        cur = {labels: child.value() for labels, child in m.series()}
        last, self._last = self._last, cur
        if last is None:
            return None
        by_cause: Dict[str, float] = {}
        total = 0.0
        for labels, v in cur.items():
            d = v - last.get(labels, 0.0)
            if d <= 0:
                continue
            # labelnames=("kind", "cause") -> values in that order
            cause = labels[1] if len(labels) > 1 else (
                labels[0] if labels else "?")
            by_cause[cause] = by_cause.get(cause, 0.0) + d
            total += d
        if total <= 0:
            return None
        dominant = max(by_cause, key=by_cause.get)
        share = by_cause[dominant] / total
        baseline, prev_dom = self._baseline, self._last_dominant
        self._last_dominant = dominant
        if baseline is None:
            self._baseline = total
            return None
        breach = total >= self.min_overage_s and \
            total > self.growth * baseline
        if not breach:
            # healthy interval: fold into the baseline EMA (a breach
            # is deliberately NOT folded in — a sustained regression
            # must keep firing, not normalize itself away)
            self._baseline = 0.7 * baseline + 0.3 * total
            return None
        detail = (f"{total:.2f}s fresh SLO overage this interval "
                  f"(> {self.growth:g}x baseline {baseline:.2f}s); "
                  f"dominant cause: {dominant} ({share:.0%} of "
                  f"overage)")
        if prev_dom is not None and prev_dom != dominant:
            detail += f" — flipped from {prev_dom}"
        return detail


RULE_TYPES = {
    "step_time_drift": StepTimeDriftRule,
    "recompile_storm": RecompileStormRule,
    "queue_saturation": QueueSaturationRule,
    "skip_streak": SkipStreakRule,
    "heartbeat_gap": HeartbeatGapRule,
    "mfu_drift": MfuDriftRule,
    "compile_storm": CompileStormRule,
    "straggler": StragglerRule,
    "goodput_floor": GoodputFloorRule,
    "slo_attainment": SloAttainmentRule,
    "restart_storm": RestartStormRule,
    "mttr": MttrRule,
    "calibration_drift": CalibrationDriftRule,
    "tail_regression": TailRegressionRule,
}


def default_rules() -> List[Rule]:
    return [StepTimeDriftRule(), RecompileStormRule(),
            QueueSaturationRule(), SkipStreakRule(), HeartbeatGapRule(),
            MfuDriftRule(), CompileStormRule(), CalibrationDriftRule()]


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def rules_from_spec(spec: str) -> List[Rule]:
    """Parse the declarative rule syntax (module docstring) into rule
    instances.  Unknown rule names raise — a typo'd SLO that silently
    never fires is worse than a crash at startup."""
    rules: List[Rule] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        rname, _, argstr = clause.partition(":")
        rname = rname.strip()
        if rname not in RULE_TYPES:
            raise ValueError(
                f"unknown SLO rule {rname!r}; choose from "
                f"{sorted(RULE_TYPES)}")
        kwargs = {}
        for pair in filter(None, (p.strip()
                                  for p in argstr.split(","))):
            k, _, v = pair.partition("=")
            if not _ or not k:
                raise ValueError(f"bad rule arg {pair!r} in {clause!r}")
            kwargs[k.strip()] = _coerce(v.strip())
        rules.append(RULE_TYPES[rname](**kwargs))
    return rules


class Watchdog:
    """Evaluate rules on an interval; auto-triage on breach.

    ``evaluate_once(now)`` is the synchronous core (tests drive it with
    synthetic clocks/metric streams); ``start(interval)`` runs it on a
    daemon thread.  A per-rule ``cooldown`` keeps a persistently-bad
    condition from re-alerting every interval."""

    def __init__(self, rules: Optional[List[Rule]] = None, registry=None,
                 recorder=None, trace_source=None,
                 cooldown: float = 60.0, slow_traces: int = 3,
                 dump_events: int = 100, alert_file=None):
        if registry is None:
            from paddle_tpu_torch.observability.metrics import default_registry
            registry = default_registry()
        if recorder is None:
            from paddle_tpu_torch.observability.recorder import flight_recorder
            recorder = flight_recorder()
        self.registry = registry
        self.recorder = recorder
        self._trace_source = trace_source
        self.rules = list(rules) if rules is not None else default_rules()
        self.cooldown = cooldown
        self.slow_traces = slow_traces
        self.dump_events = dump_events
        self.alert_file = alert_file
        self.alerts: List[Alert] = []
        self._last_fire: Dict[str, float] = {}
        self._breaches = registry.counter(
            "paddle_tpu_slo_breaches_total",
            "SLO rule breaches detected by the watchdog",
            labelnames=("rule",))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_spec(cls, spec: str, **kwargs) -> "Watchdog":
        return cls(rules=rules_from_spec(spec), **kwargs)

    def _tracer(self):
        if self._trace_source is not None:
            return self._trace_source
        from paddle_tpu_torch.observability.tracing import tracer
        return tracer()

    # -- evaluation ---------------------------------------------------------
    def evaluate_once(self, now: Optional[float] = None) -> List[Alert]:
        """One pass over every rule; returns the alerts fired.  ``now``
        is injectable (monotonic seconds) so heartbeat/cooldown logic is
        testable with a synthetic clock."""
        if now is None:
            now = time.monotonic()
        fired: List[Alert] = []
        for rule in self.rules:
            try:
                detail = rule.evaluate(self.registry, now)
            except Exception:
                continue           # a broken rule must not kill the dog
            if not detail:
                continue
            last = self._last_fire.get(rule.name)
            if last is not None and now - last < self.cooldown:
                continue
            self._last_fire[rule.name] = now
            fired.append(self._fire(rule.name, detail))
        return fired

    def _fire(self, rule_name: str, detail: str) -> Alert:
        alert = Alert(rule=rule_name, detail=detail, time=time.time())
        self.alerts.append(alert)
        self._breaches.labels(rule=rule_name).inc()
        # the breach event goes into the ring FIRST so the dump below —
        # and any later crash dump — contains it
        self.recorder.record("slo_breach", rule=rule_name, detail=detail)
        line = json.dumps({"slo_alert": {
            "rule": rule_name, "detail": detail, "time": alert.time}})
        print(line, file=sys.stderr)
        sink = self.alert_file or os.environ.get(
            "PADDLE_TPU_SLO_ALERT_PATH")
        if sink:
            try:
                with open(sink, "a") as f:
                    f.write(line + "\n")
            except Exception:
                pass
        # auto-triage bundle: recent flight-recorder events + the
        # slowest recent traces, attached to the alert
        try:
            self.recorder.dump(last=self.dump_events,
                               reason=f"slo breach: {rule_name}")
            path = os.environ.get("PADDLE_TPU_FLIGHT_RECORDER_PATH")
            if path:
                self.recorder.dump(file=path, last=self.dump_events,
                                   reason=f"slo breach: {rule_name}")
        except Exception:
            pass
        try:
            traces = self._tracer().slowest_traces(self.slow_traces)
            if traces:
                print(json.dumps({"slow_traces": traces},
                                 default=str), file=sys.stderr)
        except Exception:
            pass
        return alert

    # -- lifecycle ----------------------------------------------------------
    def start(self, interval: float = 15.0) -> "Watchdog":
        def loop():
            while not self._stop.wait(interval):
                try:
                    self.evaluate_once()
                except Exception:
                    pass           # the watchdog must outlive bad scrapes
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle-tpu-slo-watchdog")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
