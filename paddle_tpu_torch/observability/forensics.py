"""Request forensics: scheduler decision provenance + tail attribution
(a copy of ``paddle_tpu/observability/forensics.py``).

The fleet already answers *that* p99 regressed (metrics federation)
and *where* time went inside one process (spans).  This
module answers the on-call question in between — *why was this
request's TTFT 3s?* — by making every scheduler choice leave a
queryable trace:

* **DecisionEvent** — every scheduling decision in the serving stack
  (router dispatch, admission vs. KV-alloc deferral, auto-park victim
  selection, tier spill/fetch, resume promote-vs-recompute, replica
  death requeue, autoscale) is recorded into the flight-recorder ring
  as a ``decision.<kind>`` event carrying the chosen alternative and
  the rejected alternatives *with their scores* (candidate replica
  loads for routing, deadline headroom for park victims).  Emission is
  observation-only: it writes the in-process ring and nothing else, so
  the knob-off path (``PADDLE_TPU_FORENSICS=0``) has zero new wire
  traffic and token outputs are untouched either way.
* **Federation** — :func:`inject_decisions` / :func:`extract_decisions`
  publish the bounded decision window over the ``obs/`` store channel
  exactly like spans (:func:`~paddle_tpu_torch.observability.tracing
  .inject_spans`); the fleet aggregator joins per-host windows by rid
  and trace id.
* **Attribution** — :func:`attribute` decomposes a retired request's
  ``RequestStatus.timings`` (+ its decision events) into the named
  causes ``queue_wait / route / handoff / cold_resume.promote /
  cold_resume.recompute / requeue / prefill / decode``;
  :func:`explain` renders one request's attributed timeline,
  :func:`tail_report` aggregates a window into per-cause shares, and
  :func:`observe_retirement` feeds the
  ``paddle_tpu_slo_overage_seconds_total{kind,cause}`` counter that the
  watchdog ``tail_regression`` rule (:mod:`.watchdog`) alerts on with
  the dominant cause named.
* **CLI** — ``python -m paddle_tpu_torch.observability.forensics
  --store host:port --explain <rid> | --tail 10`` (or ``--events
  dump.jsonl`` for a flight-recorder dump) renders both views;
  :func:`decisions_to_chrome` exports decisions to the merged Perfetto
  timeline as instant + flow events linking
  router -> prefill -> handoff -> decode per rid.

Dominance ranks *overhead* causes only (queue_wait, route, handoff,
cold_resume.*, requeue): prefill and decode are reported in every
breakdown as productive time, but a request whose latency is all
prefill+decode has dominant cause ``none`` — nothing to fix in the
scheduler.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = [
    "DECISION_KINDS", "CAUSES", "OVERHEAD_CAUSES", "DecisionEvent",
    "forensics_enabled", "emit_decision", "decision_events",
    "attribute", "dominant_cause", "summarize_attributions",
    "Explanation", "explain", "tail_report", "observe_retirement",
    "render_tail_report", "inject_decisions", "extract_decisions",
    "collect_decisions", "decisions_to_chrome", "main",
]

#: Prefix every decision event's recorder kind carries.
DECISION_PREFIX = "decision."

#: The decision kinds the serving stack emits (recorder kind is
#: ``decision.<kind>``).  See observability/README.md for the table.
DECISION_KINDS = ("route", "admit", "park", "resume", "handoff",
                  "requeue", "tier", "autoscale", "retire", "expire")

#: Cause taxonomy for latency attribution, in render order.
CAUSES = ("queue_wait", "route", "handoff", "cold_resume.promote",
          "cold_resume.recompute", "requeue", "prefill", "decode")

#: Causes that count toward dominance: scheduler/transport overhead,
#: not the productive prefill/decode work itself.
OVERHEAD_CAUSES = ("queue_wait", "route", "handoff",
                   "cold_resume.promote", "cold_resume.recompute",
                   "requeue")

#: Bound on rejected alternatives carried per event (ring + wire).
MAX_ALTERNATIVES = 8

_DECISIONS_ENV = "PADDLE_TPU_FLEET_DECISIONS"
_DEFAULT_DECISIONS = 1024
DECISIONS_SCHEMA = 1


def forensics_enabled() -> bool:
    """Decision emission knob (``PADDLE_TPU_FORENSICS``, default on)."""
    return os.environ.get("PADDLE_TPU_FORENSICS", "1").lower() \
        not in ("0", "false", "no", "off")


# ------------------------------------------------------------------ emit
def emit_decision(kind: str, rid=None, chosen=None, alternatives=None,
                  **fields) -> None:
    """Record one scheduler decision into the flight-recorder ring.

    ``alternatives`` is the list of rejected candidates with their
    scores (dicts), bounded to :data:`MAX_ALTERNATIVES`; the overflow
    count is kept so the event stays honest about truncation.  The
    recorder stamps trace/span ids when a sampled span is active on
    the calling thread.  No-op when :func:`forensics_enabled` is off.
    """
    if not forensics_enabled():
        return
    from paddle_tpu_torch.observability.recorder import flight_recorder
    ev: Dict[str, Any] = {}
    if rid is not None:
        ev["rid"] = rid
    if chosen is not None:
        ev["chosen"] = chosen
    if alternatives:
        alts = list(alternatives)
        ev["alternatives"] = alts[:MAX_ALTERNATIVES]
        if len(alts) > MAX_ALTERNATIVES:
            ev["alternatives_dropped"] = len(alts) - MAX_ALTERNATIVES
    ev.update(fields)
    flight_recorder().record(DECISION_PREFIX + kind, **ev)


@dataclass
class DecisionEvent:
    """Structured view over one ``decision.*`` recorder event."""
    kind: str                      # short kind ("route", "admit", ...)
    time: float                    # wall-clock seconds (recorder stamp)
    seq: int
    rid: Any = None
    chosen: Any = None
    alternatives: List[Any] = field(default_factory=list)
    fields: Dict[str, Any] = field(default_factory=dict)
    trace_id: Optional[str] = None
    host: Optional[str] = None

    @classmethod
    def from_record(cls, ev: Dict[str, Any],
                    host: Optional[str] = None) -> Optional["DecisionEvent"]:
        kind = str(ev.get("kind", ""))
        if not kind.startswith(DECISION_PREFIX):
            return None
        extra = {k: v for k, v in ev.items()
                 if k not in ("kind", "time", "seq", "rid", "chosen",
                              "alternatives", "trace_id", "span_id")}
        return cls(kind=kind[len(DECISION_PREFIX):],
                   time=float(ev.get("time", 0.0)),
                   seq=int(ev.get("seq", 0)),
                   rid=ev.get("rid"), chosen=ev.get("chosen"),
                   alternatives=list(ev.get("alternatives") or []),
                   fields=extra, trace_id=ev.get("trace_id"),
                   host=host if host is not None else ev.get("host"))

    def to_record(self) -> Dict[str, Any]:
        out = {"kind": DECISION_PREFIX + self.kind, "time": self.time,
               "seq": self.seq, **self.fields}
        if self.rid is not None:
            out["rid"] = self.rid
        if self.chosen is not None:
            out["chosen"] = self.chosen
        if self.alternatives:
            out["alternatives"] = self.alternatives
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.host is not None:
            out["host"] = self.host
        return out


def decision_events(events: Optional[Iterable[Dict[str, Any]]] = None,
                    rid=None, kind: Optional[str] = None,
                    host: Optional[str] = None) -> List[DecisionEvent]:
    """Filter recorder-event dicts down to :class:`DecisionEvent`\\ s.

    ``events`` defaults to the process flight-recorder ring.  ``rid``
    matches on string equality so fleet rids (ints) and engine rids
    survive JSON round-trips.
    """
    if events is None:
        from paddle_tpu_torch.observability.recorder import flight_recorder
        events = flight_recorder().events()
    out = []
    for ev in events:
        dec = DecisionEvent.from_record(ev, host=host)
        if dec is None:
            continue
        if rid is not None and str(dec.rid) != str(rid):
            continue
        if kind is not None and dec.kind != kind:
            continue
        out.append(dec)
    out.sort(key=lambda d: (d.time, d.seq))
    return out


# ------------------------------------------------------------ attribute
def _resume_path(timings: Dict[str, Any],
                 events: Sequence[DecisionEvent]) -> Optional[str]:
    """Which resume path the request took, if any: the last
    ``decision.resume`` event wins; without events, infer from the
    timings shape (promote imports a handoff payload so ``handoff_s``
    is stamped; recompute replays prefill without one)."""
    path = None
    for ev in events:
        if ev.kind == "resume":
            path = ev.fields.get("path") or ev.chosen
    if path in ("promote", "recompute"):
        return path
    resume_s = float(timings.get("resume_s") or 0.0)
    if resume_s <= 0:
        return None
    return "promote" if float(timings.get("handoff_s") or 0.0) > 0 \
        else "recompute"


def attribute(timings: Dict[str, Any],
              events: Sequence[DecisionEvent] = ()) -> Dict[str, float]:
    """Decompose one request's timings into cause -> seconds.

    Works from timings alone (bench path); decision events sharpen the
    resume path and contribute measured ``wasted_s`` for requeues.
    ``queue_s`` is the engine-local admission wait; ``route_s`` spans
    router dispatch *through* admission, so the router-side share is
    ``route_s - queue_s``.  Parked wall time is intentionally not a
    cause (it is the caller's or the auto-parker's deliberate choice;
    the *resume* cost it induces is).
    """
    t = dict(timings or {})
    causes = {c: 0.0 for c in CAUSES}
    queue_s = max(0.0, float(t.get("queue_s") or 0.0))
    route_s = max(0.0, float(t.get("route_s") or 0.0))
    causes["queue_wait"] = queue_s
    causes["handoff"] = max(0.0, float(t.get("handoff_s") or 0.0))
    resume_s = max(0.0, float(t.get("resume_s") or 0.0))
    path = _resume_path(t, events)
    if path is not None:
        causes[f"cold_resume.{path}"] = resume_s
    causes["prefill"] = max(0.0, float(t.get("prefill_s") or 0.0))
    causes["decode"] = max(0.0, float(t.get("decode_s") or 0.0))
    # router-side overhead: route_s spans router dispatch THROUGH
    # engine admission, so the dispatch share is route_s - queue_s.
    # For a request that was never retried, that whole share is
    # "route".  For a retried request (requeue decision events, or
    # merged attempts > 1) the final-life timings only describe its
    # last attempt: queue_s is the re-admission wait after the retry
    # and the router overhead contains the dead attempt (whose compute
    # waste the router measures as wasted_s on the requeue event) —
    # both exist only because of the requeue, so they fold into the
    # "requeue" cause rather than double-counting as queue/route.
    route_overhead = max(0.0, route_s - queue_s) if route_s else 0.0
    requeues = [ev for ev in events if ev.kind == "requeue"]
    wasted = sum(float(ev.fields.get("wasted_s") or 0.0)
                 for ev in requeues)
    retried = bool(requeues) or float(t.get("attempts") or 0.0) > 1.0
    if retried:
        recovery = queue_s + max(route_overhead, wasted)
        if recovery <= 0:
            # router timing lost entirely: the unattributed TTFT
            # residual is the retry cost
            ttft = float(t.get("ttft_s") or 0.0)
            known = causes["handoff"] + causes["prefill"]
            recovery = max(0.0, ttft - known)
        causes["requeue"] = recovery
        causes["queue_wait"] = 0.0
    else:
        causes["route"] = route_overhead
    return causes


def dominant_cause(causes: Dict[str, float]) -> str:
    """The largest *overhead* cause, or ``"none"`` when every overhead
    cause is ~zero (all the time went to prefill/decode)."""
    best, best_v = "none", 0.0
    for c in OVERHEAD_CAUSES:
        v = float(causes.get(c, 0.0))
        if v > best_v:
            best, best_v = c, v
    return best if best_v > 1e-9 else "none"


def summarize_attributions(
        per_request: Sequence[Dict[str, float]]) -> Dict[str, Any]:
    """Aggregate per-request cause breakdowns into fleet shares.

    Returns ``{"requests", "dominant_cause", "cold_resume_share",
    "causes": {cause: {"seconds", "share"}}}`` — the shape
    ``bench_serve`` publishes as ``detail.tail_attribution`` and
    ``bench.compare_serve_records`` guards.
    """
    totals = {c: 0.0 for c in CAUSES}
    for causes in per_request:
        for c in CAUSES:
            totals[c] += float(causes.get(c, 0.0))
    grand = sum(totals.values())
    shares = {c: {"seconds": round(totals[c], 6),
                  "share": round(totals[c] / grand, 6) if grand > 0
                  else 0.0}
              for c in CAUSES}
    cold = shares["cold_resume.promote"]["share"] + \
        shares["cold_resume.recompute"]["share"]
    return {"requests": len(per_request),
            "dominant_cause": dominant_cause(totals),
            "cold_resume_share": round(cold, 6),
            "causes": shares}


# -------------------------------------------------------------- explain
@dataclass
class Explanation:
    """One request's attributed timeline (see :func:`explain`)."""
    rid: Any
    status: Optional[str]
    trace_id: Optional[str]
    timings: Dict[str, Any]
    causes: Dict[str, float]
    dominant_cause: str
    overage: Dict[str, float]
    events: List[DecisionEvent]

    def table(self) -> str:
        """Human-readable forensic report (what the CLI prints)."""
        lines = [f"request {self.rid}"
                 + (f"  status={self.status}" if self.status else "")
                 + (f"  trace={self.trace_id}" if self.trace_id
                    else "")]
        lines.append(f"  dominant cause: {self.dominant_cause}")
        for k in ("ttft", "tpot"):
            if self.overage.get(k, 0.0) > 0:
                lines.append(f"  {k} overage: "
                             f"{self.overage[k] * 1e3:.1f} ms over "
                             f"target")
        total = sum(self.causes.values()) or 1.0
        lines.append("  cause            seconds    share")
        for c in CAUSES:
            v = self.causes.get(c, 0.0)
            if v <= 0:
                continue
            mark = " *" if c == self.dominant_cause else ""
            lines.append(f"  {c:<16} {v:>8.4f}  {v / total:>6.1%}"
                         f"{mark}")
        if self.events:
            lines.append("  decisions:")
            t0 = self.events[0].time
            for ev in self.events:
                bits = []
                if ev.chosen is not None:
                    bits.append(f"chosen={_brief(ev.chosen)}")
                for k in ("policy", "path", "reason", "replica",
                          "result", "op", "key", "wasted_s"):
                    if k in ev.fields:
                        bits.append(f"{k}={_brief(ev.fields[k])}")
                if ev.alternatives:
                    bits.append(f"rejected={len(ev.alternatives)}")
                if ev.host:
                    bits.append(f"host={ev.host}")
                lines.append(f"    +{ev.time - t0:8.4f}s "
                             f"{ev.kind:<9} " + " ".join(bits))
        return "\n".join(lines)


def _brief(v, limit: int = 48) -> str:
    s = json.dumps(v, default=str) if isinstance(v, (dict, list)) \
        else str(v)
    return s if len(s) <= limit else s[:limit - 3] + "..."


def _retire_event(events: Sequence[DecisionEvent]) -> Optional[DecisionEvent]:
    best = None
    for ev in events:
        if ev.kind != "retire":
            continue
        # a router retirement carries the merged fleet-level timings
        # and is authoritative over the engine-local one
        if best is None or ev.fields.get("source") == "router":
            best = ev
    return best


def explain(rid, events: Optional[Iterable[Dict[str, Any]]] = None,
            status=None, timings: Optional[Dict[str, Any]] = None,
            targets: Optional[Dict[str, float]] = None
            ) -> Optional[Explanation]:
    """Join one request's decision events + timings into an attributed
    timeline.

    ``events`` defaults to the process flight-recorder ring; pass the
    aggregator's merged window for a fleet view.  ``status`` may be a
    ``RequestStatus`` (its ``.timings`` is used when ``timings`` is
    not given); otherwise the timings come from the request's
    ``decision.retire`` event, which is what makes cross-process
    explain work.  Returns ``None`` when the rid is unknown (no
    events, no timings).
    """
    decs = decision_events(events, rid=rid)
    if timings is None and status is not None:
        timings = dict(getattr(status, "timings", None) or {})
    if timings is None:
        ret = _retire_event(decs)
        if ret is not None:
            timings = dict(ret.fields.get("timings") or {})
    if timings is None and not decs:
        return None
    timings = timings or {}
    causes = attribute(timings, decs)
    if targets is None:
        from paddle_tpu_torch.observability.goodput import slo_targets
        targets = slo_targets()
    overage = _overages(timings, targets)
    status_s = str(status) if status is not None else None
    if status_s is None:
        ret = _retire_event(decs)
        if ret is not None:
            status_s = ret.fields.get("status") or \
                (ret.chosen if isinstance(ret.chosen, str) else None)
    trace_id = getattr(status, "trace_id", None) or timings.get(
        "trace_id") or next((d.trace_id for d in decs
                             if d.trace_id), None)
    return Explanation(rid=rid, status=status_s, trace_id=trace_id,
                       timings=timings, causes=causes,
                       dominant_cause=dominant_cause(causes),
                       overage=overage, events=decs)


def _overages(timings: Dict[str, Any],
              targets: Dict[str, float]) -> Dict[str, float]:
    """Seconds of SLO overage per kind (0.0 = within target or
    unjudgeable)."""
    out = {"ttft": 0.0, "tpot": 0.0}
    ttft_target = float(targets.get("ttft", 0.0) or 0.0)
    ttft = float(timings.get("ttft_s") or 0.0)
    if ttft_target > 0 and ttft > 0:
        out["ttft"] = max(0.0, ttft - ttft_target)
    tpot_target = float(targets.get("tpot", 0.0) or 0.0)
    gen = float(timings.get("generated") or 0.0)
    decode_s = float(timings.get("decode_s") or 0.0)
    if tpot_target > 0 and gen > 1 and decode_s > 0:
        out["tpot"] = max(0.0, (decode_s / (gen - 1) - tpot_target)
                          * (gen - 1))
    return out


# ---------------------------------------------------------- tail report
def tail_report(k: int = 100,
                events: Optional[Iterable[Dict[str, Any]]] = None,
                targets: Optional[Dict[str, float]] = None
                ) -> Dict[str, Any]:
    """Aggregate the last ``k`` retirements into per-cause shares.

    Scans ``decision.retire`` events (which carry their request's
    timings), attributes each, and returns the
    :func:`summarize_attributions` shape extended with the window's
    p99 total latency and total SLO overage seconds per kind.
    Router retirements are authoritative; engine-local retirements of
    routed requests (``routed=True``) are skipped so nothing double
    counts.
    """
    if targets is None:
        from paddle_tpu_torch.observability.goodput import slo_targets
        targets = slo_targets()
    decs = decision_events(events, kind="retire")
    retires = [d for d in decs if not d.fields.get("routed")]
    retires = retires[-int(k):]
    per_req, totals_s, over = [], [], {"ttft": 0.0, "tpot": 0.0}
    for ret in retires:
        t = dict(ret.fields.get("timings") or {})
        if not t:
            continue
        rid_events = decision_events(events, rid=ret.rid) \
            if events is not None else []
        per_req.append(attribute(t, rid_events))
        totals_s.append(float(t.get("total_s") or 0.0))
        o = _overages(t, targets)
        over["ttft"] += o["ttft"]
        over["tpot"] += o["tpot"]
    rep = summarize_attributions(per_req)
    totals_s.sort()
    rep["p99_total_s"] = round(
        totals_s[min(len(totals_s) - 1,
                     int(0.99 * len(totals_s)))], 6) \
        if totals_s else 0.0
    rep["overage_s"] = {kk: round(v, 6) for kk, v in over.items()}
    rep["window"] = len(retires)
    return rep


def render_tail_report(rep: Dict[str, Any]) -> str:
    lines = [f"tail report over {rep.get('window', 0)} retirements "
             f"({rep.get('requests', 0)} attributed)"]
    lines.append(f"  dominant cause: {rep.get('dominant_cause')}")
    lines.append(f"  p99 total: {rep.get('p99_total_s', 0.0):.4f}s   "
                 f"overage ttft={rep.get('overage_s', {}).get('ttft', 0.0):.4f}s "
                 f"tpot={rep.get('overage_s', {}).get('tpot', 0.0):.4f}s")
    lines.append("  cause                  seconds    share")
    for c in CAUSES:
        ent = (rep.get("causes") or {}).get(c) or {}
        sec = float(ent.get("seconds", 0.0))
        if sec <= 0:
            continue
        mark = " *" if c == rep.get("dominant_cause") else ""
        lines.append(f"  {c:<22} {sec:>8.4f}  "
                     f"{float(ent.get('share', 0.0)):>6.1%}{mark}")
    return "\n".join(lines)


# ------------------------------------------------- SLO overage counter
def _overage_counter(registry=None):
    if registry is None:
        from paddle_tpu_torch.observability.metrics import default_registry
        registry = default_registry()
    return registry.counter(
        "paddle_tpu_slo_overage_seconds_total",
        "SLO overage seconds attributed to named causes",
        labelnames=("kind", "cause"))


def observe_retirement(timings: Dict[str, Any],
                       events: Sequence[DecisionEvent] = (),
                       targets: Optional[Dict[str, float]] = None,
                       registry=None) -> Dict[str, float]:
    """Attribute one retirement's SLO overage into the
    ``paddle_tpu_slo_overage_seconds_total{kind,cause}`` counter.

    TTFT overage is distributed proportionally across the overhead
    causes (falling back to ``prefill`` when there is no overhead);
    TPOT overage lands on ``decode``.  Called by the serving engine at
    every retirement when targets are set; returns the computed
    overages.  No-op (but still returns) when forensics is off.
    """
    if targets is None:
        from paddle_tpu_torch.observability.goodput import slo_targets
        targets = slo_targets()
    over = _overages(timings, targets)
    if not forensics_enabled() or (over["ttft"] <= 0
                                   and over["tpot"] <= 0):
        return over
    ctr = _overage_counter(registry)
    if over["ttft"] > 0:
        causes = attribute(timings, events)
        weights = {c: causes.get(c, 0.0) for c in OVERHEAD_CAUSES}
        wsum = sum(weights.values())
        if wsum <= 0:
            weights, wsum = {"prefill": 1.0}, 1.0
        for c, w in weights.items():
            if w > 0:
                ctr.labels(kind="ttft", cause=c).inc(
                    over["ttft"] * w / wsum)
    if over["tpot"] > 0:
        ctr.labels(kind="tpot", cause="decode").inc(over["tpot"])
    return over


# ------------------------------------------------------- federation
def decisions_payload(events: Optional[Iterable[Dict[str, Any]]] = None,
                      host: Optional[str] = None,
                      last: Optional[int] = None) -> Dict[str, Any]:
    if events is None:
        from paddle_tpu_torch.observability.recorder import flight_recorder
        events = flight_recorder().events()
    if last is None:
        last = int(os.environ.get(_DECISIONS_ENV,
                                  str(_DEFAULT_DECISIONS)))
    window = [ev for ev in events
              if str(ev.get("kind", "")).startswith(DECISION_PREFIX)]
    window = window[-int(last):]
    return {"schema": DECISIONS_SCHEMA, "host": host,
            "pid": os.getpid(), "events": window}


def inject_decisions(store, key: str, host: Optional[str] = None,
                     events: Optional[Iterable[Dict[str, Any]]] = None,
                     last: Optional[int] = None) -> int:
    """Publish the bounded decision window under ``key`` — the
    decision analogue of :func:`tracing.inject_spans`.  Returns the
    number of events published."""
    payload = decisions_payload(events=events, host=host, last=last)
    store.set(key, json.dumps(payload, default=str).encode("utf-8"))
    return len(payload["events"])


def extract_decisions(store, key: str) -> Optional[Dict[str, Any]]:
    """Tolerant read of a published decision window: ``None`` on
    absent, unparseable, or wrong-schema payloads (a dead or older
    host must never break the aggregator)."""
    try:
        raw = store.get(key, wait=False)
    except Exception:  # noqa: BLE001 — absent key / dead store
        return None
    if not raw:
        return None
    try:
        payload = json.loads(bytes(raw).decode("utf-8"))
    except Exception:  # noqa: BLE001
        return None
    if not isinstance(payload, dict) or \
            payload.get("schema") != DECISIONS_SCHEMA:
        return None
    if not isinstance(payload.get("events"), list):
        return None
    return payload


def collect_decisions(store, hosts: Optional[Sequence[str]] = None,
                      prefix: str = "obs") -> List[Dict[str, Any]]:
    """Merge every host's published decision window into one
    host-tagged, time-ordered event list (the aggregator view)."""
    if hosts is None:
        try:
            raw = store.get(f"{prefix}/hosts", wait=False)
            hosts = [h for h in bytes(raw).decode("utf-8").split(",")
                     if h]
        except Exception:  # noqa: BLE001
            hosts = []
    merged: List[Dict[str, Any]] = []
    for host in hosts:
        payload = extract_decisions(store,
                                    f"{prefix}/forensics/{host}")
        if payload is None:
            continue
        for ev in payload["events"]:
            ev = dict(ev)
            ev.setdefault("host", payload.get("host") or host)
            merged.append(ev)
    merged.sort(key=lambda e: (float(e.get("time", 0.0)),
                               int(e.get("seq", 0))))
    return merged


# ------------------------------------------------------------- perfetto
def decisions_to_chrome(events: Iterable[Dict[str, Any]], pid: int = 0,
                        tid: int = 0) -> List[Dict[str, Any]]:
    """Decision events as Chrome/Perfetto trace events: one instant
    event per decision plus flow arrows (``s``/``t``/``f``) chaining a
    rid's decisions in time order — router -> prefill -> handoff ->
    decode reads as one arrowed path per request in the merged
    timeline."""
    decs = decision_events(events)
    out: List[Dict[str, Any]] = []
    by_rid: Dict[str, List[DecisionEvent]] = {}
    for d in decs:
        ts = d.time * 1e6
        args = {k: v for k, v in d.fields.items() if k != "timings"}
        if d.chosen is not None:
            args["chosen"] = d.chosen
        if d.alternatives:
            args["alternatives"] = d.alternatives
        if d.rid is not None:
            args["rid"] = d.rid
            by_rid.setdefault(str(d.rid), []).append(d)
        if d.trace_id:
            args["trace_id"] = d.trace_id
        out.append({"name": f"decision.{d.kind}", "ph": "i", "s": "p",
                    "ts": ts, "pid": pid, "tid": tid,
                    "cat": "forensics", "args": args})
    for rid, chain in by_rid.items():
        if len(chain) < 2:
            continue
        for i, d in enumerate(chain):
            ph = "s" if i == 0 else ("f" if i == len(chain) - 1
                                     else "t")
            ev = {"name": f"rid {rid}", "ph": ph, "ts": d.time * 1e6,
                  "pid": pid, "tid": tid, "cat": "forensics.flow",
                  "id": f"forensics-{rid}"}
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
    return out


# ------------------------------------------------------------------ CLI
def _load_events_file(path: str) -> List[Dict[str, Any]]:
    """Read a flight-recorder JSONL dump (header lines skipped) or a
    JSON list/payload of events."""
    events: List[Dict[str, Any]] = []
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        whole = json.loads(text)
        if isinstance(whole, list):
            return [e for e in whole if isinstance(e, dict)]
        if isinstance(whole, dict) and \
                isinstance(whole.get("events"), list):
            return [e for e in whole["events"] if isinstance(e, dict)]
    except Exception:  # noqa: BLE001 — JSONL path below
        pass
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except Exception:  # noqa: BLE001
            continue
        if isinstance(ev, dict) and "kind" in ev:
            events.append(ev)
    return events


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.forensics",
        description="Explain request latency from federated scheduler "
                    "decision events.")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--store", help="TCPStore host:port of the fleet "
                                     "obs channel")
    src.add_argument("--events", help="flight-recorder JSONL dump (or "
                                      "JSON event list) to read "
                                      "instead of a store")
    p.add_argument("--prefix", default="obs",
                   help="store key prefix (default: obs)")
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--explain", metavar="RID",
                      help="render one request's attributed timeline")
    what.add_argument("--tail", type=int, metavar="K",
                      help="aggregate the last K retirements into "
                           "per-cause tail shares")
    args = p.parse_args(argv)

    if args.events:
        events = _load_events_file(args.events)
    else:
        from paddle_tpu_torch.observability.fleet import _connect_store
        store = _connect_store(args.store)
        events = collect_decisions(store, prefix=args.prefix)
    if args.explain is not None:
        rid: Any = args.explain
        exp = explain(rid, events=events)
        if exp is None and str(rid).isdigit():
            exp = explain(int(rid), events=events)
        if exp is None:
            print(f"rid {rid}: no decision events or timings found",
                  file=sys.stderr)
            return 2
        print(exp.table())
        return 0
    print(render_tail_report(tail_report(args.tail, events=events)))
    return 0


if __name__ == "__main__":  # pragma: no cover — CLI shim
    raise SystemExit(main())
