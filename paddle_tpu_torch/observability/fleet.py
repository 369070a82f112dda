"""Fleet observability plane — cross-process metric federation, stitched
multi-host traces, and the fleet table (a copy of
``paddle_tpu/observability/fleet.py``).  The TCPStore behind
:func:`_connect_store` and the CLI is not ported yet (ROADMAP.md, queue
1, item 8): both raise; :class:`LocalStore` and any store object with
the same contract work.

Everything built in the observability package so far is per-process: N
replicas means N ``/metrics`` ports, N span rings, and no single answer
to "what is the fleet's goodput right now?".  This module adds the
aggregation tier on top of the plumbing that already exists:

* **publish** — each process periodically ships a versioned snapshot of
  its :class:`~paddle_tpu_torch.observability.metrics.MetricsRegistry`
  (``registry.collect()`` — counters, gauges, histogram buckets) through
  the TCPStore under ``obs/metrics/<host>``, plus its bounded span ring
  under ``obs/trace/<host>`` (:func:`~.tracing.inject_spans`).  The
  publisher is a daemon thread (:class:`MetricsPublisher`); env
  enablement is ``PADDLE_TPU_FLEET_METRICS=<host:port>`` (+
  ``PADDLE_TPU_FLEET_INTERVAL``, default 5 s), checked when the default
  registry first starts its exporters.
* **aggregate** — :class:`FleetAggregator` polls the store and merges
  snapshots **type-correctly**: counters sum across hosts (per
  label-set), histogram buckets sum bound-for-bound (so PromQL
  ``histogram_quantile`` over the federated exposition equals the same
  math over the pooled raw observations), and gauges — which cannot be
  meaningfully summed — keep one series per host under a ``host`` label
  plus a ``<name>_fleet{stat="min"|"mean"|"max"}`` roll-up family.  All
  merged series live under the same 64-series cardinality cap as the
  source registry.  The aggregator duck-types as a registry
  (``collect()``), so :class:`~.exposition.MetricsServer` serves ONE
  fleet-wide ``/metrics`` and :class:`~.exposition.JsonlSink` writes one
  fleet JSONL stream.
* **stitch** — :meth:`FleetAggregator.export_chrome` merges every
  host's span ring into one Perfetto file with a process track per host;
  spans ship with wall-clock endpoints and keep their trace ids, so an
  elastic generation (whose workers adopt the manager's generation
  context) reads as one timeline instead of N files.
* **degrade** — a host whose snapshot sequence number stops advancing
  for ``stale_after`` seconds is marked stale
  (``paddle_tpu_fleet_host_up{host}=0``) but its last-known counters
  keep contributing to the fleet totals: a dead publisher dims a row in
  the table, it never takes the endpoint down.

CLI::

    python -m paddle_tpu_torch.observability.fleet --store 127.0.0.1:8765

snapshots the store and renders the fleet table (per-host step time,
goodput, restarts, SLO attainment, top stragglers); ``--serve`` keeps a
federated ``/metrics`` endpoint up, ``--export-trace`` writes the merged
Perfetto file.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.observability.metrics import MetricsRegistry

__all__ = ["FLEET_SCHEMA", "fleet_host_id", "LocalStore",
           "MetricsPublisher", "FleetAggregator", "merge_snapshots",
           "start_publisher_from_env", "main"]

FLEET_SCHEMA = 1


def fleet_host_id() -> str:
    """Stable per-process host id for fleet keys.

    ``PADDLE_TPU_FLEET_HOST`` wins; under a launcher the rank
    (``PADDLE_TRAINER_ID`` / ``PROCESS_ID``) identifies the host, with a
    ``g<generation>`` prefix under the elastic manager so a relaunched
    rank publishes as a NEW host — restart churn shows up as the old
    generation's hosts going stale instead of silently overwriting a
    live one's counters with reset values."""
    explicit = os.environ.get("PADDLE_TPU_FLEET_HOST")
    if explicit:
        return explicit
    rank = os.environ.get("PADDLE_TRAINER_ID",
                          os.environ.get("PROCESS_ID"))
    if rank is not None:
        gen = os.environ.get("PADDLE_ELASTIC_GEN")
        return f"g{gen}r{rank}" if gen is not None else f"r{rank}"
    import socket
    return f"{socket.gethostname()}-{os.getpid()}"


class LocalStore:
    """In-process store with the TCPStore contract subset the fleet
    plane uses (``set``/``get``/``check``/``add``) — the demo's
    publish→aggregate→render phase and the unit tests run the whole
    federation path without sockets or the native library."""

    def __init__(self):
        self._kv: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def set(self, key: str, value):
        data = value if isinstance(value, bytes) else str(value).encode()
        with self._lock:
            self._kv[key] = data

    def get(self, key: str, wait: bool = True) -> bytes:
        with self._lock:
            if key not in self._kv:
                raise KeyError(key)
            return self._kv[key]

    def check(self, key: str) -> bool:
        with self._lock:
            return key in self._kv

    def add(self, key: str, amount: int = 1) -> int:
        with self._lock:
            v = int(self._kv.get(key, b"0")) + amount
            self._kv[key] = str(v).encode()
            return v


def _publisher_metrics(registry):
    return {
        "publishes": registry.counter(
            "paddle_tpu_fleet_publish_total",
            "registry snapshots published to the fleet store"),
        "errors": registry.counter(
            "paddle_tpu_fleet_publish_errors_total",
            "snapshot publishes that failed (store down, fault "
            "injection); max_failures consecutive ones stop the "
            "publisher — the aggregator then marks this host stale"),
    }


class MetricsPublisher:
    """Ships this process's registry snapshot + span ring to the store
    every ``interval`` seconds (daemon thread; ``publish_once()`` is the
    synchronous core the tests and the demo drive directly).

    Degradation contract: a failing publish increments
    ``paddle_tpu_fleet_publish_errors_total`` and is retried next tick;
    ``max_failures`` CONSECUTIVE failures kill the thread (recorded as a
    ``fleet.publisher_dead`` flight-recorder event) — a wedged store
    connection must not spin forever, and the aggregator's staleness
    marking is the designed fallback."""

    def __init__(self, store, registry=None, tracer_=None,
                 host: Optional[str] = None,
                 interval: Optional[float] = None, prefix: str = "obs",
                 publish_traces: bool = True,
                 publish_goodput: bool = True,
                 publish_decisions: bool = True, max_failures: int = 3):
        if registry is None:
            from paddle_tpu_torch.observability.metrics import default_registry
            registry = default_registry()
        self.store = store
        self.registry = registry
        self.host = host or fleet_host_id()
        if interval is None:
            interval = float(os.environ.get("PADDLE_TPU_FLEET_INTERVAL",
                                            "5"))
        self.interval = interval
        self.prefix = prefix
        self.publish_traces = publish_traces
        self.publish_decisions = publish_decisions
        self.max_failures = max_failures
        self._tracer = tracer_
        self._seq = 0
        self._metrics = _publisher_metrics(registry)
        # goodput rides every snapshot: tick the monitor right before
        # collect() so the federated gauges are never older than the
        # publish interval
        self._goodput = None
        if publish_goodput:
            from paddle_tpu_torch.observability import goodput as _goodput
            from paddle_tpu_torch.observability.metrics import default_registry
            self._goodput = _goodput.goodput_monitor() \
                if registry is default_registry() \
                else _goodput.GoodputMonitor(registry)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- one snapshot --------------------------------------------------------
    def _register_host(self):
        """Eventually-consistent membership: read-modify-write the
        comma-joined ``obs/hosts`` key.  Two hosts racing can drop one
        registration; each re-asserts itself every tick, so the roster
        self-heals within one interval."""
        key = f"{self.prefix}/hosts"
        try:
            raw = self.store.get(key, wait=False).decode() \
                if self.store.check(key) else ""
        except Exception:
            raw = ""
        names = [n for n in raw.split(",") if n]
        if self.host not in names:
            names.append(self.host)
            self.store.set(key, ",".join(names).encode())

    def publish_once(self) -> dict:
        from paddle_tpu_torch.robustness import fault_point
        fault_point("obs.fleet.publish", host=self.host)
        if self._goodput is not None:
            try:
                self._goodput.publish()
            except Exception:
                pass
        self._seq += 1
        payload = {
            "schema": FLEET_SCHEMA, "host": self.host,
            "time": time.time(), "seq": self._seq, "pid": os.getpid(),
            "generation": os.environ.get("PADDLE_ELASTIC_GEN"),
            "restarts": os.environ.get("PADDLE_ELASTIC_RESTARTS"),
            "metrics": self.registry.collect(),
        }
        self._register_host()
        self.store.set(f"{self.prefix}/metrics/{self.host}",
                       json.dumps(payload, default=str).encode())
        if self.publish_traces:
            from paddle_tpu_torch.observability.tracing import inject_spans
            inject_spans(self.store,
                         f"{self.prefix}/trace/{self.host}",
                         host=self.host, tracer_=self._tracer)
        if self.publish_decisions:
            # scheduler decision provenance federates exactly like
            # spans: bounded window, own key, tolerant extraction
            from paddle_tpu_torch.observability.forensics import \
                inject_decisions
            inject_decisions(self.store,
                             f"{self.prefix}/forensics/{self.host}",
                             host=self.host)
        self._metrics["publishes"].inc()
        return payload

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "MetricsPublisher":
        def loop():
            consecutive = 0
            while not self._stop.wait(self.interval):
                try:
                    self.publish_once()
                    consecutive = 0
                except Exception as e:
                    consecutive += 1
                    self._metrics["errors"].inc()
                    try:
                        from paddle_tpu_torch.observability import \
                            flight_recorder
                        flight_recorder().record(
                            "fleet.publish_failed", host=self.host,
                            error=type(e).__name__,
                            consecutive=consecutive)
                        if consecutive >= self.max_failures:
                            flight_recorder().record(
                                "fleet.publisher_dead", host=self.host,
                                failures=consecutive)
                    except Exception:
                        pass
                    if consecutive >= self.max_failures:
                        return
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle-tpu-fleet-publish")
        self._thread.start()
        return self

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# -- merge ------------------------------------------------------------------
def _infer_labelnames(host_fams) -> Tuple[str, ...]:
    for _h, fam in host_fams:
        for s in fam.get("series", []):
            if s.get("labels"):
                return tuple(s["labels"].keys())
    return ()


def _label_values(series, labelnames) -> Tuple[str, ...]:
    labels = series.get("labels") or {}
    return tuple(str(labels.get(k, "")) for k in labelnames)


def merge_snapshots(snapshots: Dict[str, dict],
                    merged: Optional[MetricsRegistry] = None,
                    max_series: int = 64
                    ) -> Tuple[MetricsRegistry, List[str], int]:
    """Merge host → snapshot payloads into ``merged`` (a fresh registry
    when None).  Returns ``(registry, owned_family_names, conflicts)``.

    Semantics (the federation contract, documented in the README):

    * **counter** — per-label-set sum across hosts.  Exact: each host's
      counter is itself a sum of its own increments.
    * **histogram** — per-bucket count sum across hosts with identical
      bounds (plus ``sum``/``count``/min/max), which keeps
      ``histogram_quantile`` over the federated buckets equal to the
      same estimator over the pooled observations.  A host whose bounds
      disagree is skipped for that family and counted as a conflict.
    * **gauge** — point-in-time values cannot be summed: every host
      keeps its own series under an added ``host`` label, and a
      ``<name>_fleet{stat=min|mean|max}`` roll-up family summarizes the
      spread per original label-set (NaN gauges are excluded from
      roll-ups).
    """
    if merged is None:
        merged = MetricsRegistry()
    fams: Dict[str, dict] = {}
    conflicts = 0
    for host in sorted(snapshots):
        snap = snapshots[host]
        if not isinstance(snap, dict) or \
                snap.get("schema") != FLEET_SCHEMA:
            conflicts += 1
            continue
        for fam in snap.get("metrics", []):
            rec = fams.setdefault(fam["name"], {
                "kind": fam["kind"], "help": fam.get("help", ""),
                "hosts": []})
            if rec["kind"] != fam["kind"]:
                conflicts += 1
                continue
            rec["hosts"].append((host, fam))
    owned: List[str] = []
    for name in sorted(fams):
        rec = fams[name]
        labelnames = _infer_labelnames(rec["hosts"])
        try:
            if rec["kind"] == "counter":
                totals: Dict[Tuple[str, ...], float] = {}
                for _h, fam in rec["hosts"]:
                    for s in fam.get("series", []):
                        vals = _label_values(s, labelnames)
                        v = float(s.get("value") or 0.0)
                        totals[vals] = totals.get(vals, 0.0) + v
                c = merged.counter(name, rec["help"], labelnames,
                                   max_series=max_series)
                for vals, v in totals.items():
                    child = c.labels(*vals) if labelnames else c
                    child._value += v
                owned.append(name)
            elif rec["kind"] == "gauge":
                g = merged.gauge(name, rec["help"],
                                 labelnames + ("host",),
                                 max_series=max_series)
                spread: Dict[Tuple[str, ...], List[float]] = {}
                for host, fam in rec["hosts"]:
                    for s in fam.get("series", []):
                        vals = _label_values(s, labelnames)
                        raw = s.get("value")
                        v = float(raw) if raw is not None \
                            else float("nan")
                        g.labels(*(vals + (host,))).set(v)
                        if v == v:
                            spread.setdefault(vals, []).append(v)
                roll = merged.gauge(
                    name + "_fleet",
                    (rec["help"] + " " if rec["help"] else "")
                    + "(fleet roll-up across hosts)",
                    labelnames + ("stat",), max_series=max_series)
                for vals, vs in spread.items():
                    roll.labels(*(vals + ("min",))).set(min(vs))
                    roll.labels(*(vals + ("mean",))).set(
                        sum(vs) / len(vs))
                    roll.labels(*(vals + ("max",))).set(max(vs))
                owned += [name, name + "_fleet"]
            elif rec["kind"] == "histogram":
                bounds: Optional[Tuple[float, ...]] = None
                state: Dict[Tuple[str, ...], dict] = {}
                for _h, fam in rec["hosts"]:
                    for s in fam.get("series", []):
                        bks = s.get("buckets") or []
                        b = tuple(float(x[0]) for x in bks)
                        if bounds is None:
                            bounds = b
                        if b != bounds:
                            conflicts += 1
                            continue
                        vals = _label_values(s, labelnames)
                        cums = [float(x[1]) for x in bks]
                        noncum = [cums[0]] + [
                            cums[i] - cums[i - 1]
                            for i in range(1, len(cums))]
                        tail = float(s.get("count", 0)) - (
                            cums[-1] if cums else 0.0)
                        counts = noncum + [max(0.0, tail)]
                        st = state.setdefault(vals, {
                            "counts": [0.0] * len(counts),
                            "sum": 0.0, "count": 0,
                            "min": float("inf"),
                            "max": float("-inf")})
                        st["counts"] = [a + b_ for a, b_ in
                                        zip(st["counts"], counts)]
                        st["sum"] += float(s.get("sum", 0.0))
                        st["count"] += int(s.get("count", 0))
                        mn = s.get("min")
                        mx = s.get("max")
                        if mn is not None:
                            st["min"] = min(st["min"], float(mn))
                        if mx is not None:
                            st["max"] = max(st["max"], float(mx))
                if bounds is None:
                    continue
                h = merged.histogram(name, rec["help"], labelnames,
                                     buckets=bounds,
                                     max_series=max_series)
                for vals, st in state.items():
                    child = h.labels(*vals) if labelnames else h
                    child._counts = [int(c) for c in st["counts"]]
                    child._sum = st["sum"]
                    child._count = st["count"]
                    child._min = st["min"]
                    child._max = st["max"]
                owned.append(name)
        except Exception:
            conflicts += 1
            merged.unregister(name)
            merged.unregister(name + "_fleet")
    return merged, owned, conflicts


class FleetAggregator:
    """Polls the store, merges per-host snapshots, serves the result.

    Duck-types as a registry for the exposition layer (``collect()``
    refreshes then snapshots), so ``MetricsServer(registry=aggregator)``
    is the one fleet-wide ``/metrics`` endpoint and
    ``JsonlSink(path, registry=aggregator)`` the fleet JSONL stream.
    ``merged_registry()`` returns a PERSISTENT
    :class:`MetricsRegistry` refreshed in place — hand that to a
    :class:`~.watchdog.Watchdog` and the ``straggler`` /
    ``goodput_floor`` rules evaluate against live fleet state while the
    watchdog's own breach counter survives refreshes."""

    def __init__(self, store=None, stale_after: float = 15.0,
                 max_series: int = 64, prefix: str = "obs"):
        self.store = store
        self.stale_after = stale_after
        self.max_series = max_series
        self.prefix = prefix
        self._snapshots: Dict[str, dict] = {}
        self._traces: Dict[str, dict] = {}
        self._decisions: Dict[str, dict] = {}
        # host -> (last seq, monotonic stamp of last seq ADVANCE): the
        # staleness clock is the aggregator's own — no cross-host wall
        # clock comparison anywhere
        self._advance: Dict[str, Tuple[int, float]] = {}
        self._merged = MetricsRegistry()
        self._owned: List[str] = []
        self.conflicts = 0

    # -- ingestion ----------------------------------------------------------
    def ingest(self, payload: dict,
               trace_payload: Optional[dict] = None,
               decision_payload: Optional[dict] = None) -> str:
        """Feed one host's snapshot directly (no store) — the in-process
        path the demo and tests use; ``poll()`` is the store-backed
        twin."""
        host = str(payload.get("host"))
        seq = int(payload.get("seq", 0))
        prev = self._advance.get(host)
        if prev is None or seq != prev[0]:
            self._advance[host] = (seq, time.monotonic())
        self._snapshots[host] = payload
        if trace_payload is not None:
            self._traces[host] = trace_payload
        if decision_payload is not None:
            self._decisions[host] = decision_payload
        return host

    def poll(self) -> List[str]:
        """Read the roster + every host's snapshot/trace keys from the
        store.  Unreadable hosts keep their last snapshot (and go stale
        on schedule); a missing roster is an empty fleet, not an
        error."""
        if self.store is None:
            return sorted(self._snapshots)
        from paddle_tpu_torch.observability.forensics import extract_decisions
        from paddle_tpu_torch.observability.tracing import extract_spans
        key = f"{self.prefix}/hosts"
        try:
            raw = self.store.get(key, wait=False).decode() \
                if self.store.check(key) else ""
        except Exception:
            raw = ""
        for host in [n for n in raw.split(",") if n]:
            try:
                mkey = f"{self.prefix}/metrics/{host}"
                if not self.store.check(mkey):
                    continue
                payload = json.loads(
                    self.store.get(mkey, wait=False).decode())
                if payload.get("schema") != FLEET_SCHEMA:
                    continue
                self.ingest(payload)
            except Exception:
                continue
            tp = extract_spans(self.store,
                               f"{self.prefix}/trace/{host}")
            if tp is not None:
                self._traces[host] = tp
            dp = extract_decisions(self.store,
                                   f"{self.prefix}/forensics/{host}")
            if dp is not None:
                self._decisions[host] = dp
        return sorted(self._snapshots)

    def decision_events(self) -> List[dict]:
        """Every host's published decision events, host-tagged and
        time-ordered — the event stream :func:`forensics.explain` and
        :func:`forensics.tail_report` take for a fleet-wide view."""
        merged: List[dict] = []
        for host, payload in self._decisions.items():
            for ev in payload.get("events", ()):
                ev = dict(ev)
                ev.setdefault("host", payload.get("host") or host)
                merged.append(ev)
        merged.sort(key=lambda e: (float(e.get("time", 0.0)),
                                   int(e.get("seq", 0))))
        return merged

    def explain(self, rid):
        """Fleet-wide request forensics from the federated decision
        stream (see :func:`forensics.explain`)."""
        from paddle_tpu_torch.observability.forensics import explain
        return explain(rid, events=self.decision_events())

    def hosts(self) -> Dict[str, dict]:
        """Roster view: seq, seconds since the seq last advanced, and
        the stale verdict per host."""
        now = time.monotonic()
        out = {}
        for host, snap in self._snapshots.items():
            seq, stamp = self._advance.get(host, (0, now))
            age = now - stamp
            out[host] = {"seq": seq, "age_s": age,
                         "stale": age > self.stale_after,
                         "generation": snap.get("generation"),
                         "restarts": snap.get("restarts")}
        return out

    # -- merge / exposition -------------------------------------------------
    def refresh(self) -> MetricsRegistry:
        """Re-merge the latest snapshots into the persistent registry.
        Families owned by the previous merge are replaced; anything
        registered on the merged registry by OTHERS (e.g. a watchdog's
        breach counter) is left alone."""
        if self.store is not None:
            self.poll()
        for name in self._owned:
            self._merged.unregister(name)
        _, owned, conflicts = merge_snapshots(
            dict(self._snapshots), self._merged,
            max_series=self.max_series)
        self.conflicts += conflicts
        roster = self.hosts()
        meta_hosts = self._merged.gauge(
            "paddle_tpu_fleet_hosts",
            "hosts that have ever published to this aggregator")
        meta_hosts.set(len(roster))
        meta_up = self._merged.gauge(
            "paddle_tpu_fleet_host_up",
            "1 while the host's snapshots keep advancing, 0 once stale "
            "(last-known counters still count toward fleet totals)",
            labelnames=("host",))
        meta_age = self._merged.gauge(
            "paddle_tpu_fleet_host_age_seconds",
            "seconds since the host's snapshot sequence last advanced",
            labelnames=("host",))
        for host, info in roster.items():
            meta_up.labels(host=host).set(0.0 if info["stale"] else 1.0)
            meta_age.labels(host=host).set(info["age_s"])
        meta_conf = self._merged.gauge(
            "paddle_tpu_fleet_merge_conflicts_total",
            "snapshot families dropped by the merger (schema/kind/"
            "bucket-bound mismatch)")
        meta_conf.set(self.conflicts)
        self._owned = owned + [
            "paddle_tpu_fleet_hosts", "paddle_tpu_fleet_host_up",
            "paddle_tpu_fleet_host_age_seconds",
            "paddle_tpu_fleet_merge_conflicts_total"]
        return self._merged

    def merged_registry(self, refresh: bool = True) -> MetricsRegistry:
        if refresh:
            self.refresh()
        return self._merged

    def collect(self) -> List[dict]:
        """Registry duck-type: refresh + snapshot, so every scrape of a
        ``MetricsServer(registry=aggregator)`` serves current fleet
        state."""
        return self.merged_registry().collect()

    def serve(self, port: int = 0):
        from paddle_tpu_torch.observability.exposition import MetricsServer
        return MetricsServer(port=port, registry=self)

    # -- stitched traces ----------------------------------------------------
    def export_chrome(self, path: Optional[str] = None) -> dict:
        """One Perfetto/chrome-trace JSON with a process track per host
        (pid = host index, ``process_name`` = host id).  Spans arrive
        with wall-clock endpoints, so tracks align on one timeline; the
        per-span ``trace_id``/``span_id``/``parent_id`` args survive the
        merge — an elastic generation's cross-host spans share a
        trace id and join in Perfetto queries.  Federated scheduler
        decisions render as instant events on each host's track, with
        flow arrows chaining one rid's decisions across hosts
        (router -> prefill -> handoff -> decode)."""
        events: List[dict] = []
        hosts = sorted(set(self._traces) | set(self._decisions))
        for pid, host in enumerate(hosts):
            payload = self._traces.get(host) or {}
            spans = payload.get("spans", [])
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": f"paddle_tpu host {host}"}})
            tids = {t: i for i, t in enumerate(
                sorted({s.get("thread", "main") for s in spans}))}
            for tname, tid in tids.items():
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": tid,
                               "args": {"name": tname}})
            for s in spans:
                attrs = dict(s.get("attrs") or {})
                cat = str(attrs.pop("cat", "span"))
                events.append({
                    "name": s["name"], "cat": cat, "ph": "X",
                    "ts": s["t0"] * 1e6,
                    "dur": (s["t1"] - s["t0"]) * 1e6,
                    "pid": pid,
                    "tid": tids[s.get("thread", "main")],
                    "args": {"trace_id": s.get("trace_id"),
                             "span_id": s.get("span_id"),
                             "parent_id": s.get("parent_id"),
                             "host": host, **attrs}})
            dpayload = self._decisions.get(host)
            if dpayload is not None:
                from paddle_tpu_torch.observability.forensics import \
                    decisions_to_chrome
                events.extend(decisions_to_chrome(
                    dpayload.get("events", ()), pid=pid))
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(trace, f, default=str)
        return trace

    # -- fleet table --------------------------------------------------------
    @staticmethod
    def _snap_value(snap: dict, name: str, labels: Optional[dict] = None,
                    field: str = "value") -> Optional[float]:
        for fam in snap.get("metrics", []):
            if fam["name"] != name:
                continue
            total, seen = 0.0, False
            for s in fam.get("series", []):
                if labels and any(
                        (s.get("labels") or {}).get(k) != v
                        for k, v in labels.items()):
                    continue
                v = s.get(field)
                if v is None:
                    continue
                try:
                    total += float(v)
                    seen = True
                except (TypeError, ValueError):
                    continue
            return total if seen else None
        return None

    @staticmethod
    def _snap_role(snap: dict) -> Optional[str]:
        """Serving role from the engine-published
        ``paddle_tpu_serving_replica_role`` marker gauge (value 1 on
        the active role's series).  A host running several in-process
        engines with different roles reads as ``mixed``."""
        for fam in snap.get("metrics", []):
            if fam["name"] != "paddle_tpu_serving_replica_role":
                continue
            roles = sorted({
                (s.get("labels") or {}).get("role", "")
                for s in fam.get("series", [])
                if (s.get("value") or 0) >= 1})
            roles = [r for r in roles if r]
            if not roles:
                return None
            return roles[0] if len(roles) == 1 else "mixed"
        return None

    def table(self) -> str:
        """The fleet at a glance: one row per host (step EMA, steps,
        goodput, restarts, serving role/queue/slot occupancy, SLO
        attainment, MoE expert-load imbalance, staleness), plus the
        straggler footer — hosts whose
        step-time EMA sits above the fleet median."""
        roster = self.hosts()
        # SDC quarantine roster (robustness.recovery): a blamed host's
        # row renders QUAR instead of up/STALE — the operator sees the
        # exclusion in the same glance as the fleet it protects
        quarantined = set()
        if self.store is not None:
            try:
                from paddle_tpu_torch.robustness.recovery import \
                    quarantined_hosts
                quarantined = set(quarantined_hosts(self.store))
            except Exception:
                pass
        header = (f"{'host':<14} {'up':<6} {'age_s':>6} {'gen':>4} "
                  f"{'restarts':>8} {'steps':>7} {'step_ms':>8} "
                  f"{'goodput':>8} {'role':>8} {'queue':>6} "
                  f"{'slots':>7} {'slo_ttft':>8} {'slo_tpot':>8} "
                  f"{'moe_imb':>7} {'kvtier':>7}")
        lines = [header, "-" * len(header)]
        emas: Dict[str, float] = {}
        for host in sorted(self._snapshots):
            snap = self._snapshots[host]
            info = roster[host]
            ema = self._snap_value(
                snap, "paddle_tpu_train_step_ema_seconds")
            if ema:
                emas[host] = ema
            steps = self._snap_value(snap,
                                     "paddle_tpu_train_steps_total")
            goodput = self._snap_value(snap, "paddle_tpu_goodput")
            ttft = self._snap_value(snap, "paddle_tpu_slo_attainment",
                                    labels={"kind": "ttft"})
            tpot = self._snap_value(snap, "paddle_tpu_slo_attainment",
                                    labels={"kind": "tpot"})
            role = self._snap_role(snap)
            queue = self._snap_value(snap,
                                     "paddle_tpu_serving_queue_depth")
            active = self._snap_value(snap,
                                      "paddle_tpu_serving_active_slots")
            slots = self._snap_value(snap, "paddle_tpu_serving_slots")
            moe_imb = self._snap_value(snap,
                                       "paddle_tpu_moe_expert_imbalance")
            # KV blocks demoted below HBM (host RAM + peer store) —
            # the session-survivability headroom this host carries
            kvtier = self._snap_value(snap, "paddle_tpu_kv_tier_blocks")
            occupancy = (f"{active:.0f}/{slots:.0f}"
                         if active is not None and slots else "-")

            def fmt(v, scale=1.0, pct=False):
                if v is None:
                    return "-"
                return f"{v * 100:.1f}%" if pct else f"{v * scale:.2f}"
            status = ("QUAR" if host in quarantined
                      else "STALE" if info["stale"] else "up")
            lines.append(
                f"{host:<14} "
                f"{status:<6} "
                f"{info['age_s']:>6.1f} "
                f"{str(info.get('generation') or '-'):>4} "
                f"{str(info.get('restarts') or '0'):>8} "
                f"{fmt(steps):>7} {fmt(ema, 1e3):>8} "
                f"{fmt(goodput):>8} {(role or '-'):>8} "
                f"{fmt(queue):>6} {occupancy:>7} "
                f"{fmt(ttft, pct=True):>8} "
                f"{fmt(tpot, pct=True):>8} "
                f"{fmt(moe_imb):>7} "
                f"{fmt(kvtier):>7}")
        if emas:
            med = statistics.median(emas.values())
            stragglers = sorted(
                ((h, v / med) for h, v in emas.items()
                 if med > 0 and v > 1.25 * med),
                key=lambda kv: -kv[1])
            if stragglers:
                lines.append("top stragglers: " + ", ".join(
                    f"{h} ({r:.2f}x median)" for h, r in stragglers))
            else:
                lines.append(
                    f"no stragglers (median step "
                    f"{med * 1e3:.2f}ms across {len(emas)} hosts)")
        return "\n".join(lines)


# -- env / CLI ---------------------------------------------------------------
def _connect_store(addr: Optional[str]):
    """A client of the TCPStore at `addr`: not ported yet, so it raises
    (the fleet plane runs over :class:`LocalStore` or any store object
    with its contract)."""
    raise NotImplementedError(
        f"fleet store {addr!r}: the TCPStore is not ported yet (ROADMAP.md,"
        " queue 1, item 8); pass a LocalStore-contract store instead")


_ENV_PUBLISHER: Optional[MetricsPublisher] = None


def start_publisher_from_env(registry) -> Optional[MetricsPublisher]:
    """``PADDLE_TPU_FLEET_METRICS=<host:port|port|1>`` starts the
    publisher against that store (``1`` reuses the elastic manager's
    ``PADDLE_ELASTIC_STORE``).  Called from the exposition env hook —
    one publisher per process."""
    global _ENV_PUBLISHER
    if _ENV_PUBLISHER is not None:
        return _ENV_PUBLISHER
    store = _connect_store(os.environ.get("PADDLE_TPU_FLEET_METRICS"))
    _ENV_PUBLISHER = MetricsPublisher(store, registry=registry).start()
    return _ENV_PUBLISHER


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.fleet",
        description="Snapshot a fleet store and render the fleet table "
                    "(optionally serve the federated /metrics and "
                    "export the stitched Perfetto trace).")
    ap.add_argument("--store", default=None,
                    help="TCPStore address host:port (default: "
                         "PADDLE_TPU_FLEET_METRICS / "
                         "PADDLE_ELASTIC_STORE)")
    ap.add_argument("--stale-after", type=float, default=15.0)
    ap.add_argument("--serve", type=int, metavar="PORT", default=None,
                    help="serve the federated /metrics on PORT and "
                         "keep running")
    ap.add_argument("--jsonl", metavar="PATH", default=None,
                    help="append one fleet snapshot line to PATH")
    ap.add_argument("--export-trace", metavar="PATH", default=None,
                    help="write the merged multi-host Perfetto trace")
    ap.add_argument("--watch", type=float, metavar="SECS", default=None,
                    help="re-render the table every SECS seconds")
    ap.add_argument("--metrics", action="store_true",
                    help="also print the federated Prometheus text")
    args = ap.parse_args(argv)

    store = _connect_store(args.store)
    agg = FleetAggregator(store=store, stale_after=args.stale_after)

    def render_once():
        agg.refresh()
        print(agg.table())
        if args.metrics:
            from paddle_tpu_torch.observability.exposition import \
                render_prometheus
            print(render_prometheus(agg._merged))

    render_once()
    if args.export_trace:
        trace = agg.export_chrome(args.export_trace)
        tracks = len([e for e in trace["traceEvents"]
                      if e.get("name") == "process_name"])
        print(f"wrote {args.export_trace} ({tracks} host tracks)",
              file=sys.stderr)
    if args.jsonl:
        from paddle_tpu_torch.observability.exposition import JsonlSink
        JsonlSink(args.jsonl, registry=agg).write()
        print(f"appended fleet snapshot to {args.jsonl}",
              file=sys.stderr)
    server = None
    if args.serve is not None:
        server = agg.serve(port=args.serve)
        print(f"fleet /metrics at {server.url}", file=sys.stderr)
    if args.watch or server is not None:
        try:
            while True:
                time.sleep(args.watch or 15.0)
                if args.watch:
                    print()
                    render_once()
        except KeyboardInterrupt:
            pass
        finally:
            if server is not None:
                server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
