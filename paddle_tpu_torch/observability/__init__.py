"""Runtime telemetry (``paddle_tpu/observability``): the modules the
serving fleet runs on, copied from the JAX package, which imports no
JAX in them.

* **metrics** — label-aware :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` in a process-wide registry that the serving engine,
  the router and the KV tier write to.
* **flight recorder** — a bounded ring of structured events, dumped when
  an uncaught exception escapes an instrumented loop.
* **tracing** — hierarchical spans (the request lifecycle, decode steps,
  the router's hop) with explicit cross-thread and cross-host context
  propagation and chrome-trace export.
* **watchdog** — declarative SLO rules evaluated against a registry.
* **exposition** — Prometheus text at ``/metrics`` and a JSONL sink.
* **forensics** — scheduler decision events (route, admit, park,
  resume, requeue, tier, autoscale, retire) and per-request latency
  attribution.
* **fleet** — snapshot publishing, type-correct merging across hosts
  and the fleet table, over :class:`LocalStore` or any store of its
  contract (the TCPStore is not ported yet: ROADMAP.md, queue 1, item
  8).
* **goodput** — goodput and SLO attainment.

Not ported yet (ROADMAP.md, queue 1, item 9): the device profiler and
the measurement ledger (``device_profiler.py``, ``calibration.py``)."""

from __future__ import annotations

from paddle_tpu_torch.observability.metrics import (Counter, Gauge,
                                                    Histogram,
                                                    MetricsRegistry,
                                                    DEFAULT_BUCKETS,
                                                    default_registry)
from paddle_tpu_torch.observability.recorder import (FlightRecorder,
                                                     flight_recorder)
from paddle_tpu_torch.observability.exposition import (JsonlSink,
                                                       MetricsServer,
                                                       render_json,
                                                       render_prometheus,
                                                       start_metrics_server)
from paddle_tpu_torch.observability.tracing import (Span, SpanContext,
                                                    Tracer,
                                                    extract_context,
                                                    extract_spans,
                                                    inject_context,
                                                    inject_spans,
                                                    trace_span, tracer)
from paddle_tpu_torch.observability.watchdog import (Alert,
                                                     TailRegressionRule,
                                                     Watchdog,
                                                     default_rules,
                                                     rules_from_spec)
from paddle_tpu_torch.observability.forensics import (DecisionEvent,
                                                      attribute,
                                                      decision_events,
                                                      emit_decision,
                                                      explain,
                                                      extract_decisions,
                                                      inject_decisions,
                                                      tail_report)
from paddle_tpu_torch.observability.fleet import (FleetAggregator,
                                                  LocalStore,
                                                  MetricsPublisher,
                                                  fleet_host_id,
                                                  merge_snapshots)
from paddle_tpu_torch.observability.goodput import (GoodputMonitor,
                                                    compute_goodput,
                                                    goodput_monitor,
                                                    slo_attainment,
                                                    slo_targets)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "DEFAULT_BUCKETS", "default_registry",
    "FlightRecorder", "flight_recorder",
    "JsonlSink", "MetricsServer", "render_json", "render_prometheus",
    "start_metrics_server",
    "Span", "SpanContext", "Tracer", "tracer", "trace_span",
    "inject_context", "extract_context", "inject_spans",
    "extract_spans",
    "Alert", "TailRegressionRule", "Watchdog", "default_rules",
    "rules_from_spec",
    "DecisionEvent", "attribute", "decision_events", "emit_decision",
    "explain", "extract_decisions", "inject_decisions", "tail_report",
    "FleetAggregator", "LocalStore", "MetricsPublisher",
    "fleet_host_id", "merge_snapshots",
    "GoodputMonitor", "compute_goodput", "goodput_monitor",
    "slo_attainment", "slo_targets",
]
