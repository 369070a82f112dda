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
  contract (``distributed/tcp_store.py``'s TCPStore among them).
* **goodput** — goodput and SLO attainment.
* **device profiler** — compile records and the compile series, segment
  timing on the card with roofline-gap attribution against the cost
  model, and the live-memory watermark, census and leak detector
  (``device_profiler.py``).
* **calibration** — the measurement ledger (the JAX package's file
  format) and the cost model it calibrates; it answers the ``measured``
  fusion tier (``calibration.py``)."""

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

from paddle_tpu_torch.observability.device_profiler import (
    AttributionResult, CompileInfo, DeviceMemoryMonitor, DeviceProfiler,
    ExecutableStats, Segment, SegmentReport, aot_compile,
    compile_records, compiled_stats, detect_roofline,
    device_memory_monitor, llama_step_segments, segment_records,
    signature_of)
from paddle_tpu_torch.observability.calibration import (CalibratedCostModel,
                                                        MeasurementLedger)
from paddle_tpu_torch.observability import calibration

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
    "AttributionResult", "CompileInfo", "DeviceMemoryMonitor",
    "DeviceProfiler", "ExecutableStats", "Segment", "SegmentReport",
    "aot_compile", "compile_records", "compiled_stats",
    "detect_roofline", "device_memory_monitor", "llama_step_segments",
    "segment_records", "signature_of",
    "CalibratedCostModel", "MeasurementLedger", "calibration",
]
