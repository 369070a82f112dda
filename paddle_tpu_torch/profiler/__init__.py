"""paddle_tpu_torch.profiler — host annotations + device trace
(``paddle_tpu/profiler``: the ``paddle.profiler`` surface).

The device tracer is ``torch.profiler``: the CPU activity, and the
card's kernels where there is a card (CUPTI), in one chrome trace;
``RecordEvent`` is ``torch.profiler.record_function`` (so its range sits
among the kernels in that trace) plus the JAX package's host event
recorder, which feeds ``summary()`` and becomes a child span of the
active tracing span.  ``summary()`` adds the analysis findings, the
cost model's tables, the device profiler's segment table (attached
results, else ``segment_records()``) and the runtime metrics.
"""

from __future__ import annotations

import contextlib
import enum
import threading
import time
from typing import Callable, Iterable, Optional

import torch

__all__ = ["Profiler", "RecordEvent", "ProfilerTarget", "ProfilerState",
           "make_scheduler", "export_chrome_tracing", "load_profiler_result",
           "benchmark", "format_diagnostics"]


def format_diagnostics(diags, title: str = "program analysis") -> str:
    """Render ``paddle_tpu_torch.analysis`` Diagnostics in the profiler's
    table style (duck-typed on pass_id/severity/message/count so the
    profiler stays import-independent of the analysis package).  The
    cost model's roll-up (``CostSummary.to_diagnostics()``) renders the
    same way — static FLOPs/bytes next to measured wall time."""
    lines = [f"-- {title} " + "-" * max(0, 60 - len(title)),
             f"{'pass':22s} {'severity':>8s}  finding"]
    for d in diags:
        mult = f" (×{d.count})" if getattr(d, "count", 1) > 1 else ""
        where = f"  [{d.where}]" if getattr(d, "where", "") else ""
        lines.append(f"{d.pass_id:22s} {str(d.severity):>8s}  "
                     f"{d.message}{mult}{where}")
    return "\n".join(lines)


class ProfilerTarget(enum.Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2
    TPU = 3


def _activities(targets):
    """torch.profiler activities of `targets` (default: the CPU, and the
    card where there is one).  Asking for the GPU without one raises."""
    from torch.profiler import ProfilerActivity
    if targets is None:
        targets = [ProfilerTarget.CPU]
        if torch.cuda.is_available():
            targets.append(ProfilerTarget.GPU)
    acts = []
    for t in targets:
        if t == ProfilerTarget.CPU:
            acts.append(ProfilerActivity.CPU)
        elif t == ProfilerTarget.GPU:
            if not torch.cuda.is_available():
                raise RuntimeError("ProfilerTarget.GPU asked for, but CUDA "
                                   "is not available")
            acts.append(ProfilerActivity.CUDA)
        else:
            raise ValueError(f"profiler target {t} has no device here")
    return acts


class ProfilerState(enum.Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Step-indexed state machine (reference profiler.py:79)."""
    period = closed + ready + record

    def schedule(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


class _HostEvents:
    """Host event sink (reference HostEventRecorder,
    platform/profiler/host_event_recorder.h)."""

    def __init__(self):
        self._all = []
        self._lock = threading.Lock()

    def add(self, name, t0, t1, event_type=None):
        with self._lock:
            self._all.append((name, t0, t1, event_type))

    def drain(self):
        with self._lock:
            out, self._all = self._all, []
        return out


# Fallback sink ONLY for annotations recorded outside any profiler
# session.  Each Profiler owns a private sink for its start..stop window
# (registered in _SESSION_SINKS below): two concurrent — or sequential —
# profilers no longer steal each other's RecordEvents when one stops
# first and drains the shared global.
_EVENTS = _HostEvents()
_SESSION_SINKS: list = []
_SINKS_LOCK = threading.Lock()


def _deliver(name, t0, t1, event_type=None):
    """Route a finished host event to every ACTIVE profiler session
    (each gets its own copy), or to the global fallback when no session
    is open.  Independently, the event is offered to the span tracer:
    an annotation finishing under an active span becomes a child span,
    so the Perfetto export shows RecordEvents nested inside the
    step/request structure (observability tracing unification)."""
    with _SINKS_LOCK:
        sinks = list(_SESSION_SINKS)
    if not sinks:
        _EVENTS.add(name, t0, t1, event_type)
    else:
        for sink in sinks:
            sink.add(name, t0, t1, event_type)
    try:
        from paddle_tpu_torch.observability.tracing import on_host_event
        on_host_event(name, t0, t1, event_type)
    except Exception:
        pass  # tracing must never break profiling


class RecordEvent:
    """Host-side annotation (reference platform/profiler/event_tracing.h
    RecordEvent).  Usable as context manager or decorator; events appear in
    the device trace (``torch.profiler.record_function``) and in
    Profiler.summary().
    ``event_type`` (reference TracerEventType, e.g. "Forward",
    "Communication") is kept and surfaces as the summary's type column
    and the chrome-trace ``cat`` field."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self.event_type = getattr(event_type, "name", event_type)
        self._ann = None
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter()
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()

    def end(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self._t0 is not None:
            _deliver(self.name, self._t0, time.perf_counter(),
                     self.event_type)
            self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with RecordEvent(self.name, self.event_type):
                return fn(*a, **k)
        return wrapped


class Profiler:
    """Reference ``paddle.profiler.Profiler`` shape: targets/scheduler/
    on_trace_ready; start/stop/step; summary.  Each recording window is
    a ``torch.profiler`` session (``targets``: the CPU, and the card's
    kernels where there is one); :meth:`export` writes their chrome
    trace with the host events, and ``log_dir`` gets each window's
    trace as it closes."""

    def __init__(self, *, targets: Optional[Iterable] = None,
                 scheduler=None, on_trace_ready=None, record_shapes=False,
                 profile_memory=False, timer_only=False,
                 log_dir: str = "./profiler_log"):
        self._activities = _activities(targets)
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self._torch = None
        self._traces = []           # chrome-trace events of closed windows
        self.scheduler = scheduler if callable(scheduler) else (
            make_scheduler(closed=0, ready=0, record=scheduler[1],
                           skip_first=scheduler[0])
            if isinstance(scheduler, (tuple, list)) else None)
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.log_dir = log_dir
        self.current_state = ProfilerState.CLOSED
        self.step_num = 0
        self._tracing = False
        self._events = []
        self._step_times = []
        self._last_step_t = None
        self._diagnostics = []
        self._cost_summaries = []   # (target, CostSummary) pairs
        self._device_profiles = []  # AttributionResult objects
        # private host-event sink for this session (start() registers it,
        # stop() unregisters + drains) — concurrent profilers each see
        # their own events instead of racing over the module global
        self._sink = _HostEvents()

    def add_diagnostics(self, diags):
        """Attach analysis findings; they render in ``summary()``."""
        self._diagnostics.extend(diags)

    def add_analysis(self, report):
        """Attach a full ``paddle_tpu_torch.analysis.AnalysisReport``: its
        diagnostics plus the cost-model roll-up (as INFO rows and the
        FLOPs/bytes table) appear in ``summary()``."""
        self._diagnostics.extend(report.diagnostics)
        cost = getattr(report, "extras", {}).get("cost")
        if cost is not None:
            self._diagnostics.extend(cost.to_diagnostics())
            self._cost_summaries.append((report.target, cost))

    def add_device_profile(self, result):
        """Attach a device-profiler ``AttributionResult``
        (observability.device_profiler): the measured-device-time /
        roofline-gap attribution table renders in ``summary()`` next to
        the host-annotation and runtime-metrics sections."""
        self._device_profiles.append(result)

    # device trace control
    def _start_trace(self):
        if self.timer_only or self._tracing:
            return
        self._torch = torch.profiler.profile(
            activities=self._activities, record_shapes=self.record_shapes,
            profile_memory=self.profile_memory)
        self._torch.__enter__()
        self._tracing = True

    def _stop_trace(self):
        if not self._tracing:
            return
        import json
        import os
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._torch.__exit__(None, None, None)
        self._tracing = False
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir,
                            f"trace_{len(self._traces)}.json")
        self._torch.export_chrome_trace(path)
        with open(path) as f:
            self._traces.append(json.load(f).get("traceEvents", []))
        self._torch = None

    def device_events(self) -> list:
        """Every chrome-trace event of the closed recording windows."""
        return [e for events in self._traces for e in events]

    def start(self):
        self.current_state = self.scheduler(self.step_num) \
            if self.scheduler else ProfilerState.RECORD
        with _SINKS_LOCK:
            if self._sink not in _SESSION_SINKS:
                _SESSION_SINKS.append(self._sink)
        if self.current_state in (ProfilerState.RECORD,
                                  ProfilerState.RECORD_AND_RETURN):
            self._start_trace()
        self._last_step_t = time.perf_counter()
        return self

    def stop(self):
        self._stop_trace()
        with _SINKS_LOCK:
            if self._sink in _SESSION_SINKS:
                _SESSION_SINKS.remove(self._sink)
        self._events.extend(self._sink.drain())
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)
        self.current_state = ProfilerState.CLOSED

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._last_step_t is not None:
            self._step_times.append((now - self._last_step_t, num_samples))
        self._last_step_t = now
        self.step_num += 1
        if self.scheduler is None:
            return
        new_state = self.scheduler(self.step_num)
        if new_state != self.current_state:
            recording = self.current_state in (
                ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
            should = new_state in (ProfilerState.RECORD,
                                   ProfilerState.RECORD_AND_RETURN)
            if should and not recording:
                self._start_trace()
            elif recording and not should:
                self._stop_trace()
            self.current_state = new_state

    def step_info(self, unit: str = "samples"):
        if not self._step_times:
            return "no steps recorded"
        import numpy as np
        times = np.array([t for t, _ in self._step_times])
        msg = (f"avg {times.mean() * 1000:.2f}ms/step "
               f"(min {times.min() * 1000:.2f}, max {times.max() * 1000:.2f})")
        counts = [n for _, n in self._step_times if n]
        # fake-clock runs can record a 0 total — skip the rate, not crash
        if counts and times.sum() > 0:
            ips = sum(counts) / times.sum()
            msg += f", {ips:.1f} {unit}/s"
        return msg

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit: str = "ms"):
        """Host-annotation table (reference summary tables:
        profiler_statistic.py), plus the analysis diagnostics and
        static-cost tables, the device section (the attached device
        profiles, else the process's ``segment_records()``) and a
        runtime-metrics section."""
        self._events.extend(self._sink.drain())
        agg = {}
        for name, t0, t1, etype in self._events:
            key = (name, etype or "-")
            tot, cnt = agg.get(key, (0.0, 0))
            agg[key] = (tot + (t1 - t0), cnt + 1)
        scale = {"s": 1, "ms": 1e3, "us": 1e6}[time_unit]
        lines = [f"{'name':40s} {'type':>14s} {'calls':>8s} "
                 f"{'total(' + time_unit + ')':>14s}"]
        for (name, etype), (tot, cnt) in sorted(agg.items(),
                                                key=lambda kv: -kv[1][0]):
            lines.append(f"{name:40s} {str(etype):>14s} {cnt:8d} "
                         f"{tot * scale:14.3f}")
        if self._diagnostics:
            lines.append(format_diagnostics(self._diagnostics))
        for target, cost in self._cost_summaries:
            lines.append(f"-- static cost model: {target} " + "-" * 20)
            lines.append(cost.table())
        for result in self._device_profiles or self._segment_results():
            lines.append("-- device time / roofline " + "-" * 34)
            lines.append(result.table())
        metrics = self._format_metrics()
        if metrics:
            lines.append(metrics)
        table = "\n".join(lines)
        print(table)
        return table

    @staticmethod
    def _segment_results() -> list:
        """The process's measured segments as one result (none: [])."""
        from paddle_tpu_torch.observability.device_profiler import (
            AttributionResult, segment_records)
        rows = segment_records()
        if not rows:
            return []
        return [AttributionResult(segments=rows, peak_flops=float("nan"),
                                  hbm_bw=float("nan"),
                                  device=", ".join(sorted(
                                      {r.device for r in rows})))]

    @staticmethod
    def _format_metrics() -> str:
        """Runtime-counter section from the observability registry (the
        always-on telemetry the profiler window rode on top of).  Empty
        string when nothing was recorded."""
        from paddle_tpu_torch.observability import default_registry
        rows = []
        for fam in default_registry().collect():
            for s in fam["series"]:
                labels = ",".join(f"{k}={v}"
                                  for k, v in s["labels"].items())
                name = fam["name"] + (f"{{{labels}}}" if labels else "")
                if fam["kind"] == "histogram":
                    sm = s["summary"]
                    if not sm["count"]:
                        continue
                    rows.append(
                        f"{name:58s} n={int(sm['count']):<8d} "
                        f"p50={sm['p50'] * 1e3:.3f}ms "
                        f"p90={sm['p90'] * 1e3:.3f}ms "
                        f"p99={sm['p99'] * 1e3:.3f}ms")
                else:
                    v = s["value"]
                    if v != v or not v:   # skip NaN and zero-valued
                        continue
                    rows.append(f"{name:58s} {v:g}")
        if not rows:
            return ""
        return "\n".join(["-- runtime metrics (observability) " + "-" * 25]
                         + rows)

    def export(self, path: str, format: str = "json"):
        """Chrome-trace export: the recording windows' torch.profiler
        events (CPU operators, ``RecordEvent`` ranges as user
        annotations, the card's kernels) and the host events on a track
        of their own (``pid`` ``"host_events"``; ``cat`` carries the
        RecordEvent event_type)."""
        import json
        self._events.extend(self._sink.drain())
        trace = [{"name": n, "cat": str(etype or "host"), "ph": "X",
                  "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                  "pid": "host_events", "tid": 0}
                 for n, t0, t1, etype in self._events]
        with open(path, "w") as f:
            json.dump({"traceEvents": self.device_events() + trace}, f)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    def handler(prof: Profiler):
        import os
        os.makedirs(dir_name, exist_ok=True)
        prof.export(f"{dir_name}/{worker_name or 'worker'}.json")
    return handler


def load_profiler_result(path: str):
    import json
    with open(path) as f:
        return json.load(f)


@contextlib.contextmanager
def benchmark():
    """Throughput timing context (reference dataloader benchmark hooks).
    ``seconds`` is filled even when the body raises — a crashed run's
    partial timing is exactly what the post-mortem wants."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        box["seconds"] = time.perf_counter() - t0
