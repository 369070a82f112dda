"""Hierarchical span tracer — distributed traces over the hot paths (a
copy of ``paddle_tpu/observability/tracing.py``).

The metrics registry answers *whether* something drifted ("p99 step
latency rose"); this module answers *where the time went* ("the decode
chunk for request 17 in generation 3 stalled").  Spans form a tree:

    train.step                      serving.request
      ├─ train.h2d                    ├─ serving.prefill
      ├─ train.dispatch               ├─ serving.decode_step ×K
      │    └─ train.accum_microbatches└─ ...
      └─ train.guard

Every span carries ``trace_id`` / ``span_id`` / ``parent_id``.  Context
lives on a thread-local stack; worker threads (device prefetch, the
dataloader, async checkpoint writers) and the serving engine loop get
EXPLICIT propagation: capture :meth:`Tracer.current_context` where the
work is submitted, re-enter it with :meth:`Tracer.attach` where the work
runs.  Across hosts the context rides the TCPStore as a one-line header
(:func:`inject_context` / :func:`extract_context`) so an elastic
generation's workers parent their step spans under the manager's
generation span — one stitched timeline per job.

Head-based sampling: the decision is made ONCE, at trace-root creation
(``PADDLE_TPU_TRACE_SAMPLE``, default 1.0; 0 disables tracing
entirely), and children inherit it — a trace is recorded whole or not
at all, and an unsampled hot loop pays one float compare per root.

Finished spans land in a bounded ring (``PADDLE_TPU_TRACE_CAPACITY``,
default 4096 spans) and stream their ids into the flight recorder (every
``record()`` made under an active span is stamped with trace/span id),
so a crash dump and a trace can be joined after the fact.  Export is
Perfetto-compatible chrome-trace JSON (:meth:`Tracer.export_chrome`);
``RecordEvent`` host annotations from the profiler are delivered into
the active span (:func:`on_host_event`) so both views nest in one file.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = ["Span", "SpanContext", "Tracer", "tracer", "trace_span",
           "inject_context", "extract_context", "inject_spans",
           "extract_spans", "on_host_event"]

# perf_counter → wall-clock offset, fixed once per process: span
# timestamps are taken with the cheap monotonic clock but exported as
# wall time so traces from different hosts land on one (approximately
# aligned) timeline.
_EPOCH = time.time() - time.perf_counter()

_UNSET = object()


def _gen_id() -> str:
    return f"{random.getrandbits(64):016x}"


class SpanContext(NamedTuple):
    """The propagatable part of a span: what a child (possibly on
    another thread or host) needs to parent itself correctly."""

    trace_id: str
    span_id: str
    sampled: bool

    def to_header(self) -> str:
        """One-line wire form (the W3C ``traceparent`` idea, minus the
        version field): ``<trace_id>-<span_id>-<0|1>``."""
        return f"{self.trace_id}-{self.span_id}-{1 if self.sampled else 0}"

    @classmethod
    def from_header(cls, header: str) -> "SpanContext":
        trace_id, span_id, flag = header.strip().split("-")
        return cls(trace_id, span_id, flag == "1")


class Span:
    """One timed region.  Created via :meth:`Tracer.span` (context
    manager, auto-parented off the thread's stack) or
    :meth:`Tracer.start_span` (manual lifetime — long-running spans like
    a serving request that ends in a different call than it began)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "sampled", "attrs", "t0", "t1", "thread",
                 "_root_eligible")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str], sampled: bool,
                 attrs: Dict[str, Any], root_eligible: bool = True):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.attrs = attrs
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.thread = threading.current_thread().name
        self._root_eligible = root_eligible

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    def set_attribute(self, key: str, value):
        self.attrs[key] = value

    def end(self, end_time: Optional[float] = None):
        """Close the span (idempotent).  Only sampled spans are
        recorded; unsampled ones existed purely to carry context."""
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter() if end_time is None else end_time
        if self.sampled:
            self._tracer._record(self)


class _NoopSpan:
    """Returned when tracing is disabled (sample rate 0): every method
    is free and the context is None so nothing propagates."""

    __slots__ = ()
    name = trace_id = span_id = parent_id = None
    sampled = False
    attrs: Dict[str, Any] = {}
    context = None

    def set_attribute(self, key, value):
        pass

    def end(self, end_time=None):
        pass


_NOOP = _NoopSpan()


class Tracer:
    """Span factory + bounded store of finished spans.

    Instrumented modules share the process singleton (:func:`tracer`);
    tests may build private instances with explicit ``sample`` /
    ``capacity``."""

    def __init__(self, capacity: Optional[int] = None,
                 sample: Optional[float] = None):
        if capacity is None:
            capacity = int(os.environ.get("PADDLE_TPU_TRACE_CAPACITY",
                                          "4096"))
        if sample is None:
            sample = float(os.environ.get("PADDLE_TPU_TRACE_SAMPLE",
                                          "1.0"))
        self.sample = sample
        self.capacity = capacity
        self._spans: deque = deque(maxlen=capacity)    # finished, dicts
        self._roots: deque = deque(maxlen=512)         # finished roots
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ambient: Optional[SpanContext] = None    # process-level

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0

    # -- context ------------------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def current_context(self) -> Optional[SpanContext]:
        """Innermost context visible to this thread: active span, then
        a context attached with :meth:`attach`, then the process-level
        ambient context (set from a cross-host extract)."""
        s = self.current_span()
        if s is not None:
            return s.context
        base = getattr(self._tls, "base", None)
        if base is not None:
            return base
        return self._ambient

    def set_process_context(self, ctx: Optional[SpanContext]):
        """Process-wide parent for otherwise-rootless spans — a worker
        launched under an elastic generation calls this once with the
        context extracted from the store, and every step span it makes
        joins the manager's trace."""
        self._ambient = ctx

    @contextmanager
    def attach(self, ctx: Optional[SpanContext]):
        """Re-enter a captured context on another thread.  ``None`` is
        a no-op so callers can pass through an absent context."""
        if ctx is None:
            yield
            return
        prev = getattr(self._tls, "base", None)
        self._tls.base = ctx
        try:
            yield
        finally:
            self._tls.base = prev

    # -- span creation ------------------------------------------------------
    def start_span(self, name: str, parent=_UNSET,
                   root_eligible: bool = True, **attrs):
        """Begin a span with MANUAL lifetime (caller must ``end()``).
        ``parent`` may be a Span, a SpanContext, None (force a new
        trace), or omitted (inherit the thread's current context)."""
        if not self.enabled:
            return _NOOP
        if parent is _UNSET:
            pctx = self.current_context()
        elif isinstance(parent, Span):
            pctx = parent.context
        elif isinstance(parent, SpanContext):
            pctx = parent
        else:
            pctx = None  # None or a _NoopSpan: new root
        if pctx is not None:
            trace_id, parent_id, sampled = \
                pctx.trace_id, pctx.span_id, pctx.sampled
        else:
            trace_id, parent_id = _gen_id(), None
            sampled = self.sample >= 1.0 or random.random() < self.sample
        return Span(self, name, trace_id, _gen_id(), parent_id, sampled,
                    attrs, root_eligible)

    @contextmanager
    def span(self, name: str, parent=_UNSET, root_eligible: bool = True,
             **attrs):
        """Scoped span: pushed on this thread's stack (children created
        inside auto-parent to it), ended on exit; an escaping exception
        is stamped into the ``error`` attribute before re-raising."""
        s = self.start_span(name, parent=parent,
                            root_eligible=root_eligible, **attrs)
        if s is _NOOP:
            yield s
            return
        stack = self._stack()
        stack.append(s)
        try:
            yield s
        except BaseException as e:
            s.set_attribute("error", type(e).__name__)
            raise
        finally:
            stack.pop()
            s.end()

    def add_span(self, name: str, t0: float, t1: float, parent=_UNSET,
                 root_eligible: bool = True, **attrs):
        """Record an ALREADY-FINISHED region (perf_counter endpoints) —
        for work whose duration is known only after the fact, like the
        per-request slice of a fused decode chunk."""
        s = self.start_span(name, parent=parent,
                            root_eligible=root_eligible, **attrs)
        if s is _NOOP:
            return s
        s.t0 = t0
        s.end(end_time=t1)
        return s

    # -- storage / export ---------------------------------------------------
    def _record(self, span: Span):
        entry = {"name": span.name, "trace_id": span.trace_id,
                 "span_id": span.span_id, "parent_id": span.parent_id,
                 "t0": span.t0, "t1": span.t1, "thread": span.thread,
                 "attrs": span.attrs}
        with self._lock:
            self._spans.append(entry)
            if span.parent_id is None and span._root_eligible:
                self._roots.append(entry)

    def finished_spans(self, name: Optional[str] = None,
                       last: Optional[int] = None) -> List[dict]:
        with self._lock:
            items = list(self._spans)
        if name is not None:
            items = [s for s in items if s["name"] == name]
        if last is not None:
            items = items[-last:]
        return items

    def clear(self):
        with self._lock:
            self._spans.clear()
            self._roots.clear()

    def slowest_traces(self, n: int = 3,
                       max_spans: int = 100) -> List[dict]:
        """The ``n`` slowest recent traces (ranked by root-span wall
        time) with their retained spans — what the watchdog dumps next
        to the flight recorder on an SLO breach."""
        with self._lock:
            roots = list(self._roots)
            spans = list(self._spans)
        roots.sort(key=lambda r: r["t1"] - r["t0"], reverse=True)
        out = []
        for root in roots[:n]:
            members = [s for s in spans
                       if s["trace_id"] == root["trace_id"]]
            out.append({"trace_id": root["trace_id"],
                        "root": root["name"],
                        "seconds": root["t1"] - root["t0"],
                        "spans": members[:max_spans]})
        return out

    def spans_payload(self, last: Optional[int] = None) -> List[dict]:
        """Finished spans with WALL-CLOCK endpoints (``t0``/``t1`` in
        epoch seconds) — the shippable form of the ring: another host's
        aggregator can merge payloads from many processes onto one
        timeline without knowing each sender's ``perf_counter`` origin
        (see :func:`inject_spans` / ``observability.fleet``)."""
        out = []
        for s in self.finished_spans(last=last):
            e = dict(s)
            e["t0"] = s["t0"] + _EPOCH
            e["t1"] = s["t1"] + _EPOCH
            out.append(e)
        return out

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """Perfetto/chrome-trace JSON of every retained span.  ``ts`` is
        wall time (see ``_EPOCH``) so per-host exports from one job can
        be concatenated into a single timeline; ``args`` carries
        trace/span/parent ids for Perfetto queries and for joining with
        flight-recorder events."""
        spans = self.finished_spans()
        pid = int(os.environ.get("PROCESS_ID",
                                 os.environ.get("PADDLE_TRAINER_ID",
                                                os.getpid())))
        tids = {name: i for i, name in enumerate(
            sorted({s["thread"] for s in spans}))}
        events: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"paddle_tpu host {os.getpid()}"}}]
        for tname, tid in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        for s in spans:
            attrs = dict(s["attrs"])
            cat = str(attrs.pop("cat", "span"))
            events.append({
                "name": s["name"], "cat": cat, "ph": "X",
                "ts": (s["t0"] + _EPOCH) * 1e6,
                "dur": (s["t1"] - s["t0"]) * 1e6,
                "pid": pid, "tid": tids[s["thread"]],
                "args": {"trace_id": s["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"], **attrs}})
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path:
            with open(path, "w") as f:
                json.dump(trace, f, default=str)
        return trace

    # flight-recorder context provider (installed by tracer())
    def _recorder_ids(self):
        s = self.current_span()
        if s is not None and s.sampled:
            return s.trace_id, s.span_id
        return None


_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def tracer() -> Tracer:
    """The process-wide tracer every built-in instrument writes to.
    First use wires it into the flight recorder so events recorded
    under an active span are stamped with trace/span ids."""
    global _TRACER
    if _TRACER is None:
        with _TRACER_LOCK:
            if _TRACER is None:
                t = Tracer()
                try:
                    from paddle_tpu_torch.observability.recorder import \
                        flight_recorder
                    flight_recorder().set_context_provider(t._recorder_ids)
                except Exception:
                    pass
                _TRACER = t
    return _TRACER


def trace_span(name: str, **attrs):
    """Convenience: ``with trace_span("my.phase"): ...`` on the process
    tracer."""
    return tracer().span(name, **attrs)


def on_host_event(name: str, t0: float, t1: float, event_type=None):
    """Profiler → tracer unification: a finished ``RecordEvent`` host
    annotation becomes a child span of whatever span is active on this
    thread, so the chrome export shows annotations nested under the
    step/request structure.  No tracer is created just for this — if
    nothing else started one, annotations stay profiler-only."""
    t = _TRACER
    if t is None or not t.enabled:
        return
    parent = t.current_span()
    if parent is None or not parent.sampled:
        return
    t.add_span(name, t0, t1, parent=parent, root_eligible=False,
               cat=str(event_type or "host"))


# -- cross-host propagation over a store-like carrier -----------------------
def inject_context(store, key: str = "trace/ctx",
                   ctx: Optional[SpanContext] = None) -> bool:
    """Publish a span context under ``key`` on a TCPStore-like carrier
    (anything with ``set``).  Returns True when something was written —
    False when there is no active sampled-or-not context to send."""
    if ctx is None:
        ctx = tracer().current_context()
    if ctx is None:
        return False
    store.set(key, ctx.to_header().encode())
    return True


def extract_context(store, key: str = "trace/ctx"
                    ) -> Optional[SpanContext]:
    """Read a span context previously injected under ``key``; None when
    the key is absent or unparseable (a worker must come up fine when
    nobody is tracing)."""
    try:
        if hasattr(store, "check") and not store.check(key):
            return None
        raw = store.get(key, wait=False)
        if isinstance(raw, bytes):
            raw = raw.decode()
        return SpanContext.from_header(raw)
    except Exception:
        return None


# -- span-ring shipping (fleet trace stitching) ------------------------------
def inject_spans(store, key: str, host: Optional[str] = None,
                 tracer_: Optional[Tracer] = None,
                 last: Optional[int] = None) -> int:
    """Publish this process's bounded span ring under ``key`` on a
    store-like carrier — the sibling of :func:`inject_context` for whole
    rings instead of one context.  The payload is a versioned JSON blob
    of wall-clock spans (``spans_payload``), bounded to ``last`` spans
    (``PADDLE_TPU_FLEET_TRACE_SPANS``, default 1024 — the TCPStore value
    buffer is 1 MiB).  Returns the number of spans shipped."""
    t = tracer_ if tracer_ is not None else tracer()
    if last is None:
        last = int(os.environ.get("PADDLE_TPU_FLEET_TRACE_SPANS", "1024"))
    spans = t.spans_payload(last=last)
    payload = {"schema": 1, "host": host, "pid": os.getpid(),
               "spans": spans}
    store.set(key, json.dumps(payload, default=str).encode())
    return len(spans)


def extract_spans(store, key: str) -> Optional[dict]:
    """Read a span-ring payload published by :func:`inject_spans`; None
    when the key is absent or unparseable (a partially-written or
    old-schema blob must degrade to 'no trace from that host', never
    crash the aggregator)."""
    try:
        if hasattr(store, "check") and not store.check(key):
            return None
        raw = store.get(key, wait=False)
        if isinstance(raw, bytes):
            raw = raw.decode()
        payload = json.loads(raw)
        if payload.get("schema") != 1 or \
                not isinstance(payload.get("spans"), list):
            return None
        return payload
    except Exception:
        return None
