"""Flight recorder: bounded ring buffer of structured runtime events (a
copy of ``paddle_tpu/observability/recorder.py``).

Post-mortem analog of an aircraft FDR: instrumented loops (TrainStep,
the serving engine, elastic generations, checkpoint save/restore)
continuously append small structured events into a fixed-capacity ring;
when an uncaught exception escapes an ``instrumented(...)`` scope the
recorder dumps the last N events — the run's final seconds — to stderr
(and to ``PADDLE_TPU_FLIGHT_RECORDER_PATH`` when set) before the
exception propagates.  A dead run then leaves behind *what it was
doing*, not just a traceback.

Events are plain tuples ``(seq, t_wall, kind, fields)`` — one small
dict per event, no formatting, no I/O on the hot path.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import List, Optional

__all__ = ["FlightRecorder", "flight_recorder"]


class FlightRecorder:
    def __init__(self, capacity: int = 1024, clock=time.time):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._clock = clock
        self._ctx_provider = None

    def set_context_provider(self, fn):
        """Install a ``() -> (trace_id, span_id) | None`` callback (the
        tracer registers one): every event recorded while a sampled span
        is active on the calling thread is stamped with its ids, so a
        dump and a trace can be joined post-mortem.  Costs one None
        check per record() until someone installs it."""
        self._ctx_provider = fn

    def record(self, kind: str, **fields):
        """Append one event.  O(1), allocation = one tuple + the fields
        dict the caller already built."""
        prov = self._ctx_provider
        if prov is not None:
            try:
                ctx = prov()
            except Exception:
                ctx = None
            if ctx is not None:
                fields.setdefault("trace_id", ctx[0])
                fields.setdefault("span_id", ctx[1])
        with self._lock:
            self._seq += 1
            self._ring.append((self._seq, self._clock(), kind, fields))

    def __len__(self):
        return len(self._ring)

    @property
    def total_recorded(self) -> int:
        """Events ever recorded (>= len() once the ring has wrapped)."""
        return self._seq

    def events(self, last: Optional[int] = None) -> List[dict]:
        """The newest ``last`` events (all retained when None), oldest
        first, as dicts."""
        with self._lock:
            items = list(self._ring)
        if last is not None:
            items = items[-last:]
        return [{"seq": s, "time": t, "kind": k, **f}
                for s, t, k, f in items]

    def snapshot(self, n: Optional[int] = None) -> List[dict]:
        """The last ``n`` events (all retained when None) WITHOUT
        clearing or otherwise disturbing the ring — the read a watchdog
        or a debugger wants mid-flight.  Alias of :meth:`events` with
        the non-destructive contract in the name."""
        return self.events(last=n)

    def clear(self):
        with self._lock:
            self._ring.clear()

    def dump(self, file=None, last: Optional[int] = None,
             reason: str = "") -> List[dict]:
        """Write the retained events as JSONL (newest last) and return
        them.  Default target is stderr; a path string opens/appends."""
        events = self.events(last)
        close = False
        if file is None:
            file = sys.stderr
        elif isinstance(file, str):
            file = open(file, "a")
            close = True
        try:
            header = {"flight_recorder": {
                "reason": reason or "dump", "retained": len(events),
                "total_recorded": self._seq, "capacity": self.capacity}}
            file.write(json.dumps(header) + "\n")
            for ev in events:
                file.write(json.dumps(ev, default=_best_effort) + "\n")
            file.flush()
        finally:
            if close:
                file.close()
        return events

    @contextmanager
    def instrumented(self, scope: str, **fields):
        """Run a loop body under crash coverage: an escaping exception
        records a ``crash`` event and auto-fires ``dump()`` (stderr +
        the PADDLE_TPU_FLIGHT_RECORDER_PATH file when set), then
        re-raises.  Normal exit costs one try/except frame."""
        try:
            yield self
        except BaseException as e:
            self.record("crash", scope=scope, error=type(e).__name__,
                        message=str(e)[:500], **fields)
            try:
                self.dump(reason=f"uncaught {type(e).__name__} in {scope}")
                path = os.environ.get("PADDLE_TPU_FLIGHT_RECORDER_PATH")
                if path:
                    self.dump(file=path,
                              reason=f"uncaught {type(e).__name__} "
                                     f"in {scope}")
            except Exception:
                pass  # the dump must never mask the real failure
            raise


def _best_effort(obj):
    try:
        return float(obj)
    except Exception:
        return repr(obj)


_DEFAULT = FlightRecorder(
    capacity=int(os.environ.get("PADDLE_TPU_FLIGHT_RECORDER_CAPACITY",
                                "1024")))


def flight_recorder() -> FlightRecorder:
    """The process-wide recorder every built-in instrument writes to."""
    return _DEFAULT
