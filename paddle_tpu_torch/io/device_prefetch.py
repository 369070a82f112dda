"""Device prefetch (``paddle_tpu/io/device_prefetch.py``): host-to-device
transfer one or ``depth`` batches ahead of the training loop.

A background thread takes batches from the source (dicts, tuples or
lists of numpy arrays, tensors or numbers) and places each on the device.
On a CUDA device every array is staged in pinned host memory and copied
on a side CUDA stream, with an event recorded after the copies; the
consumer's current stream waits on that event when the batch is handed
over (no host synchronisation), and each tensor is marked as used on
that stream, so the allocator does not reuse its memory while the step
still reads it.  On the CPU a batch is converted to tensors.

    for batch in device_prefetch(loader, depth=2):
        loss = step(batch)

Telemetry (``io/device_prefetch.py:17-60``): ``paddle_tpu_prefetch_depth``
(a pull gauge: the batches buffered now) and
``paddle_tpu_prefetch_batches_total``; each placement runs under a
``prefetch.place`` span on the constructing thread's trace.

``sharding=`` / ``mesh=`` (sharded placement) wait for meshes
(ROADMAP.md, queue 1, item 8)."""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.state import resolve_device

__all__ = ["DevicePrefetchIterator", "device_prefetch", "as_tensor"]


def _prefetch_metrics():
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    return {
        "depth": reg.gauge(
            "paddle_tpu_prefetch_depth",
            "device-resident batches currently buffered ahead of the "
            "training loop"),
        "batches": reg.counter(
            "paddle_tpu_prefetch_batches_total",
            "batches moved host→device by the prefetch thread"),
    }


def _map(fn, batch):
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _tensors(batch):
    out = []
    _map(lambda t: out.append(t) if torch.is_tensor(t) else None, batch)
    return out


def as_tensor(a) -> torch.Tensor:
    """A tensor as it is; numpy arrays and numbers as CPU tensors of
    their own shape and dtype (copied where numpy's are not contiguous
    or not writeable)."""
    if torch.is_tensor(a):
        return a
    arr = np.asarray(a)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()
    return torch.from_numpy(arr)


class DevicePrefetchIterator:
    """Iterates ``src``, placing every batch on ``device`` (``cuda``
    unless the caller asks for another) from a background thread
    ``depth`` batches ahead of the consumer."""

    _STOP = object()

    def __init__(self, src: Iterable, depth: int = 2, sharding=None,
                 mesh=None, spec=None, device=None):
        if sharding is not None or mesh is not None or spec is not None:
            raise NotImplementedError(
                "device_prefetch with sharding= or mesh= is not ported yet "
                "(ROADMAP.md, queue 1, item 8)")
        self._device = resolve_device(device)
        self._stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._done = False
        self._metrics = _prefetch_metrics()
        self._metrics["depth"].set_function(self._q.qsize)
        # the constructing thread's span context, so the placements
        # traced on the background thread stay in the caller's trace
        from paddle_tpu_torch.observability.tracing import tracer
        self._tracer = tracer()
        self._ctx = self._tracer.current_context()
        self._thread = threading.Thread(target=self._worker, args=(src,),
                                        daemon=True,
                                        name="paddle_tpu_torch-prefetch")
        self._thread.start()

    def _place(self, batch):
        """``(placed batch, event or None)``."""
        if self._stream is None:
            return _map(lambda a: as_tensor(a).to(self._device), batch), None
        with torch.cuda.stream(self._stream):
            placed = _map(lambda a: as_tensor(a).pin_memory().to(
                self._device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return placed, event

    def _worker(self, src):
        it = iter(src)
        try:
            with self._tracer.attach(self._ctx):
                self._worker_loop(it)
        except BaseException as e:     # handed to the consumer
            self._exc = e
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
            # the sentinel must not be dropped on a full queue (the
            # consumer would block forever); give up only once closed
            while True:
                try:
                    self._q.put(self._STOP, timeout=0.05)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def _worker_loop(self, it):
        for item in it:
            if self._stop.is_set():
                break
            with self._tracer.span("prefetch.place", root_eligible=False):
                placed = self._place(item)
            self._metrics["batches"].inc()
            while not self._stop.is_set():
                try:
                    self._q.put(placed, timeout=0.05)
                    break
                except queue.Full:
                    continue
            else:
                break

    def __iter__(self) -> Iterator:
        return self

    def __next__(self) -> Any:
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._STOP:
            self._done = True
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(batch):
                t.record_stream(stream)
        return batch

    def close(self):
        """Stop the prefetch thread and drop buffered batches; safe to
        call more than once, and run on a ``with`` block's exit."""
        self._stop.set()
        while True:     # unblock a worker stuck on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def device_prefetch(src: Iterable, depth: int = 2, sharding=None,
                    mesh=None, spec=None, device=None) -> \
        DevicePrefetchIterator:
    """Wrap any batch iterable so the host-to-device transfer happens
    ``depth`` batches ahead, on a background thread."""
    return DevicePrefetchIterator(src, depth=depth, sharding=sharding,
                                  mesh=mesh, spec=spec, device=device)
