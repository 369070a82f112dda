"""DataLoader (``paddle_tpu/io/dataloader.py``): host-side batching,
a background prefetch thread and an optional process pool.

Batches are numpy, as in the JAX package (``default_collate_fn`` stacks
samples structure by structure; tensors in samples are read as numpy):
the consumer (hapi's ``Model``, ``TrainStep``) puts them on its device.
A background thread keeps ``prefetch_factor`` batches ready; it has an
explicit lifecycle (``close()``, also at context exit and collection).

``num_workers > 0`` maps index batches over a ``ProcessPoolExecutor``
of that many processes, in order, ``num_workers * prefetch_factor``
batches in flight.  The workers start from a ``forkserver``, never by
``fork`` of the loader's process: on the card that process has
initialised CUDA and runs the prefetch thread, and a forked child of
such a process may hang on a lock another thread held.  The fork server
is a fresh interpreter (started once a process, with this module and so
torch and the port imported), so each pool's workers start in a fraction
of a second; they touch no CUDA and import the main module as ``spawn``
does (a script that makes a pool needs the ``if __name__ ==
"__main__"`` guard), and the dataset and ``collate_fn`` must be picklable
(defined at a module's top level).  Each worker receives them
once, at its start (the JAX package sends the dataset with every
batch), and ``get_worker_info()`` in a worker names it.  With
``use_shared_memory`` (the default) each array of 64 KB or more comes
back through a POSIX shared-memory block (``/dev/shm``) instead of the
pool's pipe, copied out once by the consumer; where the filesystem lacks
room, through the pipe (section ``worker batches`` below).  A dead worker
(killed, crashed in native code) and a batch past ``timeout`` seconds
raise a ``RuntimeError`` naming the worker processes.  ``close()`` shuts
the pool down.  Worker seeds are ``base + id``, the base drawn from the
port's CPU generator."""

from __future__ import annotations

import os
import queue
import shutil
import threading
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from paddle_tpu_torch.io.dataset import (BatchSampler, Dataset,
                                         IterableDataset, _host_seed)

__all__ = ["DataLoader", "default_collate_fn", "get_worker_info",
           "WorkerInfo"]

_NO_NUMPY = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def default_collate_fn(batch):
    """Stack a list of samples into numpy batch arrays, structure by
    structure (tuples, lists, dicts).  Tensor samples are stacked on the
    CPU and given as numpy; bfloat16 / float8 ones, which numpy cannot
    hold, as a CPU tensor."""
    sample = batch[0]
    if isinstance(sample, (tuple, list)):
        return type(sample)(default_collate_fn([b[i] for b in batch])
                            for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch])
                for k in sample}
    if torch.is_tensor(sample):
        out = torch.stack([s.detach().to("cpu") for s in batch])
        return out if out.dtype in _NO_NUMPY else out.numpy()
    arr = np.asarray(sample)
    if arr.dtype == object:
        return batch
    return np.stack([np.asarray(s) for s in batch])


class _PrefetchIterator:
    """Background-thread prefetch with EXPLICIT lifecycle: a consumer
    that stops iterating early (break / exception / GC) must not leave
    the thread parked on a full queue or the pool holding in-flight
    futures — ``close()`` (also fired by ``__del__`` and context exit)
    stops the worker and finalizes the underlying generator, which
    unwinds its ``finally`` blocks (future cancellation lives there)."""

    _STOP = object()

    def __init__(self, gen_fn: Callable[[], Iterable], depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._exc = None
        self._done = False
        self._stop = threading.Event()
        # explicit context propagation: batch-assembly spans recorded on
        # the prefetch thread stay part of the constructing trace
        from paddle_tpu_torch.observability.tracing import tracer
        self._tracer = tracer()
        self._ctx = self._tracer.current_context()

        def worker():
            gen = gen_fn()
            it = iter(gen)
            try:
                with self._tracer.attach(self._ctx):
                    while not self._stop.is_set():
                        # batch assembly (sampling + __getitem__ +
                        # collate all run inside next()) gets its own
                        # span; the sentinel default sidesteps
                        # StopIteration-through-contextmanager
                        with self._tracer.span("dataloader.batch",
                                               root_eligible=False):
                            item = next(it, self._STOP)
                        if item is self._STOP:
                            break
                        while not self._stop.is_set():
                            try:
                                self._q.put(item, timeout=0.05)
                                break
                            except queue.Full:
                                continue
                        else:
                            break
            except BaseException as e:  # propagate to consumer
                self._exc = e
            finally:
                if hasattr(gen, "close"):
                    try:
                        gen.close()   # runs the generator's finally blocks
                    except Exception:
                        pass
                # the sentinel must not be dropped on a full queue (the
                # consumer would block forever); only give up once the
                # consumer has explicitly closed
                while True:
                    try:
                        self._q.put(self._STOP, timeout=0.05)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            break

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="paddle_tpu_torch-dataloader-"
                                             "prefetch")
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if getattr(self, "_done", False):
            raise StopIteration  # the single _STOP sentinel was consumed
        item = self._q.get()
        if item is self._STOP:
            self._done = True
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        """Stop the prefetch thread, finalize the source generator, and
        drop buffered batches.  Idempotent."""
        self._stop.set()
        while True:  # unblock a worker stuck on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        thread = getattr(self, "_thread", None)
        if thread is not None and thread.is_alive():
            thread.join(timeout=5.0)
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list: bool = True, batch_sampler=None,
                 batch_size: Optional[int] = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Callable = None,
                 num_workers: int = 0, use_buffer_reader: bool = True,
                 prefetch_factor: int = 2, use_shared_memory: bool = True,
                 timeout: int = 0, worker_init_fn=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(1, prefetch_factor)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = bool(use_shared_memory)
        # per-batch result deadline (seconds; 0 = wait forever, the
        # reference's semantics): a worker stuck in __getitem__ becomes a
        # clear RuntimeError instead of an indefinite consumer hang
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)

        if self._iterable_mode:
            if batch_sampler is not None:
                raise ValueError("batch_sampler invalid for IterableDataset")
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            self.batch_size = batch_size
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last) if batch_size is not None else None

        self._pool = None
        self._counter = None
        self._inflight = set()       # worker futures not yet consumed
        self._stuck = False          # a batch passed `timeout`

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    # -- batch generation ----------------------------------------------------
    def _fetch(self, indices):
        samples = [self.dataset[i] for i in indices]
        return self.collate_fn(samples)

    def _result(self, fut):
        """One pool future → batch, with worker death surfaced as a
        clear RuntimeError naming the dead worker processes — a crashed
        worker (OOM-killed, segfaulted C extension, os._exit) otherwise
        reads as either an opaque BrokenProcessPool or, in naive queue
        designs, an indefinite consumer hang."""
        import concurrent.futures as cf
        from concurrent.futures.process import BrokenProcessPool
        alive_before = self._worker_pids()
        try:
            batch = fut.result(timeout=self.timeout or None)
            self._inflight.discard(fut)
            return _from_shared(batch)
        except cf.TimeoutError:
            self._stuck = True
            raise RuntimeError(
                f"DataLoader batch not produced within timeout="
                f"{self.timeout}s (worker pids {sorted(alive_before)}) — "
                "a worker is stuck in dataset.__getitem__/collate_fn")
        except BrokenProcessPool as e:
            dead = self._dead_workers()
            self._pool = None  # broken pools cannot be reused
            who = f"worker pid(s) {dead}" if dead else \
                f"one of worker pids {sorted(alive_before)}"
            raise RuntimeError(
                f"DataLoader worker process died: {who} terminated "
                f"abruptly (num_workers={self.num_workers}); look for "
                "OOM kills or native crashes in dataset code") from e

    def _worker_pids(self):
        pool = self._pool
        try:
            return set(pool._processes or {}) if pool is not None else set()
        except Exception:
            return set()

    def _dead_workers(self):
        pool = self._pool
        try:
            return sorted(pid for pid, p in (pool._processes or {}).items()
                          if not p.is_alive())
        except Exception:
            return []

    def _submit(self, indices):
        """Submit one index batch, translating a broken pool the same
        way ``_result`` does — a worker that died between batches breaks
        the pool before any future exists, and the raw
        ``BrokenProcessPool`` from ``submit`` named nobody."""
        from concurrent.futures.process import BrokenProcessPool
        try:
            fut = self._pool.submit(_fetch_worker, indices,
                                    self.use_shared_memory)
            self._inflight.add(fut)
            return fut
        except BrokenProcessPool as e:
            dead = self._dead_workers()
            self._pool = None  # broken pools cannot be reused
            who = f"worker pid(s) {dead}" if dead else "a worker"
            raise RuntimeError(
                f"DataLoader worker process died: {who} terminated "
                f"abruptly (num_workers={self.num_workers}); look for "
                "OOM kills or native crashes in dataset code") from e

    def _gen_map_style(self):
        if self.num_workers > 0 and self.batch_sampler is not None:
            # process pool maps index batches; order preserved
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            if self._pool is None:
                ctx = multiprocessing.get_context("forkserver")
                ctx.set_forkserver_preload([__name__])
                # kept until close(), which waits for every worker: one
                # still starting reads it by name
                counter = self._counter = ctx.Value("i", 0)
                self._pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=ctx,
                    initializer=_worker_init,
                    initargs=(counter, self.num_workers, _host_seed(),
                              self.dataset, self.collate_fn))
            inflight = self.num_workers * self.prefetch_factor
            it = iter(self.batch_sampler)
            import collections
            dq = collections.deque()
            try:
                for _ in range(inflight):
                    try:
                        dq.append(self._submit(next(it)))
                    except StopIteration:
                        break
                while dq:
                    fut = dq.popleft()
                    yield self._result(fut)
                    try:
                        dq.append(self._submit(next(it)))
                    except StopIteration:
                        pass
            finally:
                # generator finalized early (consumer broke out): drop
                # queued work so the pool drains instead of grinding
                # through the whole epoch
                for fut in dq:
                    fut.cancel()
        else:
            if self.batch_sampler is None:
                for i in range(len(self.dataset)):
                    yield self.dataset[i]
            else:
                for indices in self.batch_sampler:
                    yield self._fetch(indices)

    def _gen_iterable(self):
        if self.batch_size is None:
            yield from self.dataset
            return
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def __iter__(self):
        gen = self._gen_iterable if self._iterable_mode \
            else self._gen_map_style
        if self.use_buffer_reader:
            return _PrefetchIterator(gen, depth=self.prefetch_factor)
        return iter(gen())

    def close(self):
        """Shut down the worker pool, waiting for its processes to exit
        (queued batches are cancelled), except after a batch passed
        `timeout`: a stuck worker is left to finish on its own.  Live
        ``_PrefetchIterator``s hold their own ``close()``; call both when
        tearing down mid-epoch."""
        if self._pool is not None:
            self._pool.shutdown(wait=not self._stuck, cancel_futures=True)
            self._pool = None
        # batches made but never read: free their shared-memory blocks
        for fut in self._inflight:
            if fut.done() and not fut.cancelled() and \
                    fut.exception() is None:
                _from_shared(fut.result(), keep=False)
        self._inflight = set()
        self._counter = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


from collections import namedtuple

WorkerInfo = namedtuple("WorkerInfo", ["id", "num_workers", "seed",
                                       "dataset"])
_worker_info = None


def get_worker_info():
    """In a map-style DataLoader's worker process: that worker's info
    (id fixed for the process, seed = base + id, the dataset); in the
    main process None.  Iterable datasets iterate in the main process,
    so sharding by worker id is a map-style concern only."""
    return _worker_info


_worker_state = None


def _worker_init(counter, num_workers, base_seed, dataset, collate_fn):
    """The pool's initializer: runs once a worker process, so the id is
    the process's own, and keeps the dataset and collate function."""
    global _worker_info, _worker_state
    with counter.get_lock():
        wid = counter.value
        counter.value += 1
    _worker_info = WorkerInfo(id=wid, num_workers=num_workers,
                              seed=base_seed + wid, dataset=dataset)
    _worker_state = (dataset, collate_fn)


def _fetch_worker(indices, use_shared_memory):
    # the fault point runs in the worker (the registry reads
    # PADDLE_TPU_FAULTS there): action=exit is a real worker death, a
    # raise travels back through the future
    from paddle_tpu_torch.robustness import fault_point
    fault_point("io.dataloader.worker", pid=os.getpid())
    dataset, collate_fn = _worker_state
    batch = collate_fn([dataset[i] for i in indices])
    return _to_shared(batch) if use_shared_memory else batch


# -- worker batches through shared memory -----------------------------------
#
# A batch pickled through the pool's pipe arrives in 64 KB reads on the
# pool's result thread, each of which waits for the GIL while the training
# loop holds it: a 38.5 MB image batch took ~0.6 s so.  A worker instead
# leaves each large array in a POSIX shared-memory block and sends its
# name; the consumer copies it out once and unlinks the block.

_SHM_MIN = 1 << 16          # arrays of at least these bytes go by block
_SHM_DIR = "/dev/shm"


class _Shared:
    """An array a worker left in the shared-memory block `name`."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype


def _shm_room(nbytes) -> bool:
    """Whether the shared-memory filesystem has room for a block, with a
    margin (a write past a full tmpfs kills the writer)."""
    try:
        return shutil.disk_usage(_SHM_DIR).free > 2 * nbytes
    except OSError:
        return False


def _to_shared(obj):
    """`obj` with each large plain numpy array moved into a new
    shared-memory block (left where there is no room)."""
    if isinstance(obj, dict):
        return {k: _to_shared(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_shared(v) for v in obj)
    if not (isinstance(obj, np.ndarray) and obj.nbytes >= _SHM_MIN and
            obj.dtype.kind in "biufc" and _shm_room(obj.nbytes)):
        return obj
    from multiprocessing import resource_tracker, shared_memory
    shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
    try:
        np.ndarray(obj.shape, obj.dtype, buffer=shm.buf)[...] = obj
        # the consumer unlinks the block; this process gives up its claim
        resource_tracker.unregister(shm._name, "shared_memory")
        return _Shared(shm.name, obj.shape, obj.dtype.str)
    finally:
        shm.close()


def _from_shared(obj, keep=True):
    """`obj` with each block copied out (with `keep`) and unlinked."""
    if isinstance(obj, _Shared):
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=obj.name)
        try:
            if keep:
                return np.ndarray(obj.shape, np.dtype(obj.dtype),
                                  buffer=shm.buf).copy()
            return None
        finally:
            shm.close()
            shm.unlink()
    if isinstance(obj, dict):
        return {k: _from_shared(v, keep) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_from_shared(v, keep) for v in obj)
    return obj
