"""TCPStore — the native rendezvous key/value store
(``paddle_tpu/distributed/tcp_store.py``), ctypes over
``csrc/store/tcp_store.cpp``.

The same server and wire protocol as the JAX package's (one source, built
for the port by ``utils.cpp_extension.load_native``), so a client of
either package talks to a server of either.  The store carries the
control plane: the fleet's metrics and handoffs, peer snapshots of the
training state (``robustness/recovery.py``), SDC digests and the
quarantine roster.

Every client socket gets a receive and send timeout of the store's
``timeout`` (at most 300 s): an op whose server stopped answering fails
with a ``RuntimeError`` instead of blocking its thread for ever.  The
parallel fetch threads of :meth:`TCPStore.get_many` /
:meth:`TCPStore.get_many_into` are daemons, joined with that timeout."""

from __future__ import annotations

import ctypes
import os
import random
import socket
import struct
import threading
import time
import uuid
from typing import Optional

__all__ = ["TCPStore"]

# per-process op-id namespace for retry-safe adds: the nonce makes tokens
# unique across unrelated processes, the sequence across calls
_ADD_NONCE = uuid.uuid4().hex[:12]
_ADD_SEQ = 0
_ADD_SEQ_LOCK = threading.Lock()
_OP_TIMEOUT_CAP = 300.0


def _store_metrics():
    """Retry telemetry: a rising connect-retry counter during job start
    is the 'rank-0 store is slow' signature; op retries after that point
    mean the store host is struggling."""
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    return {
        "connect_retries": reg.counter(
            "paddle_tpu_tcp_store_connect_retries_total",
            "TCPStore client connect attempts that failed and were "
            "retried with backoff"),
        "op_retries": reg.counter(
            "paddle_tpu_tcp_store_op_retries_total",
            "TCPStore operations that failed transiently and were "
            "retried", labelnames=("op",)),
    }


_LIB = None


def _lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    from paddle_tpu_torch.utils.cpp_extension import load_native
    lib = load_native("store", required_symbol="tcpstore_add_tok")
    lib.tcpstore_server_start.restype = ctypes.c_void_p
    lib.tcpstore_server_start.argtypes = [ctypes.c_int]
    lib.tcpstore_server_stop.argtypes = [ctypes.c_void_p]
    lib.tcpstore_connect.restype = ctypes.c_int
    lib.tcpstore_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int]
    lib.tcpstore_set.restype = ctypes.c_int
    lib.tcpstore_set.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.tcpstore_get.restype = ctypes.c_int
    lib.tcpstore_get.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.tcpstore_add.restype = ctypes.c_int64
    lib.tcpstore_add.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_int64]
    lib.tcpstore_add_tok.restype = ctypes.c_int64
    lib.tcpstore_add_tok.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_int64, ctypes.c_char_p]
    lib.tcpstore_check.restype = ctypes.c_int
    lib.tcpstore_check.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.tcpstore_server_wait_clients.restype = ctypes.c_int
    lib.tcpstore_server_wait_clients.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_int, ctypes.c_int]
    lib.tcpstore_close.argtypes = [ctypes.c_int]
    _LIB = lib
    return lib


def _bound_socket(fd: int, seconds: float):
    """Give client socket `fd` a receive and send timeout (the options
    belong to the socket, so setting them through a duplicate of the
    descriptor binds the C library's own calls)."""
    s = socket.socket(fileno=os.dup(fd))
    try:
        sec = int(seconds)
        tv = struct.pack("ll", sec, int((seconds - sec) * 1e6))
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
    finally:
        s.close()


class TCPStore:
    """API parity with the reference TCPStore: set/get/add/wait + barrier.

    is_master=True starts the native server in-process (host 0); every
    process (master included) connects a client."""

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: float = 300.0,
                 connect_timeout: Optional[float] = None):
        self._lib = _lib()
        self._server = None
        self._fd = -1
        self.host = host
        self.port = port
        self.world_size = world_size
        self.timeout = timeout
        self._op_timeout = max(0.05, min(float(timeout), _OP_TIMEOUT_CAP))
        self._metrics = _store_metrics()
        # extra client sockets for get_many: parallel bulk reads (peer
        # state snapshots) pipeline the per-get round trip; ctypes
        # releases the GIL during the blocking C recv, so threads on
        # separate descriptors overlap
        self._bulk_fds = []
        self._bulk_lock = threading.Lock()
        from paddle_tpu_torch.observability.tracing import tracer
        # store ops get spans (root_eligible=False: a bare heartbeat set()
        # outside any trace must not crowd the slow-trace table)
        self._tracer = tracer()
        if is_master:
            self._server = self._lib.tcpstore_server_start(port)
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot bind port {port}")
        # connect with exponential backoff + jitter: joining ranks beat a
        # slow-starting rank-0 store to the socket all the time; the
        # master connecting to its own in-process server skips the
        # patience (a local refusal there is a real bug)
        budget = 0.5 if is_master else (
            timeout if connect_timeout is None else connect_timeout)
        deadline = time.monotonic() + budget
        delay = 0.05
        from paddle_tpu_torch.robustness import fault_fires
        while True:
            fd = -2 if fault_fires("tcp_store.connect", host=host,
                                   port=port) else \
                self._lib.tcpstore_connect(
                    host.encode(), port,
                    int(max(0.05, deadline - time.monotonic()) * 1000))
            if fd >= 0:
                _bound_socket(fd, self._op_timeout)
                self._fd = fd
                break
            if time.monotonic() + delay > deadline:
                self._stop_server()
                raise RuntimeError(
                    f"TCPStore: cannot connect {host}:{port} after "
                    f"{budget:.1f}s of retries")
            self._metrics["connect_retries"].inc()
            time.sleep(delay * (1.0 + random.random() * 0.25))
            delay = min(delay * 2, 2.0)

    def _retry_op(self, op: str, attempt, attempts: int = 3):
        """Bounded retry with backoff.  ``add`` rides an op-id token the
        server deduplicates (a resent token replays the recorded result),
        so the same retry covers it."""
        from paddle_tpu_torch.robustness import fault_point
        delay = 0.02
        for i in range(attempts):
            try:
                fault_point("tcp_store.op", op=op, attempt=i)
                return attempt()
            except RuntimeError:
                if i == attempts - 1:
                    raise
                self._metrics["op_retries"].labels(op=op).inc()
                time.sleep(delay * (1.0 + random.random() * 0.25))
                delay *= 2

    def set(self, key: str, value):
        if isinstance(value, (bytearray, memoryview)):
            value = bytes(value)
        data = value if isinstance(value, bytes) else str(value).encode()

        def attempt():
            rc = self._lib.tcpstore_set(self._fd, key.encode(), data,
                                        len(data))
            if rc != 0:
                raise RuntimeError("TCPStore.set failed")
        with self._tracer.span("store.set", key=key, root_eligible=False):
            self._retry_op("set", attempt)

    def get(self, key: str, wait: bool = True,
            max_bytes: int = 1 << 20) -> bytes:
        """Blocking get (waits up to ``timeout`` for the key).  The span
        covers the whole wait.  ``max_bytes`` sizes the receive buffer."""
        buf = ctypes.create_string_buffer(max_bytes)
        deadline = time.monotonic() + self.timeout
        with self._tracer.span("store.get", key=key, wait=wait,
                               root_eligible=False):
            while True:
                n = self._lib.tcpstore_get(self._fd, key.encode(), buf,
                                           len(buf))
                if n >= 0:
                    return buf.raw[:n]
                if n == -1:
                    raise RuntimeError("TCPStore.get failed")
                if not wait:
                    raise KeyError(key)
                if time.monotonic() > deadline:
                    raise TimeoutError(f"TCPStore.get({key}) timed out")
                time.sleep(0.01)

    def _add_once(self, key: str, amount: int, token: str) -> int:
        """One token-carrying add round trip (resending the same token is
        safe: the server replays the first application's result)."""
        v = self._lib.tcpstore_add_tok(self._fd, key.encode(), amount,
                                       token.encode())
        if v == -(2 ** 63):
            raise RuntimeError("TCPStore.add failed")
        return int(v)

    def _get_on_fd(self, fd: int, key: str, max_bytes: int) -> bytes:
        buf = ctypes.create_string_buffer(max_bytes)
        n = self._lib.tcpstore_get(fd, key.encode(), buf, len(buf))
        if n == -2:
            raise KeyError(key)
        if n < 0:
            raise RuntimeError(f"TCPStore.get({key}) failed")
        return buf.raw[:n]

    def _bulk_pool(self, n: int):
        with self._bulk_lock:
            while len(self._bulk_fds) < n:
                fd = self._lib.tcpstore_connect(
                    self.host.encode(), self.port,
                    int(min(self.timeout, 10.0) * 1000))
                if fd < 0:
                    break
                _bound_socket(fd, self._op_timeout)
                self._bulk_fds.append(fd)
            return list(self._bulk_fds)

    def get_many(self, keys, max_bytes: int = 1 << 20, parallel: int = 4):
        """Fetch several present keys, overlapping round trips across a
        small pool of dedicated connections.  Returns values in key
        order; sequential gets when the pool can't be built."""
        keys = list(keys)
        if len(keys) < 2:
            return [self.get(k, wait=False, max_bytes=max_bytes)
                    for k in keys]
        fds = self._bulk_pool(min(parallel, len(keys)))
        if not fds:
            return [self.get(k, wait=False, max_bytes=max_bytes)
                    for k in keys]
        out = [None] * len(keys)

        def fetch(fd, i):
            out[i] = self._get_on_fd(fd, keys[i], max_bytes)
        self._bulk_run(fds, keys, fetch)
        return out

    def _bulk_run(self, fds, keys, fetch):
        errs = []

        def worker(slot: int):
            fd = fds[slot]
            for i in range(slot, len(keys), len(fds)):
                try:
                    fetch(fd, i)
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errs.append(e)
                    return
        threads = [threading.Thread(target=worker, args=(s,), daemon=True,
                                    name="paddle_tpu_torch-store-fetch")
                   for s in range(len(fds))]
        for t in threads:
            t.start()
        # each part's recv is bounded by the socket timeout; a thread
        # still alive past the whole budget is a stalled server
        deadline = time.monotonic() + self._op_timeout * \
            max(1, -(-len(keys) // len(fds)))
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"TCPStore bulk fetch of {len(keys)} keys "
                               "timed out")
        if errs:
            raise errs[0]

    def _get_into_fd(self, fd: int, key: str, view) -> int:
        """Non-waiting get received directly into a writable buffer."""
        buf = (ctypes.c_char * len(view)).from_buffer(view)
        n = self._lib.tcpstore_get(fd, key.encode(), buf, len(view))
        if n == -2:
            raise KeyError(key)
        if n < 0:
            raise RuntimeError(f"TCPStore.get({key}) failed")
        return n

    def get_many_into(self, keys, views, parallel: int = 4):
        """Zero-copy bulk fetch: each key's value lands in its (exactly
        sized) writable view, round trips overlapped across the bulk
        pool.  Returns the per-key byte counts."""
        keys, views = list(keys), list(views)
        counts = [0] * len(keys)
        fds = self._bulk_pool(min(parallel, len(keys))) or [self._fd]

        def fetch(fd, i):
            counts[i] = self._get_into_fd(fd, keys[i], views[i])
        self._bulk_run(fds, keys, fetch)
        return counts

    def add(self, key: str, amount: int = 1) -> int:
        """Atomic counter add, retry-safe: each call mints one op-id token
        reused across its bounded retries.  ``amount=0`` (a pure read)
        skips the token."""
        with self._tracer.span("store.add", key=key, root_eligible=False):
            if amount == 0:
                def attempt_read():
                    v = self._lib.tcpstore_add(self._fd, key.encode(), 0)
                    if v == -(2 ** 63):
                        raise RuntimeError("TCPStore.add failed")
                    return int(v)
                return self._retry_op("add", attempt_read)
            global _ADD_SEQ
            with _ADD_SEQ_LOCK:
                _ADD_SEQ += 1
                seq = _ADD_SEQ
            token = f"{_ADD_NONCE}-{os.getpid()}-{seq}"
            return self._retry_op(
                "add", lambda: self._add_once(key, amount, token))

    def check(self, key: str) -> bool:
        def attempt():
            rc = self._lib.tcpstore_check(self._fd, key.encode())
            if rc < 0:
                raise RuntimeError("TCPStore.check failed")
            return bool(rc)
        with self._tracer.span("store.check", key=key, root_eligible=False):
            return self._retry_op("check", attempt)

    def wait(self, keys, timeout: Optional[float] = None):
        if isinstance(keys, str):
            keys = [keys]
        deadline = time.monotonic() + (timeout or self.timeout)
        for k in keys:
            while not self.check(k):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"TCPStore.wait({k}) timed out")
                time.sleep(0.01)

    def barrier(self, name: str = "barrier"):
        """All world_size processes rendezvous on a counting key."""
        with self._tracer.span("store.barrier", barrier=name,
                               root_eligible=False):
            n = self.add(f"__{name}_count", 1)
            deadline = time.monotonic() + self.timeout
            while n < self.world_size:
                if self.add(f"__{name}_count", 0) >= self.world_size:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError("barrier timed out")
                time.sleep(0.01)

    def _stop_server(self):
        if self._server:
            # drain peers first: a client whose last poll is in flight
            # gets its answer; a short grace only, so shutdown never
            # waits out the rendezvous timeout
            grace_ms = int(min(self.timeout, 5.0) * 1000)
            self._lib.tcpstore_server_wait_clients(self._server, 0, grace_ms)
            self._lib.tcpstore_server_stop(self._server)
            self._server = None

    def close(self):
        with self._bulk_lock:
            for fd in self._bulk_fds:
                self._lib.tcpstore_close(fd)
            self._bulk_fds.clear()
        if self._fd is not None and self._fd >= 0:
            self._lib.tcpstore_close(self._fd)
            self._fd = -1
        self._stop_server()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
