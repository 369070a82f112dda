"""The port's TCPStore (``paddle_tpu_torch/distributed/tcp_store.py``)
on the CPU: the port's client against the port's server and against the
JAX package's (one wire protocol, both directions), the idempotent
``add`` under retry, bounded waits (``get``, ``wait``, a server that
stops answering), the retry counters, the bulk fetches, and the fleet's
``_connect_store``.  Every server starts on a free port and stops in
its fixture; every blocking call has a timeout of a second or less."""

import socket
import threading
import time

import pytest

from paddle_tpu import robustness as jrob
from paddle_tpu.distributed.tcp_store import TCPStore as JTCPStore

from paddle_tpu_torch import robustness as trob
from paddle_tpu_torch.distributed.elastic import free_port
from paddle_tpu_torch.distributed.tcp_store import TCPStore
from paddle_tpu_torch.observability import default_registry


@pytest.fixture(autouse=True)
def _clean_faults():
    trob.clear_faults()
    jrob.clear_faults()
    yield
    trob.clear_faults()
    jrob.clear_faults()


@pytest.fixture
def server():
    """A port TCPStore master (client 0) on a free port."""
    s = TCPStore("127.0.0.1", free_port(), is_master=True, world_size=2,
                 timeout=1.0)
    yield s
    s.close()


@pytest.fixture
def jax_server():
    s = JTCPStore("127.0.0.1", free_port(), is_master=True, world_size=2,
                  timeout=1.0)
    yield s
    s.close()


def _client(master, cls=TCPStore):
    return cls("127.0.0.1", master.port, timeout=1.0, connect_timeout=1.0)


def _total(name, **labels):
    m = default_registry().get(name)
    if m is None:
        return 0.0
    return sum(child.value() for values, child in m.series()
               if all(dict(zip(m.labelnames, values)).get(k) == v
                      for k, v in labels.items()))


@pytest.mark.parametrize("pair", ["port-port", "port-jax", "jax-port"])
def test_ops_across_clients_and_servers(server, jax_server, pair):
    """set/get/check/add/wait/barrier and the bulk fetches, one side
    writing and the other reading, over either package's server."""
    srv = jax_server if pair == "port-jax" else server
    a = _client(srv, JTCPStore if pair == "jax-port" else TCPStore)
    b = _client(srv)
    try:
        a.set("k", b"v1")
        a.set("n", 42)
        assert b.get("k", wait=False) == b"v1"
        assert b.get("n") == b"42"
        assert b.check("k") and not b.check("nope")
        assert a.add("ctr", 5) == 5 and b.add("ctr", 2) == 7
        assert b.add("ctr", 0) == 7
        big = bytes(range(256)) * 4096          # 1 MiB
        a.set("big0", big)
        a.set("big1", big[::-1])
        assert b.get_many(["big0", "big1"], max_bytes=1 << 21) == \
            [big, big[::-1]]
        bufs = [bytearray(len(big)), bytearray(len(big))]
        assert b.get_many_into(["big0", "big1"],
                               [memoryview(x) for x in bufs]) == \
            [len(big)] * 2
        assert bytes(bufs[1]) == big[::-1]
        b.wait(["k", "n"], timeout=0.5)
        t = threading.Thread(target=a.barrier, args=("bar",), daemon=True)
        t.start()
        b.barrier("bar")
        t.join(1.0)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()


def test_bounded_waits(server):
    c = _client(server)
    try:
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            c.get("absent")              # timeout=1.0
        with pytest.raises(TimeoutError):
            c.wait("absent", timeout=0.2)
        with pytest.raises(KeyError):
            c.get("absent", wait=False)
        assert time.monotonic() - t0 < 3.0
    finally:
        c.close()


def test_silent_server_fails_the_op_within_its_timeout():
    """A listener that accepts and never answers: the op's receive
    times out (the socket's own timeout), is retried and raises; nothing
    blocks past the bound."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(8)
    conns = []
    stop = threading.Event()

    def accept():
        ls.settimeout(0.1)
        while not stop.is_set():
            try:
                conns.append(ls.accept()[0])
            except OSError:
                pass
    t = threading.Thread(target=accept, daemon=True)
    t.start()
    try:
        c = TCPStore("127.0.0.1", ls.getsockname()[1], timeout=0.2,
                     connect_timeout=1.0)
        before = _total("paddle_tpu_tcp_store_op_retries_total", op="check")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError):
            c.check("k")
        assert time.monotonic() - t0 < 3.0
        assert _total("paddle_tpu_tcp_store_op_retries_total",
                      op="check") == before + 2
        c.close()
    finally:
        stop.set()
        t.join(1.0)
        for s in conns:
            s.close()
        ls.close()


def test_idempotent_add_under_retry(server):
    c = _client(server)
    try:
        # a resent token replays the first result: no double count
        assert c._add_once("ctr", 3, "tok-1") == 3
        assert c._add_once("ctr", 3, "tok-1") == 3
        assert c.add("ctr", 0) == 3
        # an op fault on the first attempt is retried with one token
        before = _total("paddle_tpu_tcp_store_op_retries_total", op="add")
        trob.inject("tcp_store.op", times=1)
        assert c.add("ctr", 2) == 5
        assert trob.fault_stats("tcp_store.op")["fires"] == 1
        assert _total("paddle_tpu_tcp_store_op_retries_total",
                      op="add") == before + 1
    finally:
        c.close()


def test_connect_retries_counted_and_bounded():
    port = free_port()
    before = _total("paddle_tpu_tcp_store_connect_retries_total")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="cannot connect"):
        TCPStore("127.0.0.1", port, timeout=1.0, connect_timeout=0.3)
    assert time.monotonic() - t0 < 2.0
    # a refused connect (here injected) is retried with backoff, counted
    s = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=1.0)
    try:
        trob.inject("tcp_store.connect", times=1)
        c = TCPStore("127.0.0.1", s.port, timeout=1.0, connect_timeout=1.0)
        assert trob.fault_stats("tcp_store.connect")["fires"] == 1
        assert _total("paddle_tpu_tcp_store_connect_retries_total") == \
            before + 1
        c.close()
    finally:
        s.close()


def test_fleet_connect_store(server, monkeypatch):
    from paddle_tpu_torch.observability import fleet as F
    server.set("obs/x", b"1")
    c = F._connect_store(f"127.0.0.1:{server.port}")
    try:
        assert c.get("obs/x", wait=False) == b"1"
    finally:
        c.close()
    monkeypatch.setenv("PADDLE_ELASTIC_STORE", f"127.0.0.1:{server.port}")
    c = F._connect_store("1")
    try:
        assert c.check("obs/x")
    finally:
        c.close()
    monkeypatch.delenv("PADDLE_ELASTIC_STORE")
    monkeypatch.delenv("PADDLE_STORE_PORT", raising=False)
    with pytest.raises(RuntimeError, match="no fleet store address"):
        F._connect_store(None)


def test_close_is_idempotent():
    s = TCPStore("127.0.0.1", free_port(), is_master=True, timeout=1.0)
    s.set("a", b"b")
    s.close()
    s.close()
    assert s._fd == -1 and s._server is None
