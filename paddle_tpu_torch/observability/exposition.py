"""Exposition: Prometheus text format over stdlib HTTP + JSONL sink (a
copy of ``paddle_tpu/observability/exposition.py``).

Two paths out of the registry, both optional and both off until asked
for (constructor call or env var):

* :class:`MetricsServer` — a daemon-threaded stdlib
  ``ThreadingHTTPServer`` serving the Prometheus text format (v0.0.4)
  at ``/metrics`` (plus ``/metrics.json`` and ``/healthz``); enabled by
  ``PADDLE_TPU_METRICS_PORT`` (0 picks an ephemeral port).
* :class:`JsonlSink` — appends one JSON snapshot line per ``write()``
  (or per ``interval`` seconds when started) to a file, for offline
  diffing of two runs; enabled by ``PADDLE_TPU_METRICS_JSONL``.

No dependency on anything outside the stdlib; scraping never blocks an
instrumented loop (collection snapshots under per-metric locks only).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["render_prometheus", "render_json", "MetricsServer",
           "JsonlSink", "start_metrics_server", "maybe_start_from_env"]


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"'
                    for k, v in items.items())
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    try:
        v = float(v)
    except Exception:
        return "NaN"
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_bound(b: float) -> str:
    return "+Inf" if b == float("inf") else _fmt_value(b)


def render_prometheus(registry=None) -> str:
    """Prometheus exposition text format 0.0.4."""
    if registry is None:
        from paddle_tpu_torch.observability.metrics import default_registry
        registry = default_registry()
    lines = []
    for fam in registry.collect():
        name, kind = fam["name"], fam["kind"]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for s in fam["series"]:
            labels = s["labels"]
            if kind == "histogram":
                for bound, cum in s["buckets"]:
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, {'le': _fmt_bound(bound)})}"
                        f" {cum}")
                lines.append(
                    f"{name}_bucket{_fmt_labels(labels, {'le': '+Inf'})}"
                    f" {s['count']}")
                lines.append(f"{name}_sum{_fmt_labels(labels)}"
                             f" {_fmt_value(s['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)}"
                             f" {s['count']}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)}"
                             f" {_fmt_value(s['value'])}")
    return "\n".join(lines) + "\n"


def render_json(registry=None) -> str:
    if registry is None:
        from paddle_tpu_torch.observability.metrics import default_registry
        registry = default_registry()

    def clean(o):
        if isinstance(o, float) and (o != o or o in (float("inf"),
                                                     float("-inf"))):
            return None
        if isinstance(o, dict):
            return {k: clean(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return [clean(v) for v in o]
        return o

    return json.dumps({"time": time.time(),
                       "metrics": clean(registry.collect())})


class _Handler(BaseHTTPRequestHandler):
    registry = None

    def do_GET(self):  # noqa: N802 (stdlib contract)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            body = render_prometheus(self.registry).encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            body = render_json(self.registry).encode()
            ctype = "application/json"
        elif path == "/healthz":
            body, ctype = b"ok\n", "text/plain"
        else:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # scrapes must not spam stderr
        pass


class MetricsServer:
    """``/metrics`` endpoint on a daemon thread.  ``port=0`` binds an
    ephemeral port (read it back from ``.port``)."""

    def __init__(self, port: int = 0, registry=None,
                 host: str = "0.0.0.0"):
        handler = type("BoundHandler", (_Handler,),
                       {"registry": registry})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.host = host
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="paddle-tpu-metrics",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/metrics"

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def start_metrics_server(port: int = 0, registry=None) -> MetricsServer:
    return MetricsServer(port=port, registry=registry)


class JsonlSink:
    """Append one JSON metrics snapshot per line — two runs' files diff
    cleanly offline (``jq``/pandas).  ``start(interval)`` samples on a
    daemon thread; ``write()`` snapshots on demand."""

    def __init__(self, path: str, registry=None):
        self.path = path
        self._registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def write(self):
        line = render_json(self._registry)
        with open(self.path, "a") as f:
            f.write(line + "\n")

    def start(self, interval: float = 10.0) -> "JsonlSink":
        def loop():
            while not self._stop.wait(interval):
                try:
                    self.write()
                except Exception:
                    pass  # a full disk must not kill the run
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle-tpu-metrics-jsonl")
        self._thread.start()
        return self

    def close(self, final_write: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if final_write:
            try:
                self.write()
            except Exception:
                pass


_ENV_SERVER: Optional[MetricsServer] = None
_ENV_SINK: Optional[JsonlSink] = None
_ENV_WATCHDOG = None


def maybe_start_from_env(registry) -> None:
    """Attach exporters requested by env (called once from
    ``default_registry()``): PADDLE_TPU_METRICS_PORT starts the HTTP
    endpoint, PADDLE_TPU_METRICS_JSONL starts a periodic file sink
    (interval via PADDLE_TPU_METRICS_JSONL_INTERVAL, default 10s),
    PADDLE_TPU_SLO_RULES starts the SLO watchdog with the declarative
    rule spec (interval via PADDLE_TPU_SLO_INTERVAL, default 15s), and
    PADDLE_TPU_FLEET_METRICS=<host:port> starts the fleet snapshot
    publisher against that TCPStore (interval via
    PADDLE_TPU_FLEET_INTERVAL, default 5s)."""
    global _ENV_SERVER, _ENV_SINK, _ENV_WATCHDOG
    port = os.environ.get("PADDLE_TPU_METRICS_PORT")
    if port is not None and _ENV_SERVER is None:
        try:
            _ENV_SERVER = MetricsServer(port=int(port), registry=registry)
        except Exception as e:  # port taken: warn, never crash the job
            import sys
            print(f"paddle_tpu_torch.observability: metrics server on port "
                  f"{port} failed: {e}", file=sys.stderr)
    path = os.environ.get("PADDLE_TPU_METRICS_JSONL")
    if path and _ENV_SINK is None:
        interval = float(os.environ.get(
            "PADDLE_TPU_METRICS_JSONL_INTERVAL", "10"))
        _ENV_SINK = JsonlSink(path, registry=registry).start(interval)
    rules = os.environ.get("PADDLE_TPU_SLO_RULES")
    if rules and _ENV_WATCHDOG is None:
        try:
            from paddle_tpu_torch.observability.watchdog import Watchdog
            _ENV_WATCHDOG = Watchdog.from_spec(
                rules, registry=registry).start(
                float(os.environ.get("PADDLE_TPU_SLO_INTERVAL", "15")))
        except Exception as e:  # a typo'd rule must not crash the job
            import sys
            print(f"paddle_tpu_torch.observability: SLO watchdog from env "
                  f"failed: {e}", file=sys.stderr)
    if os.environ.get("PADDLE_TPU_FLEET_METRICS"):
        try:
            from paddle_tpu_torch.observability import fleet
            fleet.start_publisher_from_env(registry)
        except Exception as e:  # a down store must not crash the job
            import sys
            print(f"paddle_tpu_torch.observability: fleet publisher from env "
                  f"failed: {e}", file=sys.stderr)
