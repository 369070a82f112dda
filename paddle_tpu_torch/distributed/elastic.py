"""Elastic training (``paddle_tpu/distributed/elastic.py``): only
:func:`free_port` is ported; the managers and agents wait (ROADMAP.md,
queue 1, item 8)."""

from __future__ import annotations

import socket

__all__ = ["free_port"]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
