"""The default device (``paddle_tpu/device/__init__.py:13-24``).

Only ``set_device`` / ``get_device`` are ported: they set and read the
device that :func:`paddle_tpu_torch.core.state.resolve_device` gives a
caller that names none (a creation or random op with no tensor input,
a model built without ``device=``).  Paddle's spellings: ``"gpu"``,
``"gpu:N"`` and ``"cpu"``; ``get_device()`` answers ``"gpu:0"`` or
``"cpu"``.  The default is the card; without one, and without
``set_device("cpu")``, those callers raise.  The rest of ``device/``
(streams, memory stats) is ROADMAP.md queue 1 item 7.8."""

from __future__ import annotations

from paddle_tpu_torch.core import state as _state

__all__ = ["set_device", "get_device"]


def torch_device_name(device) -> str:
    """Paddle's device name (``"gpu"``, ``"gpu:N"``, ``"cpu"``; torch's
    ``"cuda"`` / ``"cuda:N"`` too) as torch's."""
    name = str(device).lower()
    kind, _, index = name.partition(":")
    if kind in ("gpu", "cuda"):
        return f"cuda:{int(index or 0)}"
    if kind == "cpu" and not index:
        return "cpu"
    raise ValueError(f"unknown device {device!r}; expected 'gpu', 'gpu:N' "
                     f"or 'cpu'")


def set_device(device: str) -> str:
    """Make `device` the default (``"gpu"``, ``"gpu:N"``, ``"cpu"``)."""
    _state.set_default_device(torch_device_name(device))
    return device


def get_device() -> str:
    dev = _state.get_default_device()
    if dev == "cpu":
        return "cpu"
    _, _, index = dev.partition(":")
    return f"gpu:{index or 0}"
