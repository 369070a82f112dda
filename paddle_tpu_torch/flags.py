"""Global runtime flags (``paddle_tpu/flags.py``; parity: Paddle's
``FLAGS_*`` and ``paddle.set_flags``).

A flag reads its default from the ``FLAGS_<name>`` environment variable
when this module is imported, and ``set_flags`` changes it at run time.
Consumers read through :func:`get`, so a change made at run time is
seen at the next call.

Only flags that something reads are defined, and ``set_flags`` raises
for any other name, so setting a flag never passes in silence.
``check_nan_inf`` and ``check_nan_inf_level`` are read by the op hook
(``core/dispatch.py``: sweep every op's outputs for NaN/Inf; level 0
raises, any other level prints).  ``default_matmul_precision`` is the
precision of the fp32 products of the chunked lm-head cross-entropy
(``nn/functional/loss.py``).  At ``"default"`` they run TF32 on the
card, as the reference leaves its fp32 dots at the accelerator's default
precision; ``"float32"``, ``"bfloat16_3x"`` and ``"highest"`` keep them
exact fp32 (cuBLAS has no three-pass bf16, and fp32 is at least as
precise).  On the CPU they are exact fp32 at every value."""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List

__all__ = ["define_flag", "get", "set_flags", "get_flags", "on_change",
           "MATMUL_PRECISIONS"]

_lock = threading.Lock()
_registry: Dict[str, dict] = {}
try:                    # kept across importlib.reload, as its callers are
    _listeners
except NameError:
    _listeners: List[Callable[[], None]] = []

# the values of default_matmul_precision
MATMUL_PRECISIONS = ("default", "float32", "bfloat16_3x", "highest")


def _parse(value: str, default):
    if isinstance(default, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(default, int):
        return int(value)
    if isinstance(default, float):
        return float(value)
    return value


def _key(name: str) -> str:
    return name[6:] if name.startswith("FLAGS_") else name


def define_flag(name: str, default: Any, help_str: str = ""):
    env = os.environ.get(f"FLAGS_{name}")
    value = _parse(env, default) if env is not None else default
    with _lock:
        _registry[name] = {"value": value, "default": default,
                           "help": help_str}
    return value


def get(name: str):
    entry = _registry.get(_key(name))
    if entry is None:
        raise KeyError(f"Unknown flag: {name}")
    return entry["value"]


def set_flags(flags: Dict[str, Any]):
    with _lock:
        for k, v in flags.items():
            entry = _registry.get(_key(k))
            if entry is None:
                raise KeyError(f"Unknown flag: {k}; defined: "
                               f"{sorted(_registry)}")
            cur = entry["default"]
            entry["value"] = _parse(v, cur) if isinstance(
                v, str) and not isinstance(cur, str) else v
    for fn in _listeners:
        fn()


def on_change(fn: Callable[[], None]):
    """Call `fn` after every ``set_flags`` (the op hook keeps its fast
    path's switch current this way)."""
    _listeners.append(fn)
    fn()


def get_flags(flags=None):
    with _lock:
        if flags is None:
            return {f"FLAGS_{k}": v["value"] for k, v in _registry.items()}
        if isinstance(flags, str):
            flags = [flags]
        return {f"FLAGS_{_key(k)}": get(k) for k in flags}


define_flag("check_nan_inf", False,
            "scan op outputs for NaN/Inf (debugging)")
define_flag("check_nan_inf_level", 0, "0: error on nan/inf; >=1: log only")
define_flag("default_matmul_precision", "default",
            "fp32 matmul precision: default|float32|bfloat16_3x|highest")
for _fn in _listeners:  # a reload redefines the flags: tell the readers
    _fn()
