"""Process state: the global seed, one ``torch.Generator`` per device,
the default device, and the backend fingerprint.

The JAX package keeps one splitting key (``paddle_tpu/core/state.py``);
here each device gets its own generator, all seeded from the same
integer by :func:`seed`, as ``paddle.seed`` fans out to every device's
generator.  Torch's generators and JAX's threefry never give the same
numbers: parity between the packages goes through copied weights
(``Layer.set_state_dict``), never through a shared seed."""

from __future__ import annotations

import threading
from typing import Dict

import torch

_lock = threading.Lock()
_seed = 0
_generators: Dict[str, torch.Generator] = {}


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: ``cuda`` unless the caller asks for
    another device.  Asking for CUDA (explicitly or by default) on a
    machine without it raises — nothing quietly carries on on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def backend_fingerprint(device=None) -> str:
    """``platform:device_kind:nN`` of the hardware a measurement or a
    compiled program belongs to (``paddle_tpu/compile_cache.py:100``):
    ``cuda:<card name, spaces as _>:n<cards>``, or ``cpu:cpu:n1``.
    Without `device`, the process's backend: the CUDA cards where there
    are any.  Keys that carry it never mix two backends' records."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"{dev.type}:{dev.type}:n1"
    tag = _fingerprints.get(dev)
    if tag is None:
        kind = torch.cuda.get_device_name(dev).replace(" ", "_")
        tag = _fingerprints[dev] = \
            f"cuda:{kind}:n{torch.cuda.device_count()}"
    return tag


_fingerprints: Dict[torch.device, str] = {}


def seed(s: int) -> int:
    """Reseed every device's generator (existing and future ones)."""
    global _seed
    with _lock:
        _seed = int(s)
        for g in _generators.values():
            g.manual_seed(_seed)
    return _seed


def get_seed() -> int:
    return _seed


def generator(device) -> torch.Generator:
    """The global generator of `device`, created on first use from the
    current seed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    with _lock:
        g = _generators.get(key)
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(_seed)
            _generators[key] = g
    return g


def renew_generator(device, state: torch.Tensor) -> torch.Generator:
    """Replace `device`'s generator by a new one at `state` (a CUDA graph
    capture that fails leaves a generator registered with it in capture
    mode, where it refuses draws outside a capture)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.set_state(state)
    with _lock:
        _generators[str(dev)] = g
    return g


def get_rng_state(device=None):
    """The generators' states (``core/state.py:72-77``): with `device`,
    that device's generator state (a CPU uint8 tensor); without, a dict
    ``{device: state}`` over every generator made so far (the CPU's
    always).  Torch's Philox / MT states, never JAX's threefry key."""
    if device is not None:
        return generator(device).get_state()
    generator("cpu")
    with _lock:
        gens = dict(_generators)
    return {key: g.get_state() for key, g in gens.items()}


def set_rng_state(data, device=None):
    """Restore what :func:`get_rng_state` returned: a dict of device
    states, or one state for `device` (the CPU's when not given); later
    draws repeat those that followed the saved state."""
    if not isinstance(data, dict):
        data = {str(torch.device("cpu" if device is None else device)):
                data}
    for key, state in data.items():
        generator(key).set_state(state)
