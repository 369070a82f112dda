"""Fault-injection registry (a copy of ``paddle_tpu/robustness/
faults.py``): named fault points with armed triggers.

Each survivable path hosts a named **fault point**, a no-op until a
matching :class:`FaultSpec` is armed through :func:`inject` or the
``PADDLE_TPU_FAULTS`` environment variable; every firing is recorded to
the flight recorder and to the ``paddle_tpu_fault_injections_total
{point}`` counter, so a chaos test can assert both that the fault
happened and that the system outlived it.

The port's fault points (the JAX package hosts more, in subsystems not
ported yet):

====================================  =====================================
point                                 site
====================================  =====================================
``serving.engine_step``               raises inside the serving engine's
                                      scheduling step (device fault / bad
                                      batch): the in-flight batch fails,
                                      the engine serves on
``serving.kv_alloc``                  simulates paged-KV block-pool
                                      exhaustion at admission (bool-style:
                                      the request is deferred, never lost)
``router.dispatch``                   raises as the router hands a request
                                      to a replica (bounded retry, then
                                      status "error")
``router.kv_transfer``                raises inside the prefill->decode
                                      KV handoff (the router falls back to
                                      a fresh prefill)
``serving.replica_kill``              declares a replica dead at its next
                                      scheduling turn (bool-style; its
                                      in-flight requests re-queue)
``kv_tier.spill``                     drops a KV demotion (the later fetch
                                      misses and the session recomputes)
``kv_tier.fetch``                     turns a KV tier fetch into a miss
``session.migrate``                   fails the router's death-recovery
                                      session fetch (fresh prefill on a
                                      survivor)
``obs.fleet.publish``                 fails a fleet metrics-snapshot
                                      publish
``train.nonfinite_batch``             poisons a train batch's float leaves
                                      with NaN (bool-style: the bad
                                      microbatch the step-guard must
                                      absorb; an integer LM batch has no
                                      float leaf to poison)
``train.straggler_delay``             sleeps inside the timed train-step
                                      region (bool-style;
                                      ``PADDLE_TPU_STRAGGLER_DELAY_S``,
                                      default 0.05 s): the injected
                                      straggler the fleet ``straggler``
                                      rule must catch
====================================  =====================================

Env syntax (comma-separated specs, colon-separated options)::

    PADDLE_TPU_FAULTS="router.dispatch:n=2:times=1,kv_tier.fetch:p=0.5"

Options: ``p=<float>`` fire probability (default 1.0), ``n=<int>`` first
eligible call (default 1), ``times=<int>`` max fires (default
unlimited), ``action=raise|exit`` (default ``raise``; ``exit`` hard-kills
the process with ``os._exit(13)``).  ``PADDLE_TPU_FAULTS_SEED`` makes
probabilistic firing reproducible.  The disarmed fast path is one
module-global ``is None`` check plus (once armed) a dict lookup."""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["InjectedFault", "NonFiniteStepError", "QueueFullError",
           "FaultSpec", "FaultRegistry", "fault_registry", "fault_point",
           "fault_fires", "inject", "clear_faults", "fault_stats"]


class InjectedFault(RuntimeError):
    """Raised by a firing fault point (``action=raise``).  Deliberately a
    RuntimeError: sites must survive it through the SAME handlers that
    cover the genuine failure, never by catching InjectedFault itself."""


class NonFiniteStepError(FloatingPointError):
    """TrainStep's anomaly guard exhausted its consecutive-skip budget:
    the loss/grads have been NaN/Inf for K straight steps — a persistent
    divergence, not a one-off bad microbatch."""


class QueueFullError(RuntimeError):
    """Serving admission queue is at capacity; the request was rejected
    instead of growing the queue without bound."""


_EXIT_CODE = 13  # distinctive, outside the sysexits range


@dataclass
class FaultSpec:
    """One armed fault: which point, when it fires, what it does."""

    point: str
    probability: float = 1.0
    nth: int = 1              # first eligible call (1-based)
    times: Optional[int] = None   # max fires; None = unlimited
    action: str = "raise"     # "raise" | "exit"
    calls: int = 0
    fires: int = 0
    extra: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self):
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(f"probability must be in [0,1], got "
                             f"{self.probability}")
        if self.nth < 1:
            raise ValueError(f"n must be >= 1, got {self.nth}")
        if self.action not in ("raise", "exit"):
            raise ValueError(f"unknown fault action {self.action!r}")


def _fault_counter():
    from paddle_tpu_torch.observability import default_registry
    return default_registry().counter(
        "paddle_tpu_fault_injections_total",
        "injected faults fired, per fault point",
        labelnames=("point",))


class FaultRegistry:
    """Thread-safe spec table + trigger logic.  One instance per process
    (lazily seeded from ``PADDLE_TPU_FAULTS``); tests may build private
    ones."""

    def __init__(self, seed: Optional[int] = None):
        self._specs: Dict[str, FaultSpec] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(seed)

    # -- configuration -------------------------------------------------------
    def inject(self, point: str, probability: float = 1.0, nth: int = 1,
               times: Optional[int] = None,
               action: str = "raise") -> FaultSpec:
        """Arm `point`.  Re-arming replaces the previous spec (and its
        counters) — a test's second scenario starts clean."""
        spec = FaultSpec(point=point, probability=probability, nth=nth,
                         times=times, action=action)
        with self._lock:
            self._specs[point] = spec
        return spec

    def clear(self, point: Optional[str] = None):
        with self._lock:
            if point is None:
                self._specs.clear()
            else:
                self._specs.pop(point, None)

    def configure(self, text: str):
        """Parse the ``PADDLE_TPU_FAULTS`` syntax (see module docstring)."""
        for chunk in text.split(","):
            chunk = chunk.strip()
            if not chunk:
                continue
            parts = chunk.split(":")
            point, opts = parts[0].strip(), parts[1:]
            kw: Dict[str, object] = {}
            for opt in opts:
                if "=" not in opt:
                    raise ValueError(
                        f"malformed fault option {opt!r} in {chunk!r} "
                        "(expected key=value)")
                k, v = opt.split("=", 1)
                k = k.strip()
                if k == "p":
                    kw["probability"] = float(v)
                elif k == "n":
                    kw["nth"] = int(v)
                elif k == "times":
                    kw["times"] = int(v)
                elif k == "action":
                    kw["action"] = v.strip()
                else:
                    raise ValueError(f"unknown fault option {k!r} in "
                                     f"{chunk!r}")
            self.inject(point, **kw)

    # -- introspection -------------------------------------------------------
    def specs(self) -> List[FaultSpec]:
        with self._lock:
            return list(self._specs.values())

    def stats(self, point: str) -> Dict[str, int]:
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return {"calls": 0, "fires": 0}
            return {"calls": spec.calls, "fires": spec.fires}

    @property
    def armed(self) -> bool:
        return bool(self._specs)

    # -- trigger -------------------------------------------------------------
    def should_fire(self, point: str, **context) -> bool:
        """Count one call at `point`; True when the armed spec elects to
        fire.  Records the firing (flight recorder + counter) so chaos
        tests can assert the fault actually happened."""
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return False
            spec.calls += 1
            if spec.calls < spec.nth:
                return False
            if spec.times is not None and spec.fires >= spec.times:
                return False
            if spec.probability < 1.0 and \
                    self._rng.random() >= spec.probability:
                return False
            spec.fires += 1
            fires, calls, action = spec.fires, spec.calls, spec.action
        # record OUTSIDE the lock: the recorder/metrics take their own
        try:
            from paddle_tpu_torch.observability import flight_recorder
            flight_recorder().record("fault.injected", point=point,
                                     fire=fires, call=calls,
                                     action=action, **context)
            _fault_counter().labels(point=point).inc()
        except Exception:
            pass  # telemetry must never turn a drill into a real outage
        return True

    def trigger(self, point: str, **context) -> bool:
        """The raise-style hook body: no-op / raise / hard-exit."""
        if not self.should_fire(point, **context):
            return False
        spec = self._specs.get(point)
        if spec is not None and spec.action == "exit":
            os._exit(_EXIT_CODE)
        raise InjectedFault(f"injected fault at {point!r} "
                            f"(context: {context or {}})")


_REGISTRY: Optional[FaultRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def fault_registry() -> FaultRegistry:
    """The process-wide registry, built on first use and seeded from
    ``PADDLE_TPU_FAULTS`` / ``PADDLE_TPU_FAULTS_SEED``.  Worker processes
    (fork or spawn) re-read the env on their own first use, so faults
    armed via env reach dataloader workers and elastic workers too."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                seed = os.environ.get("PADDLE_TPU_FAULTS_SEED")
                reg = FaultRegistry(
                    seed=int(seed) if seed else None)
                env = os.environ.get("PADDLE_TPU_FAULTS")
                if env:
                    reg.configure(env)
                _REGISTRY = reg
    return _REGISTRY


def reset_registry():
    """Drop the process-wide registry (next use re-reads the env).
    Test plumbing."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = None


def _maybe_registry() -> Optional[FaultRegistry]:
    """Fast-path accessor: None when nothing could possibly be armed —
    the common case costs one global read and one env lookup at most."""
    if _REGISTRY is not None:
        return _REGISTRY
    if "PADDLE_TPU_FAULTS" in os.environ:
        return fault_registry()
    return None


def fault_point(point: str, **context):
    """Raise-style hook: raises :class:`InjectedFault` (or hard-exits,
    per spec) when an armed fault fires; otherwise a near-free no-op.
    Sites use this where the real-world analog is an exception — an I/O
    error, a refused connection, a crashed device call."""
    reg = _maybe_registry()
    if reg is not None and reg.armed:
        reg.trigger(point, **context)


def fault_fires(point: str, **context) -> bool:
    """Bool-style hook: True when an armed fault fires.  Sites use this
    where the real-world analog is *silent* misbehavior — a torn write,
    a dropped heartbeat — and implement the corruption themselves."""
    reg = _maybe_registry()
    if reg is None or not reg.armed:
        return False
    return reg.should_fire(point, **context)


def inject(point: str, probability: float = 1.0, nth: int = 1,
           times: Optional[int] = None, action: str = "raise") -> FaultSpec:
    """Arm a fault on the process-wide registry (API twin of the env)."""
    return fault_registry().inject(point, probability=probability,
                                   nth=nth, times=times, action=action)


def clear_faults(point: Optional[str] = None):
    fault_registry().clear(point)


def fault_stats(point: str) -> Dict[str, int]:
    return fault_registry().stats(point)
