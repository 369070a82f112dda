"""Serving fleet router (a copy of ``paddle_tpu/inference/router.py``):
prefix-affine dispatch over N engines, prefill/decode disaggregation
with paged-KV handoff, SLO elasticity, session migration.

* **Prefix-affine routing** — the routing key is the prompt's full-block
  prefix chain, the chain the engine's ``PrefixCache`` trie keys on.  A
  bounded trie of dispatched chains, tagged with their replica, sends a
  request after its longest seen prefix to the replica that holds those
  KV blocks; unseen chains place by consistent hashing on a sha1 vnode
  ring.  An affine target at ``load >= spill_threshold`` spills to the
  least-loaded replica.
* **Prefill/decode disaggregation** (``prefill_replicas > 0``) — prefill
  replicas run ``add_request(prefill_only=True)`` and park the prompt's
  KV; the router exports it (``export_handoff``), serializes it
  (:func:`~paddle_tpu_torch.inference.kv_cache.serialize_handoff`, the
  JAX package's wire format) and hands it to a decode replica
  (``add_request(handoff=...)``): a copy, never a recompute.
* **SLO-driven elasticity** — :class:`SloAutoscaler` reads the
  ``paddle_tpu_serving_slo_total`` verdicts and the router's queue and
  scales through :meth:`ServingRouter.scale_up` (a replica warmed with
  ``aot_warmup`` when ``warm_on_spawn``) and :meth:`ServingRouter.drain`;
  :class:`SloAutoscaleRule` is the same policy as a watchdog rule.
* **Failure handling** — a replica whose ``step()`` escapes the engine's
  own containment (or the ``serving.replica_kill`` fault point) is dead:
  its in-flight requests migrate from the KV tier (checkpointed sessions)
  or re-queue for a fresh prefill; dispatch and transfer faults
  (``router.dispatch`` / ``router.kv_transfer``) retry, bounded.

The router mirrors the engine's driving surface (``add_request`` /
``step`` / ``finished`` / ``run`` / ``request_status`` / ``pending``).
Greedy outputs equal a single engine's: decode rows are
batch-independent, so neither placement nor handoff changes a request's
tokens.

Replicas built from one ``model`` share its parameters, and the port
converts a model's Linears in place for weight quantization, so tiers
that ask for different ``quant_weights`` or ``int8_weights`` are refused
(the JAX
engines keep parameter dicts of their own); mixed ``quant_kv`` lives in
each engine's own pools and is supported.  The multi-process worker
(:class:`ReplicaWorker` and the client calls) runs over the ported
``distributed.tcp_store.TCPStore`` or any store of its contract; the
worker process's launch, :func:`main`, waits (ROADMAP.md, queue 1,
item 8).
"""

from __future__ import annotations

import bisect
import hashlib
import os
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.observability.watchdog import SloAttainmentRule

__all__ = ["ServingRouter", "SloAutoscaler", "SloAutoscaleRule",
           "ReplicaWorker", "submit_request",
           "fetch_result", "main"]


_HANDOFF_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0)


def _router_metrics():
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    return {
        "requests": reg.counter(
            "paddle_tpu_router_requests_total",
            "requests accepted by the serving router"),
        "completions": reg.counter(
            "paddle_tpu_router_completions_total",
            "requests finished through the router, by terminal status",
            labelnames=("status",)),
        "dispatch": reg.counter(
            "paddle_tpu_router_dispatch_total",
            "dispatches to replicas; kind = why this replica",
            labelnames=("replica", "kind")),
        "affinity": reg.counter(
            "paddle_tpu_router_affinity_total",
            "routing-key resolution: affine = followed a seen prefix "
            "chain, hash = fresh chain onto the ring, spill = affine "
            "target saturated, least-loaded instead",
            labelnames=("result",)),
        "handoffs": reg.counter(
            "paddle_tpu_router_handoffs_total",
            "prefill->decode KV transfers; fallback = transfer failed, "
            "request re-prefilled elsewhere", labelnames=("result",)),
        "handoff_s": reg.histogram(
            "paddle_tpu_router_handoff_seconds",
            "export + serialize + deserialize wall time per handoff "
            "(the decode-side import is in the request's handoff_s)",
            buckets=_HANDOFF_BUCKETS),
        "handoff_bytes": reg.counter(
            "paddle_tpu_router_handoff_bytes_total",
            "serialized KV handoff payload bytes shipped"),
        "requeues": reg.counter(
            "paddle_tpu_router_requeues_total",
            "requests re-queued for another attempt",
            labelnames=("reason",)),
        "deaths": reg.counter(
            "paddle_tpu_router_replica_deaths_total",
            "replicas declared dead (escaped exception or injected "
            "kill); their in-flight requests re-prefill elsewhere"),
        "rejections": reg.counter(
            "paddle_tpu_router_rejections_total",
            "requests shed at the router edge", labelnames=("reason",)),
        "scale": reg.counter(
            "paddle_tpu_router_scale_events_total",
            "elasticity actions", labelnames=("direction",)),
    }


@dataclass
class _FleetRequest:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline: Optional[float]
    enqueued_at: float
    chain: tuple                      # full-block prefix chain
    span: object = None
    phase: str = "queued"             # queued|prefill|handoff|decode|done
    attempts: int = 0
    replica: Optional[str] = None
    engine_rid: Optional[int] = None
    handoff: Optional[dict] = None    # pending resume payload
    result: List[int] = field(default_factory=list)
    dispatched_at: float = 0.0        # last dispatch (requeue forensics)


class _Replica:
    """One engine behind the router, with the router's bookkeeping."""

    def __init__(self, rid: str, engine, role: str):
        self.id = rid
        self.engine = engine
        self.role = role              # mixed | prefill | decode
        self.assigned: Dict[int, _FleetRequest] = {}
        self.dead = False
        self.draining = False
        self.ticks = 0                # service polls (ckpt cadence)

    @property
    def load(self) -> int:
        return self.engine.pending

    @property
    def live(self) -> bool:
        return not self.dead and not self.draining

    def decode_capable(self) -> bool:
        return self.role in ("mixed", "decode")

    def prefill_capable(self) -> bool:
        return self.role in ("mixed", "prefill")


class ServingRouter:
    """A fleet of ``ContinuousBatchingEngine`` replicas behind one
    engine-shaped API.  See the module docstring for the routing,
    disaggregation, elasticity, and failure-handling contracts.

    ``replicas`` is the TOTAL count; ``prefill_replicas`` of them form
    the dedicated prefill tier (0 = homogeneous "mixed" fleet).
    ``engine_kwargs`` feed every engine; ``prefill_kwargs`` /
    ``decode_kwargs`` override per tier (e.g. a deeper
    ``steps_per_sync`` for the decode tier — legal precisely BECAUSE
    prefill never interleaves there).  ``engine_factory(role)``
    replaces construction entirely (tests, remote stubs)."""

    def __init__(self, model=None, replicas: int = 2,
                 prefill_replicas: int = 0,
                 engine_kwargs: Optional[dict] = None,
                 prefill_kwargs: Optional[dict] = None,
                 decode_kwargs: Optional[dict] = None,
                 engine_factory=None,
                 max_queue: Optional[int] = None,
                 spill_threshold: Optional[int] = None,
                 vnodes: int = 32, affinity_cap: int = 8192,
                 max_dispatch_retries: int = 3,
                 serialize_handoffs: bool = True,
                 warm_on_spawn: Optional[bool] = None,
                 prefill_steps_per_poll: int = 4,
                 autoscaler: Optional["SloAutoscaler"] = None,
                 kv_tier=None,
                 session_checkpoint_steps: int = 0):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if not 0 <= prefill_replicas < replicas:
            raise ValueError(
                f"prefill_replicas {prefill_replicas} must leave at "
                f"least one decode-capable replica of {replicas}")
        self._model = model
        self._factory = engine_factory
        self._engine_kwargs = dict(engine_kwargs or {})
        self._prefill_kwargs = dict(prefill_kwargs or {})
        self._decode_kwargs = dict(decode_kwargs or {})
        self.disaggregated = prefill_replicas > 0
        if self.disaggregated:
            # the handoff is a paged-block transfer; the whole fleet
            # must agree on the block geometry
            self._engine_kwargs.setdefault("paged_kv", True)
            if not self._engine_kwargs.get("paged_kv", True):
                raise ValueError("disaggregation requires paged_kv=True")
        self._block_size = int(self._engine_kwargs.get("kv_block_size",
                                                       16))
        if model is not None and engine_factory is None:
            self._check_shared_weights()
        self._max_queue = max_queue
        self._spill_threshold = spill_threshold
        self._vnodes = max(1, int(vnodes))
        self._affinity_cap = int(affinity_cap)
        self._max_retries = max(0, int(max_dispatch_retries))
        self._serialize = bool(serialize_handoffs)
        self._prefill_steps = max(1, int(prefill_steps_per_poll))
        if warm_on_spawn is None:
            # warm when the persistent compile cache is on (router.py:
            # 254-255): a spawned replica's programs come from it
            from paddle_tpu_torch import compile_cache
            warm_on_spawn = compile_cache.enabled()
        self._warm_on_spawn = bool(warm_on_spawn)
        self._autoscaler = autoscaler
        if autoscaler is not None:
            autoscaler.bind(self)
        # session survivability (kv_tier.py): every engine shares this
        # tier manager; with checkpointing on, in-flight decode sessions
        # are replicated to the peer tier every N service polls, so a
        # replica death migrates them to survivors instead of
        # re-prefilling (see _on_replica_death)
        self._kv_tier = kv_tier
        self._ckpt_steps = max(0, int(session_checkpoint_steps))
        if self._ckpt_steps and kv_tier is None:
            raise ValueError("session_checkpoint_steps requires "
                             "kv_tier=")
        if kv_tier is not None:
            self._engine_kwargs.setdefault("paged_kv", True)
            self._engine_kwargs.setdefault("kv_tier", kv_tier)
        self._parked_sessions: Dict[int, "_FleetRequest"] = {}

        self._queue: deque = deque()
        self._requests: Dict[int, _FleetRequest] = {}
        self._done: deque = deque()
        self._status: "OrderedDict[int, object]" = OrderedDict()
        self._next_rid = 0
        self._next_replica = 0
        self._replicas: "OrderedDict[str, _Replica]" = OrderedDict()
        self._ring: List[Tuple[int, str]] = []
        # affinity trie: block tuple -> {"replica": id, "children": {}}
        self._trie: dict = {"replica": None, "children": {}}
        self._trie_nodes = 0

        self._metrics = _router_metrics()
        from paddle_tpu_torch.observability import default_registry, \
            flight_recorder
        from paddle_tpu_torch.observability.tracing import tracer
        from paddle_tpu_torch.observability.forensics import emit_decision
        self._recorder = flight_recorder()
        self._tracer = tracer()
        # scheduler decision provenance (forensics): ring-only, no wire
        self._emit_decision = emit_decision
        reg = default_registry()
        reg.gauge("paddle_tpu_router_queue_depth",
                  "requests waiting at the router for dispatch"
                  ).set_function(lambda q=self._queue: len(q))
        reg.gauge("paddle_tpu_router_inflight",
                  "requests dispatched to a replica and not yet retired"
                  ).set_function(
            lambda r=self: sum(len(rep.assigned)
                               for rep in r._replicas.values()))
        self._replica_gauge = reg.gauge(
            "paddle_tpu_router_replicas",
            "live replicas by role", labelnames=("role",))
        self._load_gauge = reg.gauge(
            "paddle_tpu_router_replica_load",
            "per-replica load (engine queue + active slots)",
            labelnames=("replica",))

        for _ in range(prefill_replicas):
            self._spawn("prefill", warm=self._warm_on_spawn)
        role = "decode" if self.disaggregated else "mixed"
        for _ in range(replicas - prefill_replicas):
            self._spawn(role, warm=self._warm_on_spawn)

    def _check_shared_weights(self):
        """Replicas share `model`, whose Linears weight quantization
        converts in place: every tier must ask for the same
        ``quant_weights`` and ``int8_weights`` (each engine's own KV pools
        may differ)."""
        from paddle_tpu_torch.quantization.serving import \
            quant_weights_mode
        modes = {}
        for role, extra in (("prefill", self._prefill_kwargs),
                            ("decode", self._decode_kwargs),
                            ("mixed", {})):
            kw = dict(self._engine_kwargs, **extra)
            modes[role] = (quant_weights_mode(kw.get("quant_weights")),
                           bool(kw.get("int8_weights", False)))
        if len(set(modes.values())) > 1:
            raise ValueError(
                f"tiers ask for different (quant_weights, int8_weights) "
                f"{modes} over one shared model, whose Linears are "
                "converted in place; give every tier the same weight "
                "quantization")

    # -- replica lifecycle ---------------------------------------------------
    def _build_engine(self, role: str):
        if self._factory is not None:
            return self._factory(role)
        if self._model is None:
            raise ValueError("ServingRouter needs model= or "
                             "engine_factory=")
        from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
        kw = dict(self._engine_kwargs)
        if role == "prefill":
            kw.update(self._prefill_kwargs)
        elif role == "decode":
            kw.update(self._decode_kwargs)
        kw["role"] = role
        return ContinuousBatchingEngine(self._model, **kw)

    def _spawn(self, role: str, warm: bool = False) -> _Replica:
        rid = f"{role[0]}{self._next_replica}"
        self._next_replica += 1
        t0 = time.perf_counter()
        engine = self._build_engine(role)
        if warm:
            # capture the engine's programs before it takes traffic
            try:
                engine.aot_warmup()
            except Exception as e:  # noqa: BLE001 — a failed warm-up
                # leaves the engine eager: first-request latency only
                self._recorder.record("router.warm_failed", role=role,
                                      error=type(e).__name__)
        rep = _Replica(rid, engine, role)
        self._replicas[rid] = rep
        self._rebuild_ring()
        self._update_fleet_gauges()
        self._recorder.record("router.replica_spawn", replica=rid,
                              role=role,
                              spawn_s=round(time.perf_counter() - t0, 4))
        return rep

    def _rebuild_ring(self):
        ring: List[Tuple[int, str]] = []
        for rep in self._replicas.values():
            if rep.live and rep.decode_capable():
                for v in range(self._vnodes):
                    h = hashlib.sha1(
                        f"{rep.id}:{v}".encode()).digest()
                    ring.append((int.from_bytes(h[:8], "big"), rep.id))
        ring.sort()
        self._ring = ring

    def _update_fleet_gauges(self):
        counts: Dict[str, int] = {"mixed": 0, "prefill": 0, "decode": 0}
        for rep in self._replicas.values():
            if not rep.dead:
                counts[rep.role] += 1
            self._load_gauge.labels(replica=rep.id).set(
                float("nan") if rep.dead else rep.load)
        for role, n in counts.items():
            self._replica_gauge.labels(role=role).set(n)

    def scale_up(self, role: Optional[str] = None) -> str:
        """Spawn one replica (decode tier under disaggregation) through
        the warm cold-start path; returns its id."""
        role = role or ("decode" if self.disaggregated else "mixed")
        rep = self._spawn(role, warm=self._warm_on_spawn)
        self._metrics["scale"].labels(direction="up").inc()
        self._recorder.record("router.scale_up", replica=rep.id,
                              role=role)
        return rep.id

    def drain(self, replica_id: str) -> bool:
        """Elastic scale-down, phase 1: stop routing to the replica;
        its in-flight requests finish normally and the engine (with its
        block pool) is released once empty (phase 2, inside step())."""
        rep = self._replicas.get(replica_id)
        if rep is None or rep.dead or rep.draining:
            return False
        live_decode = [r for r in self._replicas.values()
                       if r.live and r.decode_capable()
                       and r.id != replica_id]
        if rep.decode_capable() and not live_decode:
            return False              # never drain the last decoder
        rep.draining = True
        self._rebuild_ring()
        self._metrics["scale"].labels(direction="down").inc()
        self._recorder.record("router.drain", replica=replica_id,
                              in_flight=len(rep.assigned))
        return True

    def scale_down(self) -> Optional[str]:
        """Drain the least-loaded drainable decode-capable replica."""
        cands = sorted(
            (r for r in self._replicas.values()
             if r.live and r.decode_capable()),
            key=lambda r: r.load)
        for rep in cands:
            if self.drain(rep.id):
                return rep.id
        return None

    def _finish_drains(self):
        for rid, rep in list(self._replicas.items()):
            if rep.draining and not rep.dead and not rep.assigned \
                    and not rep.engine.pending:
                rep.dead = True
                try:
                    rep.engine.close()
                except Exception:
                    pass
                del self._replicas[rid]
                self._recorder.record("router.drain_complete",
                                      replica=rid)
                self._update_fleet_gauges()

    def replicas(self) -> Dict[str, str]:
        """Live replica id -> role (introspection/tests)."""
        return {r.id: r.role for r in self._replicas.values()
                if not r.dead}

    # -- routing key ---------------------------------------------------------
    def _chain(self, prompt: np.ndarray) -> tuple:
        bs = self._block_size
        n = len(prompt) // bs
        if n == 0:
            # sub-block prompt: the whole prompt is the key
            return (tuple(int(t) for t in prompt),)
        return tuple(tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
                     for i in range(n))

    def _affine_lookup(self, chain: tuple) -> Optional[_Replica]:
        """Deepest previously-dispatched prefix whose replica is still
        live — the replica most likely to hold these KV blocks."""
        node, best = self._trie, None
        for blk in chain:
            node = node["children"].get(blk)
            if node is None:
                break
            rep = self._replicas.get(node["replica"])
            if rep is not None and rep.live and rep.decode_capable():
                best = rep
        return best

    def _register_chain(self, chain: tuple, replica_id: str):
        if self._trie_nodes >= self._affinity_cap:
            # bounded memory: a cold affinity map only costs a few
            # re-placements, never correctness
            self._trie = {"replica": None, "children": {}}
            self._trie_nodes = 0
        node = self._trie
        for blk in chain:
            child = node["children"].get(blk)
            if child is None:
                child = {"replica": replica_id, "children": {}}
                node["children"][blk] = child
                self._trie_nodes += 1
            node = child

    def _ring_lookup(self, chain: tuple) -> Optional[_Replica]:
        if not self._ring:
            return None
        h = hashlib.sha1(repr(chain).encode()).digest()
        key = int.from_bytes(h[:8], "big")
        i = bisect.bisect_right(self._ring, (key, ""))
        _, rid = self._ring[i % len(self._ring)]
        return self._replicas.get(rid)

    def _spill_bound(self, rep: _Replica) -> int:
        if self._spill_threshold is not None:
            return self._spill_threshold
        return 2 * getattr(rep.engine, "slots", 4)

    def _choose_decode(self, freq: _FleetRequest
                       ) -> Tuple[Optional[_Replica], str]:
        live = [r for r in self._replicas.values()
                if r.live and r.decode_capable()]
        if not live:
            return None, "none"
        rep = self._affine_lookup(freq.chain)
        kind = "affine"
        if rep is None:
            rep = self._ring_lookup(freq.chain) or live[0]
            kind = "hash"
        if rep.load >= self._spill_bound(rep):
            least = min(live, key=lambda r: r.load)
            if least is not rep and least.load < rep.load:
                rep, kind = least, "spill"
        self._metrics["affinity"].labels(result=kind).inc()
        return rep, kind

    def _choose_prefill(self) -> Optional[_Replica]:
        live = [r for r in self._replicas.values()
                if r.live and r.prefill_capable()
                and r.role == "prefill"]
        if not live:
            return None
        return min(live, key=lambda r: r.load)

    # -- public API ----------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int = 64,
                    timeout_s: Optional[float] = None) -> int:
        """Engine-compatible enqueue; raises
        :class:`~paddle_tpu_torch.robustness.QueueFullError` when the
        router's bounded queue is at capacity."""
        p = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self._max_queue is not None and \
                len(self._queue) >= self._max_queue:
            from paddle_tpu_torch.robustness import QueueFullError
            self._metrics["rejections"].labels(reason="queue_full").inc()
            self._recorder.record("router.reject", reason="queue_full",
                                  queue_depth=len(self._queue))
            raise QueueFullError(
                f"router queue at capacity ({self._max_queue}); "
                "retry with backoff or scale out")
        rid = self._next_rid
        self._next_rid += 1
        now = time.perf_counter()
        freq = _FleetRequest(
            rid=rid, prompt=p, max_new_tokens=max_new_tokens,
            deadline=(now + timeout_s) if timeout_s is not None
            else None,
            enqueued_at=now, chain=self._chain(p))
        freq.span = self._tracer.start_span(
            "router.request", rid=rid, prompt_len=len(p),
            max_new_tokens=max_new_tokens)
        self._requests[rid] = freq
        self._queue.append(freq)
        self._metrics["requests"].inc()
        self._recorder.record("router.enqueue", rid=rid,
                              prompt_len=len(p),
                              queue_depth=len(self._queue))
        return rid

    @property
    def pending(self) -> int:
        # parked sessions are intentionally dormant: they don't hold
        # slots and only re-enter the pipeline on resume(), so run()
        # must not spin on them
        return sum(1 for r in self._requests.values()
                   if r.phase not in ("done", "parked"))

    def finished(self):
        while self._done:
            yield self._done.popleft()

    def request_status(self, rid: int):
        return self._status.get(rid)

    def step(self) -> bool:
        """One router scheduling pass: expire, dispatch, service every
        replica (admissions + one engine step + retirements), complete
        handoffs/retries, finish drains, autoscale.  Engine-compatible:
        returns False when nothing is left."""
        self._expire()
        self._dispatch_queued()
        for rep in list(self._replicas.values()):
            self._service(rep)
        self._finish_drains()
        self._update_fleet_gauges()
        if self._autoscaler is not None:
            self._autoscaler.maybe()
        return self.pending > 0

    # bench/tests drive fleets and engines through one name
    poll = step

    def run(self):
        """Drain everything; returns {rid: (prompt, tokens)}."""
        while self.pending:
            self.step()
        return {rid: (p, out) for rid, p, out in self.finished()}

    def close(self):
        for rep in self._replicas.values():
            try:
                rep.engine.close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- scheduling internals ------------------------------------------------
    def _expire(self):
        now = time.perf_counter()
        # a parked session's deadline keeps ticking: expiry drops its
        # tier payload and retires it as "timeout"
        for rid, freq in list(self._parked_sessions.items()):
            if freq.deadline is not None and now > freq.deadline:
                del self._parked_sessions[rid]
                if self._kv_tier is not None:
                    self._kv_tier.discard(f"sess/{rid}")
                self._finalize(freq, [], "timeout")
        if not self._queue:
            return
        keep = deque()
        for freq in self._queue:
            if freq.deadline is not None and now > freq.deadline:
                self._finalize(freq, [], "timeout")
            else:
                keep.append(freq)
        self._queue = keep

    def _dispatch_queued(self):
        from paddle_tpu_torch.robustness import fault_point
        deferred = deque()
        while self._queue:
            freq = self._queue.popleft()
            resume = freq.phase == "handoff"
            if resume or not self.disaggregated:
                target, kind = self._choose_decode(freq)
                if kind == "none":
                    kind = "handoff" if resume else "fresh"
            else:
                target, kind = self._choose_prefill(), "prefill"
            if target is None:
                # no capable live replica right now (all dead or
                # draining): park; replica spawn or drain completion
                # unblocks it, deadlines bound the wait
                deferred.append(freq)
                continue
            kwargs = dict(max_new_tokens=freq.max_new_tokens,
                          router_enqueued_at=freq.enqueued_at,
                          span_parent=freq.span)
            if freq.deadline is not None:
                kwargs["timeout_s"] = max(
                    0.001, freq.deadline - time.perf_counter())
            if resume:
                kwargs["handoff"] = freq.handoff
            elif self.disaggregated:
                kwargs["prefill_only"] = True
            try:
                fault_point("router.dispatch", rid=freq.rid,
                            replica=target.id)
                eng_rid = target.engine.add_request(freq.prompt,
                                                    **kwargs)
            except Exception as e:
                freq.attempts += 1
                self._metrics["requeues"].labels(
                    reason="dispatch_error").inc()
                self._recorder.record(
                    "router.dispatch_failed", rid=freq.rid,
                    replica=target.id, error=type(e).__name__,
                    attempts=freq.attempts)
                fatal = isinstance(e, ValueError) \
                    or freq.attempts > self._max_retries
                self._emit_decision(
                    "requeue", rid=freq.rid,
                    chosen="abort" if fatal else "requeue",
                    reason="dispatch_error", replica=target.id,
                    error=type(e).__name__, attempts=freq.attempts)
                if fatal:
                    self._finalize(freq, [], "error")
                else:
                    freq.handoff = None     # retry = fresh prefill
                    freq.phase = "queued"
                    deferred.append(freq)
                continue
            freq.replica = target.id
            freq.engine_rid = eng_rid
            freq.phase = "decode" if resume or not self.disaggregated \
                else "prefill"
            freq.handoff = None
            freq.dispatched_at = time.perf_counter()
            target.assigned[eng_rid] = freq
            if target.decode_capable():
                self._register_chain(freq.chain, target.id)
            self._metrics["dispatch"].labels(replica=target.id,
                                             kind=kind).inc()
            # decision provenance: the chosen replica plus every
            # rejected candidate WITH its load score
            pool = [r for r in self._replicas.values() if r.live
                    and (r.prefill_capable() if kind == "prefill"
                         else r.decode_capable())]
            self._emit_decision(
                "route", rid=freq.rid,
                chosen={"replica": target.id, "load": target.load},
                alternatives=[{"replica": r.id, "load": r.load}
                              for r in pool if r.id != target.id],
                policy=kind, resume=resume, attempts=freq.attempts,
                queue_depth=len(self._queue))
        self._queue = deferred

    def _service(self, rep: _Replica):
        """Advance one replica: chaos kill-switch, one engine step,
        retirement collection."""
        if rep.dead:
            return
        from paddle_tpu_torch.robustness import fault_fires
        if (rep.assigned or rep.engine.pending) and fault_fires(
                "serving.replica_kill", replica=rep.id):
            self._on_replica_death(rep, reason="injected kill")
            return
        if not rep.engine.pending:
            return
        # a TTFT-fair pass: the prefill tier gets several engine steps
        # (its chunk dispatches are small — TTFT must not wait behind
        # the decode tier's deep fused chunks), and every replica may
        # drain a burst of queued admissions (host-only work) so a wave
        # of handoffs doesn't trickle in one admission per pass
        steps = self._prefill_steps if rep.role == "prefill" else 1
        steps += min(len(getattr(rep.engine, "_queue", ())),
                     getattr(rep.engine, "slots", 1))
        try:
            for _ in range(steps):
                if not rep.engine.pending:
                    break
                rep.engine.step()
        except Exception as e:
            # the engine's OWN containment already absorbed transient
            # faults; an escaped exception means the replica is gone
            self._on_replica_death(
                rep, reason=f"{type(e).__name__}: {str(e)[:120]}")
            return
        rep.ticks += 1
        if self._ckpt_steps and rep.assigned \
                and rep.ticks % self._ckpt_steps == 0:
            # replicate in-flight decode sessions to the peer tier under
            # their FLEET rid — the key a survivor will fetch them by
            try:
                rep.engine.checkpoint_sessions(
                    key_of=lambda erid, rep=rep: (
                        f"sess/{rep.assigned[erid].rid}"
                        if erid in rep.assigned else None))
            except Exception:  # noqa: BLE001 — checkpoint is
                # best-effort; a miss just means fresh prefill on death
                pass
        for eng_rid, _prompt, out in rep.engine.finished():
            freq = rep.assigned.pop(eng_rid, None)
            if freq is None:
                continue
            st = rep.engine.request_status(eng_rid)
            self._on_engine_finish(rep, freq, out, st)

    def _on_engine_finish(self, rep: _Replica, freq: _FleetRequest,
                          out: List[int], st):
        status = str(st) if st is not None else "ok"
        if status == "prefilled":
            self._do_handoff(rep, freq)
        elif status == "error" and freq.attempts < self._max_retries:
            # the replica survived (engine-level containment) but this
            # request's batch failed: fresh prefill, possibly elsewhere
            freq.attempts += 1
            freq.phase = "queued"
            freq.handoff = None
            freq.replica = None
            self._metrics["requeues"].labels(reason="engine_error").inc()
            self._emit_decision(
                "requeue", rid=freq.rid, chosen="requeue",
                reason="engine_error", replica=rep.id,
                attempts=freq.attempts,
                wasted_s=round(max(0.0, time.perf_counter()
                                   - freq.dispatched_at), 6)
                if freq.dispatched_at else 0.0)
            self._queue.appendleft(freq)
        else:
            self._finalize(freq, out, status, engine_status=st)

    def _do_handoff(self, rep: _Replica, freq: _FleetRequest):
        """Stream a prefilled request's KV blocks off the prefill
        replica and queue it for decode dispatch.  Any failure falls
        back to a fresh prefill on the decode tier — a lost transfer
        costs latency, never correctness."""
        from paddle_tpu_torch.inference.kv_cache import (deserialize_handoff,
                                                   serialize_handoff)
        from paddle_tpu_torch.robustness import fault_point
        t0 = time.perf_counter()
        try:
            fault_point("router.kv_transfer", rid=freq.rid,
                        replica=rep.id)
            payload = rep.engine.export_handoff(freq.engine_rid)
            if self._serialize:
                # the multi-process wire format, exercised in-process
                # too so the payload is provably transport-ready
                data = serialize_handoff(payload)
                self._metrics["handoff_bytes"].inc(len(data))
                payload = deserialize_handoff(data)
            transfer_s = time.perf_counter() - t0
            payload["transfer_s"] = transfer_s
            freq.handoff = payload
            freq.phase = "handoff"
            freq.engine_rid = None
            freq.replica = None
            self._metrics["handoffs"].labels(result="ok").inc()
            self._metrics["handoff_s"].observe(transfer_s)
            self._emit_decision("handoff", rid=freq.rid, chosen="ok",
                                from_replica=rep.id,
                                transfer_s=round(transfer_s, 6))
            self._queue.appendleft(freq)
        except Exception as e:
            try:
                rep.engine.discard_handoff(freq.engine_rid)
            except Exception:
                pass
            freq.attempts += 1
            freq.handoff = None
            freq.phase = "queued"
            freq.replica = None
            self._metrics["handoffs"].labels(result="fallback").inc()
            self._recorder.record(
                "router.handoff_failed", rid=freq.rid, replica=rep.id,
                error=type(e).__name__, attempts=freq.attempts)
            self._emit_decision(
                "handoff", rid=freq.rid, chosen="fallback",
                from_replica=rep.id, error=type(e).__name__,
                attempts=freq.attempts)
            if freq.attempts > self._max_retries:
                self._finalize(freq, [], "error")
            else:
                self._queue.appendleft(freq)

    def _migrate_session(self, rep: _Replica,
                         freq: "_FleetRequest") -> bool:
        """Death-recovery session migration: fetch the dead replica's
        checkpointed session from the KV tier and requeue it as a
        resume handoff — a survivor imports the blocks and continues
        decoding, token-identical (greedy chain determinism; a stale
        checkpoint just replays a few steps).  Returns False on tier
        miss or an injected ``session.migrate`` fault: the caller then
        degrades to the fresh-prefill requeue (recompute — slower,
        never wrong tokens, never a hang)."""
        if self._kv_tier is None:
            return False
        from paddle_tpu_torch.robustness.faults import fault_point
        try:
            fault_point("session.migrate", rid=freq.rid, replica=rep.id)
            payload = self._kv_tier.fetch(f"sess/{freq.rid}")
        except RuntimeError:
            self._recorder.record("router.migrate_fault", rid=freq.rid,
                                  replica=rep.id)
            return False
        if payload is None or payload.get("kv") is None:
            return False
        freq.handoff = payload
        freq.phase = "handoff"
        self._metrics["requeues"].labels(reason="session_migrate").inc()
        self._recorder.record("router.session_migrate", rid=freq.rid,
                              from_replica=rep.id,
                              tokens_out=int(
                                  len(payload.get("tokens_out", ()))))
        self._emit_decision("requeue", rid=freq.rid, chosen="migrate",
                            reason="session_migrate",
                            replica=rep.id, attempts=freq.attempts)
        self._queue.appendleft(freq)
        return True

    def _on_replica_death(self, rep: _Replica, reason: str):
        rep.dead = True
        self._metrics["deaths"].inc()
        self._recorder.record("router.replica_death", replica=rep.id,
                              reason=reason,
                              in_flight=len(rep.assigned))
        now = time.perf_counter()
        for eng_rid, freq in list(rep.assigned.items()):
            freq.attempts += 1
            freq.handoff = None
            freq.replica = None
            freq.engine_rid = None
            wasted = round(max(0.0, now - freq.dispatched_at), 6) \
                if freq.dispatched_at else 0.0
            if freq.attempts > self._max_retries:
                freq.phase = "queued"
                self._metrics["requeues"].labels(
                    reason="replica_death").inc()
                self._emit_decision(
                    "requeue", rid=freq.rid, chosen="abort",
                    reason="replica_death", replica=rep.id,
                    attempts=freq.attempts, wasted_s=wasted)
                self._finalize(freq, [], "error")
            elif self._migrate_session(rep, freq):
                pass  # requeued as a resume handoff (no recompute)
            else:
                freq.phase = "queued"
                self._metrics["requeues"].labels(
                    reason="replica_death").inc()
                self._emit_decision(
                    "requeue", rid=freq.rid, chosen="recompute",
                    reason="replica_death", replica=rep.id,
                    attempts=freq.attempts, wasted_s=wasted)
                self._queue.appendleft(freq)
        rep.assigned.clear()
        self._rebuild_ring()
        self._update_fleet_gauges()
        try:
            rep.engine.close()
        except Exception:
            pass

    def kill_replica(self, replica_id: str, reason: str = "drill"):
        """Declare a replica dead NOW (the replica-kill drill's direct
        entry; the chaos path is the ``serving.replica_kill`` fault
        point).  With a KV tier attached, checkpointed in-flight
        sessions migrate to survivors over the handoff wire (resume,
        not re-prefill); anything unreplicated re-queues for fresh
        prefill."""
        rep = self._replicas.get(replica_id)
        if rep is not None and not rep.dead:
            self._on_replica_death(rep, reason=reason)

    # ------------------------------------------------- session surface
    def park(self, rid: int) -> bool:
        """Park a decoding session fleet-wide: its owning engine spills
        the KV to the tier keyed by the FLEET rid and frees the slot;
        the router keeps resume ownership, so :meth:`resume` may land
        it on a different replica (migration without a death)."""
        freq = self._requests.get(rid)
        if freq is None or freq.phase != "decode" or \
                self._kv_tier is None:
            return False
        rep = self._replicas.get(freq.replica)
        if rep is None or rep.dead:
            return False
        key = rep.engine.park(freq.engine_rid, key=f"sess/{rid}",
                              detach=True)
        if key is None:
            return False
        rep.assigned.pop(freq.engine_rid, None)
        freq.engine_rid = None
        freq.replica = None
        freq.phase = "parked"
        self._parked_sessions[rid] = freq
        self._recorder.record("router.park", rid=rid, replica=rep.id)
        self._emit_decision("park", rid=rid, chosen="park", auto=False,
                            key=f"sess/{rid}", replica=rep.id)
        return True

    def resume(self, rid: int) -> bool:
        """Resume a fleet-parked session on whichever replica dispatch
        picks.  Tier hit → resume handoff (promotion); tier miss
        (fault/lost) → fresh prefill from the original prompt —
        token-identical either way (greedy chain determinism)."""
        freq = self._parked_sessions.pop(rid, None)
        if freq is None or freq.phase != "parked":
            return False
        payload = self._kv_tier.fetch(f"sess/{rid}") \
            if self._kv_tier is not None else None
        if self._kv_tier is not None:
            self._kv_tier.discard(f"sess/{rid}")
        if payload is not None and payload.get("kv") is not None:
            freq.handoff = payload
            freq.phase = "handoff"
        else:
            freq.handoff = None
            freq.phase = "queued"
        self._queue.append(freq)
        path = "promote" if freq.handoff is not None else "recompute"
        self._recorder.record("router.resume", rid=rid, path=path)
        self._emit_decision("resume", rid=rid, chosen=path, path=path,
                            key=f"sess/{rid}")
        return True

    def parked_rids(self):
        """Fleet rids of sessions parked at the router."""
        return list(self._parked_sessions.keys())

    def _finalize(self, freq: _FleetRequest, out: List[int],
                  status: str, engine_status=None):
        from paddle_tpu_torch.inference.serving import RequestStatus
        freq.phase = "done"
        freq.result = list(out)
        from paddle_tpu_torch.inference.serving import TIMING_KEYS
        timings = dict(getattr(engine_status, "timings", None) or {})
        # canonical schema: every engine-level key present,
        # 0.0 when the request never reached an engine at all
        for key in TIMING_KEYS:
            timings.setdefault(key, 0.0)
        timings["router_enqueued"] = freq.enqueued_at
        timings["attempts"] = float(freq.attempts)
        trace_id = freq.span.trace_id if freq.span is not None else None
        self._status[freq.rid] = RequestStatus(status, timings=timings,
                                               trace_id=trace_id)
        while len(self._status) > 8192:
            self._status.popitem(last=False)
        self._done.append((freq.rid, freq.prompt, freq.result))
        self._metrics["completions"].labels(status=status).inc()
        self._recorder.record("router.retire", rid=freq.rid,
                              status=status, generated=len(freq.result),
                              attempts=freq.attempts)
        # fleet-level retirement decision: authoritative for this rid
        # (the engine-local retirement is marked routed=True), carrying
        # the merged timings so a federated explain() needs no local
        # RequestStatus
        self._emit_decision(
            "retire", rid=freq.rid, chosen=status, status=status,
            source="router", generated=len(freq.result),
            attempts=freq.attempts, timings=timings)
        from paddle_tpu_torch.observability.forensics import \
            observe_retirement
        observe_retirement(timings)
        if freq.span is not None:
            freq.span.set_attribute("status", status)
            freq.span.set_attribute("generated", len(freq.result))
            freq.span.end()


# -- SLO-driven elasticity ---------------------------------------------------

class SloAutoscaler:
    """Replica count as a function of measured SLO pressure.

    Each evaluation window reads the DELTA of the engine-published
    ``paddle_tpu_serving_slo_total{kind,result}`` verdict counters
    (federation-safe: counters sum across hosts) and the router queue:

    * attainment below ``ttft_floor``/``tpot_floor`` (with at least
      ``min_requests`` fresh verdicts), or queue depth at/over
      ``queue_high`` → :meth:`ServingRouter.scale_up` (bounded by
      ``max_replicas`` decode-capable replicas);
    * an idle window (empty queue, every live replica under half its
      spill bound, no misses) → :meth:`ServingRouter.scale_down`
      (elastic drain, floored at ``min_replicas``).

    ``cooldown_s`` spaces actions so one bad window can't flap the
    fleet.  ``evaluate_once`` is the synchronous core (tests drive it
    with rigged counters); ``router.step()`` calls :meth:`maybe` on its
    own cadence when the autoscaler is attached."""

    def __init__(self, registry=None, ttft_floor: float = 0.9,
                 tpot_floor: float = 0.9, queue_high: int = 8,
                 min_requests: int = 8, min_replicas: int = 1,
                 max_replicas: int = 4, cooldown_s: float = 30.0,
                 interval_s: float = 1.0):
        if registry is None:
            from paddle_tpu_torch.observability import default_registry
            registry = default_registry()
        self.registry = registry
        self.ttft_floor = float(ttft_floor)
        self.tpot_floor = float(tpot_floor)
        self.queue_high = int(queue_high)
        self.min_requests = int(min_requests)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = float(cooldown_s)
        self.interval_s = float(interval_s)
        self._router: Optional[ServingRouter] = None
        self._snap: Dict[Tuple[str, str], float] = {}
        self._last_action: Optional[float] = None
        self._last_eval: Optional[float] = None
        self.actions: List[Tuple[float, str]] = []

    def bind(self, router: ServingRouter):
        self._router = router
        # seed the counter snapshot NOW: verdicts counted before this
        # autoscaler existed are history, not a fresh-window breach
        self._attainment()

    def _attainment(self) -> Dict[str, Optional[float]]:
        """Fresh-window hit rate per kind from counter deltas; None =
        too few verdicts this window to judge."""
        m = self.registry.get("paddle_tpu_serving_slo_total")
        out: Dict[str, Optional[float]] = {"ttft": None, "tpot": None}
        if m is None:
            return out
        cur: Dict[Tuple[str, str], float] = {}
        for values, child in m.series():
            labels = dict(zip(m.labelnames, values))
            cur[(labels.get("kind", ""),
                 labels.get("result", ""))] = child.value()
        for kind in ("ttft", "tpot"):
            hits = cur.get((kind, "hit"), 0.0) - \
                self._snap.get((kind, "hit"), 0.0)
            misses = cur.get((kind, "miss"), 0.0) - \
                self._snap.get((kind, "miss"), 0.0)
            total = hits + misses
            if total >= self.min_requests:
                out[kind] = hits / total
        self._snap = cur
        return out

    def maybe(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        if self._last_eval is not None and \
                now - self._last_eval < self.interval_s:
            return None
        return self.evaluate_once(now)

    def evaluate_once(self, now: Optional[float] = None
                      ) -> Optional[str]:
        router = self._router
        if router is None:
            return None
        now = time.monotonic() if now is None else now
        self._last_eval = now
        att = self._attainment()
        if self._last_action is not None and \
                now - self._last_action < self.cooldown_s:
            return None
        live = [r for r in router._replicas.values()
                if r.live and r.decode_capable()]
        queue = len(router._queue)
        breach = queue >= self.queue_high
        detail = f"queue={queue}"
        if att["ttft"] is not None and att["ttft"] < self.ttft_floor:
            breach = True
            detail += f" ttft_attainment={att['ttft']:.3f}"
        if att["tpot"] is not None and att["tpot"] < self.tpot_floor:
            breach = True
            detail += f" tpot_attainment={att['tpot']:.3f}"
        if breach and len(live) < self.max_replicas:
            rid = router.scale_up()
            self._stamp(now, "up")
            router._recorder.record("router.autoscale", direction="up",
                                    replica=rid, detail=detail)
            router._emit_decision(
                "autoscale", chosen={"direction": "up", "replica": rid},
                alternatives=[{"direction": "hold"}], detail=detail,
                queue=queue, live=len(live))
            return "up"
        idle = (queue == 0
                and all(r.load <= router._spill_bound(r) // 2
                        for r in live)
                and att["ttft"] in (None, 1.0)
                and att["tpot"] in (None, 1.0))
        if idle and len(live) > self.min_replicas:
            rid = router.scale_down()
            if rid is not None:
                self._stamp(now, "down")
                router._recorder.record("router.autoscale",
                                        direction="down", replica=rid)
                router._emit_decision(
                    "autoscale",
                    chosen={"direction": "down", "replica": rid},
                    alternatives=[{"direction": "hold"}],
                    queue=queue, live=len(live))
                return "down"
        return None

    def _stamp(self, now: float, direction: str):
        self._last_action = now
        self.actions.append((now, direction))


class SloAutoscaleRule(SloAttainmentRule):
    """The watchdog face of SLO elasticity: evaluated against a fleet
    aggregator's merged registry (or any registry carrying the
    ``paddle_tpu_slo_attainment`` gauge), a breach below the floor
    additionally SPAWNS a decode replica through the bound router's
    cold-start path — the alert and the remediation are one rule.
    Self-cooldowned (``scale_cooldown_s``) because a watchdog calls
    ``evaluate`` every interval regardless of its alert cooldown."""

    def __init__(self, router: ServingRouter, max_replicas: int = 4,
                 scale_cooldown_s: float = 60.0, **kwargs):
        super().__init__(**kwargs)
        self._router = router
        self.max_replicas = int(max_replicas)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self._last_scale: Optional[float] = None

    def evaluate(self, registry, now):
        detail = super().evaluate(registry, now)
        if not detail:
            return detail
        if self._last_scale is not None and \
                now - self._last_scale < self.scale_cooldown_s:
            return detail
        live = sum(1 for r in self._router._replicas.values()
                   if r.live and r.decode_capable())
        if live >= self.max_replicas:
            return detail + f" (at max_replicas={self.max_replicas})"
        rid = self._router.scale_up()
        self._last_scale = now
        return detail + f" -> spawned replica {rid}"


# -- multi-process worker loop ------------------------------------------------
#
# The in-process ServingRouter above IS the scheduler; what a multi-
# process fleet additionally needs is a driveable replica: one engine
# per process, bound to a TCPStore-contract store, consuming requests
# and publishing results/handoffs as serialize_handoff bytes.  This is
# that minimal worker loop; the tests drive it over an in-process
# LocalStore (observability.fleet), so the protocol is exercised without
# sockets (the TCPStore behind `main` is not ported yet).
#
# Store key protocol (all values are serialize_handoff blobs except the
# plain-int counters):
#   serve/worker/<id>             announce: json {role, pid, slots}
#   serve/<id>/seq                add()-counter a client bumps per request
#   serve/<id>/req/<seq>          request payload {prompt, max_new_tokens}
#                                 (+ a full handoff payload for resume)
#   serve/<id>/out/<seq>          result {tokens, status}, or the parked
#                                 prompt-KV handoff from a prefill worker
#   serve/<id>/stop               any value: drain and exit

class ReplicaWorker:
    """One serving engine bound to a store — the multi-process fleet's
    replica side.  ``poll()`` is one scheduling pass (drain inbox,
    one engine step, publish retirements); ``serve_forever()`` loops it
    until the stop key appears."""

    def __init__(self, store, engine, role: str = "mixed",
                 worker_id: Optional[str] = None):
        import json as _json
        self.store = store
        self.engine = engine
        self.role = role
        self.worker_id = worker_id or f"{role}{os.getpid()}"
        self._next_seq = 1
        self._seq_of: Dict[int, int] = {}
        self.served = 0
        store.set(f"serve/worker/{self.worker_id}", _json.dumps(
            {"role": role, "pid": os.getpid(),
             "slots": getattr(engine, "slots", 0)}))

    def _drain_inbox(self):
        from paddle_tpu_torch.inference.kv_cache import fetch_handoff
        while True:
            key = f"serve/{self.worker_id}/req/{self._next_seq}"
            payload = fetch_handoff(self.store, key)
            if payload is None:
                return
            prompt = np.asarray(payload["prompt"], np.int32)
            kwargs = {}
            if self.role == "prefill":
                kwargs["prefill_only"] = True
            elif "kv" in payload:
                kwargs["handoff"] = payload     # resume a prefilled req
            rid = self.engine.add_request(
                prompt, max_new_tokens=int(payload["max_new_tokens"]),
                **kwargs)
            self._seq_of[rid] = self._next_seq
            self._next_seq += 1

    def poll(self) -> bool:
        """One pass; True while the engine still has work."""
        from paddle_tpu_torch.inference.kv_cache import publish_handoff
        self._drain_inbox()
        if self.engine.pending:
            self.engine.step()
        for rid, _prompt, out in self.engine.finished():
            seq = self._seq_of.pop(rid, None)
            if seq is None:
                continue
            st = self.engine.request_status(rid)
            okey = f"serve/{self.worker_id}/out/{seq}"
            if str(st) == "prefilled":
                # the parked prompt KV goes on the wire; a decode
                # worker (or the router) resumes from it
                payload = self.engine.export_handoff(rid)
                payload["max_new_tokens"] = 0
                publish_handoff(self.store, okey, payload)
            else:
                publish_handoff(self.store, okey, {
                    "tokens": np.asarray(out, np.int32),
                    "status": str(st) if st is not None else "ok"})
            self.served += 1
        return self.engine.pending > 0

    def should_stop(self) -> bool:
        return self.store.check(f"serve/{self.worker_id}/stop")

    def serve_forever(self, poll_interval_s: float = 0.005,
                      max_steps: Optional[int] = None) -> int:
        """Loop until the stop key (drains in-flight first).  Returns
        requests served.  ``max_steps`` bounds the loop for tests."""
        steps = 0
        while max_steps is None or steps < max_steps:
            steps += 1
            busy = self.poll()
            if self.should_stop() and not self.engine.pending:
                break
            if not busy:
                time.sleep(poll_interval_s)
        return self.served


def submit_request(store, worker_id: str, prompt, max_new_tokens: int,
                   handoff: Optional[dict] = None) -> int:
    """Client side: enqueue one request to a worker; returns the seq to
    pass to :func:`fetch_result`.  ``handoff`` resumes a prefill
    worker's exported payload on a decode worker."""
    from paddle_tpu_torch.inference.kv_cache import publish_handoff
    seq = int(store.add(f"serve/{worker_id}/seq", 1))
    payload = dict(handoff) if handoff is not None else {}
    payload["prompt"] = np.asarray(prompt, np.int32)
    payload["max_new_tokens"] = int(max_new_tokens)
    publish_handoff(store, f"serve/{worker_id}/req/{seq}", payload)
    return seq


def fetch_result(store, worker_id: str, seq: int) -> Optional[dict]:
    """Result of :func:`submit_request` (None while pending): ``{tokens,
    status}``, or a prompt-KV handoff payload from a prefill worker."""
    from paddle_tpu_torch.inference.kv_cache import fetch_handoff
    return fetch_handoff(store, f"serve/{worker_id}/out/{seq}")


def main(argv=None) -> int:
    """``python -m paddle_tpu_torch.inference.router --store host:port
    --role decode|prefill``: one replica worker process bound to a
    TCPStore.  The store is ported (``distributed/tcp_store.py``); the
    worker process's launch is not yet, so it raises."""
    raise NotImplementedError(
        "the replica worker process is not ported yet (ROADMAP.md, queue "
        "1, item 8); drive ReplicaWorker in-process over a TCPStore or a "
        "LocalStore-contract store instead")


if __name__ == "__main__":
    import sys
    sys.exit(main())
