"""Tiered KV residency: HBM -> host RAM -> peer store (a copy of
``paddle_tpu/inference/kv_tier.py``).

The paged KV pool bounds resident serving state by its block count:
under pressure the prefix cache frees cold blocks, and a parked or
dead-replica session means fresh prefill.  This module adds the two
tiers below the card's memory, so demotion replaces deletion:

* **host tier** — an in-process LRU of serialized KV payloads (the
  handoff wire format, :func:`~kv_cache.serialize_handoff`), bounded by
  ``host_capacity_bytes``.
* **peer tier** — a store of the TCPStore contract (``set`` / ``get`` /
  ``check``; :class:`~paddle_tpu_torch.observability.fleet.LocalStore`
  in process) carrying the same bytes as chunked, adler32-checked blobs
  (:func:`_ship_blob` / :func:`_fetch_blob`, the JAX package's protocol
  from ``robustness/recovery.py``, kept here).  Entries written there
  survive the death of the replica that wrote them.

Every spill is written through to the peer tier when a store is
attached, so the host tier is a cache over the peer tier.

Fault points (:mod:`paddle_tpu_torch.robustness.faults`):
``kv_tier.spill`` drops a payload (both tiers; the caller falls back to
recompute later) and ``kv_tier.fetch`` reads as a miss.

Metrics (default registry): ``paddle_tpu_kv_tier_entries`` / ``_blocks``
/ ``_bytes`` by ``tier=host|peer``, ``paddle_tpu_kv_tier_fetch_total``,
``paddle_tpu_kv_tier_spills_total`` and
``paddle_tpu_kv_tier_promote_seconds``.
"""

from __future__ import annotations

import hashlib
import json
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

__all__ = ["KVTierManager", "prefix_block_key", "session_key"]

_PROMOTE_BUCKETS = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                    0.5, 1.0)

DEFAULT_CHUNK_BYTES = 8 * 1024 * 1024


def prefix_block_key(tokens) -> str:
    """Stable tier key for a full-block prefix chain (token ids)."""
    import numpy as np
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
    return "pfx/" + hashlib.sha1(arr.tobytes()).hexdigest()[:24]


def session_key(rid) -> str:
    """Tier key for a session, stable across replicas (router rid)."""
    return f"sess/{rid}"


class KVTierManager:
    """Spill/promote KV payloads across host-RAM and peer-store tiers.

    Payloads are the dicts produced by engine session export or
    ``PagedKVPool.export_blocks`` wrappers; they ride the handoff wire
    format so quantized blocks (int8 + per-block scales) round-trip
    bitwise and mixed-precision promotion reuses the import boundary's
    conversion.
    """

    def __init__(self, store=None, host_capacity_bytes: Optional[int] = None,
                 prefix: str = "kvtier", chunk_bytes: Optional[int] = None):
        from paddle_tpu_torch.observability.forensics import emit_decision
        from paddle_tpu_torch.observability.metrics import default_registry
        # tier decision provenance (forensics): ring-only, no wire
        self._emit_decision = emit_decision
        self.store = store
        self.prefix = prefix
        self.host_capacity_bytes = host_capacity_bytes
        self.chunk_bytes = int(chunk_bytes or DEFAULT_CHUNK_BYTES)
        # key -> (blob bytes, meta dict) — insertion order is LRU order
        self._host: "OrderedDict[str, tuple]" = OrderedDict()
        self._host_bytes = 0
        # local view of what we shipped to the peer store: key -> meta
        self._peer: Dict[str, dict] = {}
        self._peer_bytes = 0
        # keys whose fetch-miss decision was already emitted: admission
        # probes re-fetch the same absent key every engine step, and one
        # cold key must not flood the bounded flight-recorder ring
        self._miss_emitted: set = set()
        reg = default_registry()
        self._g_entries = reg.gauge(
            "paddle_tpu_kv_tier_entries",
            "Resident payloads per KV tier", labelnames=("tier",))
        self._g_blocks = reg.gauge(
            "paddle_tpu_kv_tier_blocks",
            "KV blocks resident per tier", labelnames=("tier",))
        self._g_bytes = reg.gauge(
            "paddle_tpu_kv_tier_bytes",
            "Serialized KV bytes resident per tier", labelnames=("tier",))
        self._c_fetch = reg.counter(
            "paddle_tpu_kv_tier_fetch_total",
            "Tier fetch outcomes", labelnames=("tier", "result"))
        self._c_spill = reg.counter(
            "paddle_tpu_kv_tier_spills_total",
            "Tier spill outcomes", labelnames=("tier", "result"))
        self._h_promote = reg.histogram(
            "paddle_tpu_kv_tier_promote_seconds",
            "Latency of tier fetch (promotion back toward HBM)",
            buckets=_PROMOTE_BUCKETS)
        self._refresh_gauges()

    # ------------------------------------------------------------- util
    @staticmethod
    def _payload_blocks(payload: Dict[str, Any]) -> int:
        kv = payload.get("kv") if isinstance(payload, dict) else None
        try:
            return int(kv["k"][0].shape[0]) if kv else 0
        except Exception:  # noqa: BLE001 — occupancy metric only
            return 0

    def _refresh_gauges(self):
        self._g_entries.labels(tier="host").set(float(len(self._host)))
        self._g_bytes.labels(tier="host").set(float(self._host_bytes))
        self._g_blocks.labels(tier="host").set(
            float(sum(m.get("blocks", 0) for _, m in self._host.values())))
        self._g_entries.labels(tier="peer").set(float(len(self._peer)))
        self._g_bytes.labels(tier="peer").set(float(self._peer_bytes))
        self._g_blocks.labels(tier="peer").set(
            float(sum(m.get("blocks", 0) for m in self._peer.values())))

    def _host_evict_to_cap(self):
        if self.host_capacity_bytes is None:
            return
        while self._host and self._host_bytes > self.host_capacity_bytes:
            _, (blob, _meta) = self._host.popitem(last=False)
            self._host_bytes -= len(blob)

    # ------------------------------------------------------------ spill
    def spill(self, key: str, payload: Dict[str, Any],
              kind: str = "session") -> bool:
        """Demote a payload out of HBM.  Returns True when it is
        resident in at least one tier afterwards; an injected
        ``kv_tier.spill`` fault (or a store error) degrades to a drop —
        the caller's block-free proceeds and a later fetch misses into
        the recompute path."""
        from paddle_tpu_torch.inference.kv_cache import serialize_handoff
        from paddle_tpu_torch.observability import flight_recorder
        from paddle_tpu_torch.robustness.faults import fault_point
        try:
            fault_point("kv_tier.spill", key=key, kind=kind)
        except RuntimeError:
            self._c_spill.labels(tier="host", result="fault").inc()
            flight_recorder().record("kv_tier.spill_fault", key=key,
                                     payload_kind=kind)
            self._emit_decision("tier", op="spill", chosen="drop",
                                key=key, payload_kind=kind,
                                result="fault")
            return False
        blob = serialize_handoff(payload)
        meta = {"kind": kind, "blocks": self._payload_blocks(payload),
                "bytes": len(blob), "time": time.time()}
        prev = self._host.pop(key, None)
        if prev is not None:
            self._host_bytes -= len(prev[0])
        self._host[key] = (blob, meta)
        self._host_bytes += len(blob)
        self._host_evict_to_cap()
        self._c_spill.labels(tier="host", result="ok").inc()
        if self.store is not None:
            try:
                _ship_blob(self.store, f"{self.prefix}/{key}", blob,
                           self.chunk_bytes, meta)
                if key not in self._peer:
                    self._peer_bytes += len(blob)
                else:
                    self._peer_bytes += len(blob) - \
                        int(self._peer[key].get("bytes", 0))
                self._peer[key] = meta
                self._c_spill.labels(tier="peer", result="ok").inc()
            except Exception as e:  # noqa: BLE001 — peer replica is
                # best-effort; the host copy still serves local resume
                self._c_spill.labels(tier="peer", result="error").inc()
                flight_recorder().record("kv_tier.peer_spill_failed",
                                         key=key, error=type(e).__name__)
        self._refresh_gauges()
        self._miss_emitted.discard(key)
        self._emit_decision(
            "tier", op="spill",
            chosen="host+peer" if key in self._peer else "host",
            key=key, payload_kind=kind, bytes=len(blob), result="ok")
        return True

    # ------------------------------------------------------------ fetch
    def fetch(self, key: str) -> Optional[Dict[str, Any]]:
        """Promote a payload back toward HBM.  ``None`` means tier miss
        (absent, corrupt, or injected ``kv_tier.fetch`` fault) and the
        caller must fall back to recompute."""
        from paddle_tpu_torch.inference.kv_cache import deserialize_handoff
        from paddle_tpu_torch.observability import flight_recorder
        from paddle_tpu_torch.robustness.faults import fault_point
        try:
            fault_point("kv_tier.fetch", key=key)
        except RuntimeError:
            self._c_fetch.labels(tier="host", result="fault").inc()
            flight_recorder().record("kv_tier.fetch_fault", key=key)
            if key not in self._miss_emitted:
                self._miss_emitted.add(key)
                self._emit_decision("tier", op="fetch", chosen="miss",
                                    key=key, result="fault")
            return None
        t0 = time.perf_counter()
        ent = self._host.get(key)
        if ent is not None:
            self._host.move_to_end(key)  # LRU touch
            self._c_fetch.labels(tier="host", result="hit").inc()
            out = deserialize_handoff(ent[0])
            self._h_promote.observe(time.perf_counter() - t0)
            self._miss_emitted.discard(key)
            self._emit_decision("tier", op="fetch", chosen="host",
                                key=key, result="hit")
            return out
        self._c_fetch.labels(tier="host", result="miss").inc()
        if self.store is not None:
            got = _fetch_blob(self.store, f"{self.prefix}/{key}")
            if got is not None:
                blob, meta = got
                self._c_fetch.labels(tier="peer", result="hit").inc()
                # re-admit into the host tier on the way up
                self._host[key] = (bytes(blob), dict(meta))
                self._host_bytes += len(blob)
                self._host_evict_to_cap()
                self._refresh_gauges()
                out = deserialize_handoff(bytes(blob))
                self._h_promote.observe(time.perf_counter() - t0)
                self._miss_emitted.discard(key)
                self._emit_decision("tier", op="fetch", chosen="peer",
                                    key=key, result="hit")
                return out
            self._c_fetch.labels(tier="peer", result="miss").inc()
        if key not in self._miss_emitted:
            self._miss_emitted.add(key)
            self._emit_decision("tier", op="fetch", chosen="miss",
                                key=key, result="miss")
        return None

    # ---------------------------------------------------- housekeeping
    def discard(self, key: str) -> bool:
        """Drop a payload from every tier (e.g. after final promotion).
        The store contract has no delete, so the peer meta key is
        blanked — ``_fetch_blob`` then reads the entry as absent."""
        hit = False
        ent = self._host.pop(key, None)
        if ent is not None:
            self._host_bytes -= len(ent[0])
            hit = True
        meta = self._peer.pop(key, None)
        if meta is not None:
            self._peer_bytes -= int(meta.get("bytes", 0))
            hit = True
            try:
                self.store.set(f"{self.prefix}/{key}/meta", b"")
            except Exception:  # noqa: BLE001 — store may be gone
                pass
        if hit:
            self._refresh_gauges()
        return hit

    def has(self, key: str) -> bool:
        if key in self._host:
            return True
        if self.store is not None:
            try:
                return bool(self.store.check(f"{self.prefix}/{key}/meta")
                            and self.store.get(f"{self.prefix}/{key}/meta",
                                               wait=False))
            except Exception:  # noqa: BLE001
                return False
        return False

    def stats(self) -> Dict[str, Any]:
        return {
            "host_entries": len(self._host),
            "host_bytes": int(self._host_bytes),
            "peer_entries": len(self._peer),
            "peer_bytes": int(self._peer_bytes),
        }


def _ship_blob(store, base: str, blob: bytes, chunk_bytes: int,
               meta: Dict[str, Any]):
    """Chunked publish: parts first, metadata (part count + per-part
    adler32 sums + total length) last — a reader that sees the meta key
    sees complete parts, and a torn/renamed-over publish verifies as
    absent rather than decoding into a corrupt state dict."""
    nparts = max(1, -(-len(blob) // chunk_bytes))
    sums = []
    for i in range(nparts):
        part = blob[i * chunk_bytes:(i + 1) * chunk_bytes]
        sums.append(zlib.adler32(part) & 0xFFFFFFFF)
        store.set(f"{base}/p{i}", part)
    meta = dict(meta)
    meta.update({"nparts": nparts, "bytes": len(blob),
                 "chunk_bytes": chunk_bytes, "adler32": sums})
    store.set(f"{base}/meta", json.dumps(meta).encode())


def _fetch_blob(store, base: str) -> Optional[Tuple[bytes, dict]]:
    """None when absent OR integrity-failed (logged) — a corrupt peer
    entry must read as a tier miss, never decode into a corrupt payload.
    Parts ride the store's bulk read when it has one
    (``get_many_into``)."""
    from paddle_tpu_torch.observability import flight_recorder
    if not store.check(f"{base}/meta"):
        return None
    try:
        meta = json.loads(store.get(f"{base}/meta", wait=False).decode())
        chunk = int(meta.get("chunk_bytes", DEFAULT_CHUNK_BYTES))
        nparts, total = int(meta["nparts"]), int(meta["bytes"])
        keys = [f"{base}/p{i}" for i in range(nparts)]
        if hasattr(store, "get_many_into") and total > 0:
            # zero-copy path: every part recv'd straight into its final
            # offset of one preallocated buffer (no per-part buffers,
            # no join)
            blob = bytearray(total)
            views = [memoryview(blob)[i * chunk:
                                      min((i + 1) * chunk, total)]
                     for i in range(nparts)]
            counts = store.get_many_into(keys, views)
            parts = [v[:c] for v, c in zip(views, counts)]
        else:
            parts = [store.get(k, wait=False) for k in keys]
            blob = parts[0] if len(parts) == 1 else b"".join(parts)
    except Exception as e:  # noqa: BLE001 — absent part == absent snapshot
        flight_recorder().record("kv_tier.fetch_failed", key=base,
                                 error=type(e).__name__)
        return None
    sums = meta.get("adler32") or []
    ok = len(parts) == len(sums) and \
        sum(len(p) for p in parts) == total and \
        all((zlib.adler32(p) & 0xFFFFFFFF) == int(s)
            for p, s in zip(parts, sums))
    if not ok:
        flight_recorder().record("kv_tier.fetch_corrupt", key=base,
                                 bytes=sum(len(p) for p in parts))
        return None
    return blob, meta
