"""Fast-recovery training (``paddle_tpu/robustness/recovery.py``):
peer-replicated in-memory snapshots of the training state, SDC sentinels
and the quarantine roster.

* **Peer snapshots** — :class:`PeerSnapshotter` serializes a rank's state
  every ``interval_steps`` steps on the handoff wire format
  (``inference/kv_cache.py``'s ``serialize_handoff``: raw little-endian
  buffers and a JSON head, no pickle), splits it into ``chunk_bytes``
  store values and ships them to its ring buddy's mailbox in the store
  (``buddy = (rank + 1) % world``), metadata (part count, per-part
  adler32, total length) last.  :func:`restore_from_peers` fetches and
  checks them; a torn or absent snapshot reads as None, and
  :func:`resume_train_state` then falls back to the disk checkpoint
  (``distributed/checkpoint.py``'s :class:`AutoCheckpoint`).
* **SDC sentinels** — :class:`SDCSentinel` publishes :func:`params_digest`
  of the parameters and compares it across data-parallel peers through
  the store.  A mismatch counts ``paddle_tpu_sdc_detected_total{host}``,
  dumps the flight recorder, blames by majority vote or, given a replay
  (:func:`deterministic_replay`), by the replayed digest, and
  quarantines the blamed host on the shared roster, under the JAX
  package's store keys.

:func:`params_digest` gives the JAX package's integer for the same bits
(``recovery.py:503-520``): from the FNV offset basis 2166136261, for each
leaf ``acc = acc * 16777619 + sum(uint32(bits))``, all mod 2**32.  The
leaf order is JAX's pytree order: dict keys sorted, lists and tuples in
order, None no leaf.  A leaf is taken as JAX takes it with 64-bit types
off: float64 / int64 / uint64 / complex128 narrowed to their 32-bit
types, Python ints int32, floats float32, bools bool; complex leaves sum
their (real, imag) parts, bools as uint8.  The per-leaf sums are one
launch on the card (``ops/kernels/multi_tensor.py``'s
``multi_tensor_digest``, reading the tensors in place); on the CPU the
plain version sums in bounded chunks.

Fault points: ``recovery.snapshot_ship`` (the ship fails; counted and
absorbed), ``recovery.peer_fetch`` (the fetch fails; the disk path
takes over), ``train.sdc_flip`` (one mantissa bit of the digested view
flipped) and ``recovery.rank_kill`` (the drill's rank death)."""

from __future__ import annotations

import json
import os
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "pack_state", "unpack_state", "flatten_for_checkpoint",
    "unflatten_from_checkpoint", "buddy_of", "buddy_map",
    "PeerSnapshotter", "restore_from_peers", "resume_train_state",
    "params_digest", "digest_leaves", "deterministic_replay",
    "SDCSentinel", "quarantine_host", "quarantined_hosts", "is_quarantined",
    "probe_quarantine", "clear_quarantine", "quarantine_ttl_s",
    "snapshotter_from_env",
]

_SNAP_PREFIX = "recovery"
_QUAR_ROSTER = "recovery/quarantined"
# bulk payloads: 8 MiB store values, fetched in parallel over the
# client's bulk connections (TCPStore.get_many_into)
DEFAULT_CHUNK_BYTES = 8 * 1024 * 1024


def _recovery_metrics():
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    return {
        "snapshots": reg.counter(
            "paddle_tpu_recovery_snapshots_total",
            "peer snapshots shipped (one per rank per cadence tick)"),
        "snapshot_errors": reg.counter(
            "paddle_tpu_recovery_snapshot_errors_total",
            "peer-snapshot ships that failed (store down, fault "
            "injection) — training continues, staleness grows"),
        "snapshot_bytes": reg.gauge(
            "paddle_tpu_recovery_snapshot_bytes",
            "serialized size of this rank's latest peer snapshot"),
        "snapshot_s": reg.histogram(
            "paddle_tpu_recovery_snapshot_seconds",
            "wall time serializing + shipping one peer snapshot",
            buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2, 10)),
        "restores": reg.counter(
            "paddle_tpu_recovery_restores_total",
            "post-failure state restores by path (peer RAM fetch vs "
            "disk checkpoint fallback)", labelnames=("path",)),
        "restore_s": reg.histogram(
            "paddle_tpu_recovery_restore_seconds",
            "wall time of the restore path (fetch + decode, or the "
            "disk validate + load fallback)",
            buckets=(0.001, 0.005, 0.02, 0.1, 0.5, 2, 10, 60)),
        "sdc": reg.counter(
            "paddle_tpu_sdc_detected_total",
            "cross-replica digest mismatches — silent data corruption "
            "detected, labeled by the blamed host ('' while "
            "unattributed)", labelnames=("host",)),
        "quarantined": reg.counter(
            "paddle_tpu_host_quarantined_total",
            "hosts quarantined after blame attribution",
            labelnames=("host",)),
    }


def _is_array(obj) -> bool:
    return torch.is_tensor(obj) or isinstance(obj, (np.ndarray, np.generic))


def _native(obj) -> bool:
    return obj is None or isinstance(obj, (bool, int, float, str))


# -- state <-> wire ----------------------------------------------------------

def _flatten_state(state) -> Tuple[Any, Dict[str, Any]]:
    """Nested dict/list state -> (tree spec, {"t<i>": array}), arrays in
    the walk's order (dict insertion order) as ``{"__t__": i}`` markers;
    JSON-native scalars stay in place."""
    arrays: Dict[str, Any] = {}

    def walk(obj):
        if isinstance(obj, dict):
            return {str(k): walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [walk(v) for v in obj]
        if _native(obj):
            return obj
        idx = len(arrays)
        arrays[f"t{idx}"] = obj if torch.is_tensor(obj) else np.asarray(obj)
        return {"__t__": idx}

    return walk(state), arrays


def _unflatten_state(tree, arrays: Dict[str, Any]):
    def walk(obj):
        if isinstance(obj, dict):
            if set(obj) == {"__t__"}:
                return arrays[f"t{obj['__t__']}"]
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        return obj

    return walk(tree)


def flatten_for_checkpoint(state) -> Dict[str, Any]:
    """Nested state_dict -> the flat ``{name: array}`` that
    ``save_state_dict`` takes: names are slash-joined paths, and the
    structure (JSON-native scalars like ``step`` included) rides a
    ``__tree__`` uint8 array."""
    arrays: Dict[str, Any] = {}

    def walk(obj, path):
        if isinstance(obj, dict):
            return {str(k): walk(v, path + [str(k)])
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [walk(v, path + [str(i)]) for i, v in enumerate(obj)]
        if _native(obj):
            return obj
        name = "/".join(path) or "value"
        while name in arrays:
            name += "_"
        arrays[name] = obj if torch.is_tensor(obj) else np.asarray(obj)
        return {"__t__": name}

    tree = walk(state, [])
    flat = dict(arrays)
    flat["__tree__"] = np.frombuffer(
        json.dumps(tree).encode(), dtype=np.uint8).copy()
    return flat


def _raw_bytes(a) -> bytes:
    if torch.is_tensor(a):
        return a.detach().to("cpu").contiguous().numpy().tobytes()
    return np.asarray(a).tobytes()


def unflatten_from_checkpoint(flat: Dict[str, Any]):
    """Inverse of :func:`flatten_for_checkpoint` (the tensors a
    checkpoint load returns stay tensors)."""
    tree = json.loads(_raw_bytes(flat["__tree__"]).decode())

    def walk(obj):
        if isinstance(obj, dict):
            if set(obj) == {"__t__"}:
                return flat[obj["__t__"]]
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        return obj

    return walk(tree)


def pack_state(state, **scalars) -> bytes:
    """A nested state_dict (tensors or arrays at the leaves) as one blob
    on the handoff wire format, the JAX package's bytes for the same
    arrays; ``scalars`` (step, rank, ...) ride the head."""
    from paddle_tpu_torch.inference.kv_cache import serialize_handoff
    tree, arrays = _flatten_state(state)
    payload: Dict[str, Any] = {"tree": json.dumps(tree)}
    payload.update(scalars)
    payload.update(arrays)
    return serialize_handoff(payload)


def unpack_state(data) -> Tuple[Any, Dict[str, Any]]:
    """Inverse of :func:`pack_state`: ``(state, scalars)``; arrays come
    back as numpy arrays (CPU tensors for bfloat16 and float8_e4m3fn)
    viewing `data`."""
    from paddle_tpu_torch.inference.kv_cache import deserialize_handoff
    payload = deserialize_handoff(data)
    tree = json.loads(payload.pop("tree"))
    arrays = {k: v for k, v in payload.items() if _is_array(v)}
    scalars = {k: v for k, v in payload.items() if k not in arrays}
    return _unflatten_state(tree, arrays), scalars


# -- buddy topology ----------------------------------------------------------

def buddy_of(rank: int, world_size: int, offset: int = 1) -> int:
    """Ring-wise buddy: the rank that mirrors `rank`'s shard."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    return (rank + offset) % world_size


def buddy_map(world_size: int, offset: int = 1) -> Dict[int, int]:
    return {r: buddy_of(r, world_size, offset) for r in range(world_size)}


# -- peer snapshots ----------------------------------------------------------

class PeerSnapshotter:
    """Ships this rank's state to its ring buddy through the store every
    ``interval_steps`` steps; :meth:`fetch_buddy` mirrors the buddy's blob
    into this process's memory, and :meth:`serve_held` re-publishes it."""

    def __init__(self, store, rank: int, world_size: int,
                 interval_steps: int = 10, prefix: str = _SNAP_PREFIX,
                 generation: int = 0,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES):
        if interval_steps < 1:
            raise ValueError("interval_steps must be >= 1, got "
                             f"{interval_steps}")
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.buddy = buddy_of(self.rank, self.world_size)
        self.interval = int(interval_steps)
        self.prefix = prefix
        self.generation = int(generation)
        self.chunk_bytes = int(chunk_bytes)
        self.last_step: Optional[int] = None
        self._held: Dict[int, bytes] = {}   # peer rank -> mirrored blob
        self._metrics = _recovery_metrics()

    def maybe_snapshot(self, step: int, state) -> bool:
        """Ship when ``step`` hits the interval; True when shipped."""
        if step % self.interval:
            return False
        return self.snapshot(step, state)

    def snapshot(self, step: int, state) -> bool:
        """Serialize and ship now.  A failed ship (store down, armed
        ``recovery.snapshot_ship``) is counted and absorbed: the previous
        snapshot stays serveable."""
        from paddle_tpu_torch.observability import flight_recorder
        from paddle_tpu_torch.robustness import fault_point
        t0 = time.perf_counter()
        blob = pack_state(state, step=int(step), rank=self.rank,
                          generation=self.generation)
        try:
            fault_point("recovery.snapshot_ship", rank=self.rank,
                        step=int(step))
            _ship_blob(self.store, f"{self.prefix}/snap/{self.rank}",
                       blob, self.chunk_bytes,
                       meta={"step": int(step), "rank": self.rank,
                             "generation": self.generation,
                             "time": time.time()})
        except RuntimeError as e:
            self._metrics["snapshot_errors"].inc()
            flight_recorder().record("recovery.snapshot_failed",
                                     rank=self.rank, step=int(step),
                                     error=type(e).__name__)
            return False
        self.last_step = int(step)
        self._metrics["snapshots"].inc()
        self._metrics["snapshot_bytes"].set(len(blob))
        self._metrics["snapshot_s"].observe(time.perf_counter() - t0)
        flight_recorder().record("recovery.snapshot", rank=self.rank,
                                 step=int(step), bytes=len(blob))
        return True

    def fetch_buddy(self) -> Optional[int]:
        """Pull the buddy's current snapshot into this process's RAM;
        returns the mirrored step, or None when there is none."""
        got = _fetch_blob(self.store, f"{self.prefix}/snap/{self.buddy}")
        if got is None:
            return None
        blob, meta = got
        self._held[self.buddy] = blob
        return int(meta.get("step", -1))

    def serve_held(self, rank: Optional[int] = None):
        """Re-publish a mirrored peer blob (the store lost the key)."""
        rank = self.buddy if rank is None else int(rank)
        blob = self._held.get(rank)
        if blob is None:
            raise KeyError(f"no mirrored snapshot held for rank {rank}")
        _, scalars = unpack_state(blob)
        _ship_blob(self.store, f"{self.prefix}/snap/{rank}", blob,
                   self.chunk_bytes,
                   meta={"step": int(scalars.get("step", -1)),
                         "rank": rank,
                         "generation": int(scalars.get("generation", 0)),
                         "time": time.time()})


def _ship_blob(store, base: str, blob, chunk_bytes: int,
               meta: Dict[str, Any]):
    """Chunked publish: parts first, the metadata (part count, per-part
    adler32, total length) last, so a reader that sees the metadata sees
    complete parts."""
    view = memoryview(blob)
    nparts = max(1, -(-len(view) // chunk_bytes))
    sums = []
    for i in range(nparts):
        part = view[i * chunk_bytes:(i + 1) * chunk_bytes]
        sums.append(zlib.adler32(part) & 0xFFFFFFFF)
        store.set(f"{base}/p{i}", bytes(part))
    meta = dict(meta)
    meta.update({"nparts": nparts, "bytes": len(view),
                 "chunk_bytes": chunk_bytes, "adler32": sums})
    store.set(f"{base}/meta", json.dumps(meta).encode())


def _fetch_blob(store, base: str):
    """``(blob, meta)``, or None when absent or failing its checks."""
    from paddle_tpu_torch.observability import flight_recorder
    if not store.check(f"{base}/meta"):
        return None
    try:
        meta = json.loads(store.get(f"{base}/meta", wait=False).decode())
        chunk = int(meta.get("chunk_bytes", DEFAULT_CHUNK_BYTES))
        nparts, total = int(meta["nparts"]), int(meta["bytes"])
        keys = [f"{base}/p{i}" for i in range(nparts)]
        if hasattr(store, "get_many_into") and total > 0:
            # every part received straight into its offset of one buffer
            blob = bytearray(total)
            views = [memoryview(blob)[i * chunk:min((i + 1) * chunk, total)]
                     for i in range(nparts)]
            counts = store.get_many_into(keys, views)
            parts = [v[:c] for v, c in zip(views, counts)]
        else:
            parts = [store.get(k, wait=False) for k in keys]
            blob = parts[0] if len(parts) == 1 else b"".join(parts)
    except Exception as e:  # noqa: BLE001 — absent part == absent snapshot
        flight_recorder().record("recovery.fetch_failed", key=base,
                                 error=type(e).__name__)
        return None
    sums = meta.get("adler32") or []
    ok = len(parts) == len(sums) and \
        sum(len(p) for p in parts) == total and \
        all((zlib.adler32(p) & 0xFFFFFFFF) == int(s)
            for p, s in zip(parts, sums))
    if not ok:
        flight_recorder().record("recovery.fetch_corrupt", key=base,
                                 bytes=sum(len(p) for p in parts))
        return None
    return blob, meta


def restore_from_peers(store, rank: int, prefix: str = _SNAP_PREFIX):
    """``(step, state, meta)`` of rank's latest peer snapshot, or None
    (absent, torn, or an armed ``recovery.peer_fetch``)."""
    from paddle_tpu_torch.observability import flight_recorder
    from paddle_tpu_torch.robustness import fault_point
    try:
        fault_point("recovery.peer_fetch", rank=int(rank))
        got = _fetch_blob(store, f"{prefix}/snap/{rank}")
    except RuntimeError as e:
        flight_recorder().record("recovery.peer_fetch_failed",
                                 rank=int(rank), error=type(e).__name__)
        return None
    if got is None:
        return None
    blob, meta = got
    state, scalars = unpack_state(blob)
    return int(scalars.get("step", meta.get("step", -1))), state, meta


def resume_train_state(store, rank: int, auto_ckpt=None,
                       prefix: str = _SNAP_PREFIX, mesh=None, specs=None,
                       device=None):
    """Peer RAM first, disk second: ``(step, state, path)`` with ``path``
    in {"peer", "disk", "none"}, recorded to the restore metrics and the
    flight recorder.  The disk state's tensors land on `device`."""
    from paddle_tpu_torch.observability import flight_recorder
    m = _recovery_metrics()
    t0 = time.perf_counter()
    if store is not None:
        peer = restore_from_peers(store, rank, prefix=prefix)
        if peer is not None:
            step, state, _meta = peer
            dt = time.perf_counter() - t0
            m["restores"].labels(path="peer").inc()
            m["restore_s"].observe(dt)
            flight_recorder().record("recovery.restore", rank=int(rank),
                                     path="peer", step=step,
                                     seconds=round(dt, 4))
            return step, state, "peer"
    if auto_ckpt is not None:
        step, state = auto_ckpt.restore_latest(mesh=mesh, specs=specs,
                                               device=device)
        if isinstance(state, dict) and "__tree__" in state:
            state = unflatten_from_checkpoint(state)
        if step is not None:
            dt = time.perf_counter() - t0
            m["restores"].labels(path="disk").inc()
            m["restore_s"].observe(dt)
            flight_recorder().record("recovery.restore", rank=int(rank),
                                     path="disk", step=step,
                                     seconds=round(dt, 4))
            return step, state, "disk"
    flight_recorder().record("recovery.restore", rank=int(rank),
                             path="none")
    return None, None, "none"


def snapshotter_from_env(store=None, interval_steps: Optional[int] = None
                         ) -> Optional[PeerSnapshotter]:
    """The worker's snapshotter from the env the elastic manager sets
    (``PADDLE_TPU_RECOVERY=peer``, ``PADDLE_ELASTIC_STORE``, the trainer
    id and count); None when peer recovery is off."""
    if os.environ.get("PADDLE_TPU_RECOVERY") != "peer":
        return None
    if store is None:
        addr = os.environ.get("PADDLE_ELASTIC_STORE")
        if not addr:
            return None
        from paddle_tpu_torch.distributed.tcp_store import TCPStore
        host, port = addr.rsplit(":", 1)
        store = TCPStore(host, int(port), is_master=False)
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if interval_steps is None:
        interval_steps = int(os.environ.get(
            "PADDLE_TPU_SNAPSHOT_INTERVAL", "10"))
    gen = int(os.environ.get("PADDLE_ELASTIC_GEN", "0"))
    return PeerSnapshotter(store, rank, world,
                           interval_steps=interval_steps, generation=gen)


# -- the digest --------------------------------------------------------------

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32, torch.complex128: torch.complex64}


def _leaf_tensor(x) -> torch.Tensor:
    """A leaf as JAX takes it (64-bit types narrowed, Python scalars as
    int32 / float32 / bool), then as the bits the digest sums: complex
    as its (real, imag) floats, bool as uint8; contiguous."""
    if torch.is_tensor(x):
        t = x.detach()
    elif isinstance(x, bool):
        t = torch.tensor(x)
    elif isinstance(x, int):
        t = torch.tensor(np.int64(x).astype(np.int32))
    elif isinstance(x, float):
        t = torch.tensor(np.float32(x))
    else:
        from paddle_tpu_torch.nn.layer import _from_numpy
        t = _from_numpy(np.asarray(x))
    if t.dtype in _NARROW:
        t = t.to(_NARROW[t.dtype])
    if t.is_complex():
        t = torch.view_as_real(t)
    if t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.contiguous()


def digest_leaves(tree) -> List[torch.Tensor]:
    """The tree's leaves in JAX's pytree order (dict keys sorted, None
    no leaf), each as :func:`_leaf_tensor` gives it."""
    out: List[torch.Tensor] = []

    def walk(obj):
        if obj is None:
            return
        if isinstance(obj, dict):
            for k in sorted(obj):
                walk(obj[k])
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
        elif isinstance(obj, str):
            raise TypeError("params_digest: a string is not an array leaf")
        else:
            out.append(_leaf_tensor(obj))

    walk(tree)
    return out


def params_digest(tree) -> int:
    """Bitwise checksum of a tree of tensors / arrays, the JAX package's
    integer for the same bits.  Equal across data-parallel replicas;
    any divergence is silent corruption.  A tree with leaves on a CUDA
    device is digested there by one ``multi_tensor_digest`` launch, its
    tensors in place and its host leaves (Python scalars, numpy arrays:
    an ``extra`` beside the parameters) copied to the card; leaves on
    two CUDA devices raise."""
    from paddle_tpu_torch.ops.kernels.multi_tensor import multi_tensor_digest
    leaves = digest_leaves(tree)
    if not leaves:
        return 2166136261
    cards = {t.device for t in leaves if t.device.type != "cpu"}
    if len(cards) > 1:
        raise ValueError(f"params_digest: the leaves lie on "
                         f"{sorted(map(str, cards))}; digest each "
                         f"device's tree on its own")
    if cards:
        card = cards.pop()
        leaves = [t if t.device == card else t.to(card) for t in leaves]
    out = multi_tensor_digest(leaves)
    return int(out[-1].item()) & 0xFFFFFFFF


def _flip_one_bit(tree):
    """The injectable SDC: a copy of the tree with the lowest bit of the
    first element of its first float leaf (in pytree order) flipped."""
    state = {"flipped": False}
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    def flip(x):
        t = _leaf_tensor(x) if not torch.is_tensor(x) else x.detach()
        if state["flipped"] or not t.is_floating_point() or not t.numel():
            return x
        t = t.clone().contiguous()
        flat = t.view(ints[t.element_size()]).view(-1)
        flat[0] ^= 1
        state["flipped"] = True
        return t

    def walk(obj):
        if isinstance(obj, dict):
            return {k: walk(obj[k]) for k in sorted(obj)}
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(v) for v in obj)
        if obj is None or isinstance(obj, str):
            return obj
        return flip(obj)

    return walk(tree)


def deterministic_replay(state, run_fn: Callable[[Any], Any]) -> int:
    """Blame confirmation: re-run the divergent step(s) from the last
    peer snapshot (``run_fn(state) -> params``) and digest the result,
    the ground truth against which a corrupt peer disagrees."""
    from paddle_tpu_torch.observability import flight_recorder
    t0 = time.perf_counter()
    params = run_fn(state)
    d = params_digest(params)
    flight_recorder().record("sdc.replay", digest=d,
                             seconds=round(time.perf_counter() - t0, 4))
    return d


class SDCSentinel:
    """Periodic cross-replica digest check over the store:
    :meth:`publish` ships this rank's digest, :meth:`verify` collects the
    peers' (a bounded wait) and judges, :meth:`check` does both at the
    cadence."""

    def __init__(self, store, rank: int, dp_peers: Sequence[int],
                 host: Optional[str] = None, interval_steps: int = 1,
                 prefix: str = "sdc", timeout: float = 10.0,
                 quarantine: bool = True):
        if interval_steps < 1:
            raise ValueError("interval_steps must be >= 1, got "
                             f"{interval_steps}")
        self.store = store
        self.rank = int(rank)
        self.dp_peers = sorted(int(r) for r in dp_peers)
        if self.rank not in self.dp_peers:
            self.dp_peers.append(self.rank)
            self.dp_peers.sort()
        if host is None:
            from paddle_tpu_torch.observability.fleet import fleet_host_id
            host = fleet_host_id()
        self.host = host
        self.interval = int(interval_steps)
        self.prefix = prefix
        self.timeout = float(timeout)
        self.quarantine = bool(quarantine)
        self._metrics = _recovery_metrics()

    def publish(self, step: int, params, extra=None) -> int:
        """Digest and publish for ``step`` (an armed ``train.sdc_flip``
        corrupts the digested view); returns the published digest."""
        from paddle_tpu_torch.robustness import fault_fires
        tree = (params, extra) if extra is not None else params
        if fault_fires("train.sdc_flip", rank=self.rank, step=int(step)):
            tree = _flip_one_bit(tree)
        d = params_digest(tree)
        self.store.set(f"{self.prefix}/{int(step)}/{self.rank}",
                       json.dumps({"digest": d, "host": self.host,
                                   "rank": self.rank}).encode())
        return d

    def verify(self, step: int, replay: Optional[Callable[[], int]] = None,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        """Collect every peer's digest for ``step`` (bounded wait) and
        judge: ``ok``, ``digests``, ``blamed`` ranks, ``blamed_hosts``,
        ``quarantined`` hosts, ``missing`` peers (skipped, not blamed)."""
        from paddle_tpu_torch.observability import flight_recorder
        deadline = time.monotonic() + (self.timeout if timeout is None
                                       else timeout)
        reports: Dict[int, dict] = {}
        pending = list(self.dp_peers)
        while pending:
            still = []
            for r in pending:
                key = f"{self.prefix}/{int(step)}/{r}"
                if self.store.check(key):
                    reports[r] = json.loads(
                        self.store.get(key, wait=False).decode())
                else:
                    still.append(r)
            pending = still
            if not pending or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        digests = {r: int(rep["digest"]) for r, rep in reports.items()}
        verdict: Dict[str, Any] = {
            "checked": True, "step": int(step), "digests": digests,
            "missing": pending, "blamed": [], "blamed_hosts": [],
            "quarantined": [], "replayed": False,
        }
        if len(digests) < 2 or len(set(digests.values())) == 1:
            verdict["ok"] = True
            return verdict
        verdict["ok"] = False
        # a replay is ground truth when offered; else strict majority
        truth: Optional[int] = None
        if replay is not None:
            truth = int(replay())
            verdict["replayed"] = True
        else:
            counts: Dict[int, int] = {}
            for d in digests.values():
                counts[d] = counts.get(d, 0) + 1
            top, n = max(counts.items(), key=lambda kv: kv[1])
            if n * 2 > len(digests):
                truth = top
        if truth is not None:
            blamed = sorted(r for r, d in digests.items() if d != truth)
            verdict["blamed"] = blamed
            verdict["blamed_hosts"] = sorted(
                {reports[r]["host"] for r in blamed})
        for h in (verdict["blamed_hosts"] or [""]):
            self._metrics["sdc"].labels(host=h).inc()
        flight_recorder().record(
            "sdc.detected", step=int(step),
            digests={str(r): d for r, d in digests.items()},
            blamed=verdict["blamed"], blamed_hosts=verdict["blamed_hosts"],
            replayed=verdict["replayed"])
        flight_recorder().dump(
            reason=f"sdc digest mismatch at step {step} "
                   f"(blamed: {verdict['blamed_hosts'] or 'unattributed'})")
        if self.quarantine:
            for h in verdict["blamed_hosts"]:
                quarantine_host(self.store, h, reason=f"sdc@step{int(step)}")
                verdict["quarantined"].append(h)
        return verdict

    def check(self, step: int, params, extra=None,
              replay: Optional[Callable[[], int]] = None) -> Dict[str, Any]:
        """Cadence-gated publish + verify (the training-loop hook)."""
        if step % self.interval:
            return {"checked": False, "ok": True}
        self.publish(step, params, extra=extra)
        return self.verify(step, replay=replay)


# -- quarantine roster -------------------------------------------------------

def quarantine_host(store, host: str, reason: str = "sdc"):
    """Record ``host`` on the shared roster (the JAX package's keys: an
    elastic agent of either package reads it before re-registering)."""
    from paddle_tpu_torch.observability import flight_recorder
    store.set(f"{_QUAR_ROSTER}/{host}",
              json.dumps({"reason": reason, "time": time.time()}).encode())
    # the comma-joined roster, re-asserted on every write
    known = set(quarantined_hosts(store))
    known.add(host)
    store.set(_QUAR_ROSTER, ",".join(sorted(known)).encode())
    _recovery_metrics()["quarantined"].labels(host=host).inc()
    flight_recorder().record("recovery.quarantine", host=host,
                             reason=reason)


def quarantine_ttl_s() -> Optional[float]:
    """``PADDLE_TPU_QUARANTINE_TTL_S``: past it a quarantined host reads
    as re-admitted; unset, empty or <= 0 means no expiry."""
    raw = os.environ.get("PADDLE_TPU_QUARANTINE_TTL_S", "").strip()
    try:
        ttl = float(raw)
    except ValueError:
        return None
    return ttl if ttl > 0 else None


def _quarantine_expired(rec: dict, now: Optional[float] = None) -> bool:
    ttl = quarantine_ttl_s()
    if ttl is None:
        return False
    stamp = rec.get("time")
    if not isinstance(stamp, (int, float)):
        return False            # no timestamp: fail closed
    return (now if now is not None else time.time()) - stamp > ttl


def quarantined_hosts(store) -> Dict[str, dict]:
    """host -> {reason, time} of every host still in quarantine (past the
    TTL filtered out)."""
    try:
        if not store.check(_QUAR_ROSTER):
            return {}
        names = [h for h in store.get(_QUAR_ROSTER,
                                      wait=False).decode().split(",") if h]
    except Exception:
        return {}
    now = time.time()
    out: Dict[str, dict] = {}
    for h in names:
        try:
            rec = json.loads(store.get(f"{_QUAR_ROSTER}/{h}",
                                       wait=False).decode())
        except Exception:
            rec = {}
        if not _quarantine_expired(rec, now):
            out[h] = rec
    return out


def is_quarantined(store, host: str) -> bool:
    """Read-only, TTL-aware roster check."""
    try:
        if not store.check(_QUAR_ROSTER):
            return False
        if host not in store.get(_QUAR_ROSTER,
                                 wait=False).decode().split(","):
            return False
        try:
            rec = json.loads(store.get(f"{_QUAR_ROSTER}/{host}",
                                       wait=False).decode())
        except Exception:
            return True     # on the roster, record unreadable
        return not _quarantine_expired(rec)
    except Exception:
        return False


def probe_quarantine(store, host: str) -> bool:
    """True when ``host`` may rejoin; an expired entry is retired from
    the roster so every later reader agrees."""
    from paddle_tpu_torch.observability import flight_recorder
    if not is_quarantined(store, host):
        try:
            names = store.get(_QUAR_ROSTER, wait=False).decode() \
                if store.check(_QUAR_ROSTER) else ""
        except Exception:
            names = ""
        if host in names.split(","):
            clear_quarantine(store, host)
            flight_recorder().record("recovery.quarantine_expired",
                                     host=host, ttl_s=quarantine_ttl_s())
        return True
    return False


def clear_quarantine(store, host: Optional[str] = None):
    """Operator override: re-admit ``host`` (or everyone).  The store has
    no delete: the roster is rewritten and the record blanked."""
    known = set(quarantined_hosts(store))
    doomed = set(known) if host is None else ({host} & known)
    for h in doomed:
        store.set(f"{_QUAR_ROSTER}/{h}", b"")
        known.discard(h)
    store.set(_QUAR_ROSTER, ",".join(sorted(known)).encode())
