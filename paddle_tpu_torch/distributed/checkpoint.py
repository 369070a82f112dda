"""Checkpoints on disk (``paddle_tpu/distributed/checkpoint.py``): the
JAX package's format 2, file for file and byte for byte, written and read
by one process.

    path/
      index.0.json                    # the shard index
      <name>.shard.<0-d0>_<0-d1>.npy  # one file per tensor, the whole of it
      checkpoint_meta.json            # the sentinel, written last

A shard is published atomically (``_write_shard``: a temporary file, its
digest, then ``os.replace``), and the index records each file's bytes and
crc32 (and sha256 under ``PADDLE_TPU_CKPT_DIGEST=sha256``), which
:func:`validate_checkpoint` and the loader check.  Format 1 (one global
``.npy`` per tensor) still loads.

``.npy`` files of bfloat16 and float8_e4m3fn are what ``np.save`` writes
for the ``ml_dtypes`` arrays the JAX package hands it (header descr
``'<V2'`` / ``'<V1'``, the raw bits after it), and the index says
``"dtype": "bfloat16"``: the port writes that header itself and reads
such a file through an int16 / uint8 view, so it needs no ``ml_dtypes``.

``save_state_dict`` takes torch tensors (any device) or numpy arrays;
``load_state_dict`` returns tensors on ``device`` (``cuda`` unless the
caller asks for another).  ``mesh=`` / ``specs=`` (re-sharding on load)
and multi-process saves wait (ROADMAP.md, queue 1, item 8).

Chaos: the fault points ``checkpoint.shard_write`` (a crash between the
write and the rename) and ``checkpoint.torn_shard`` (the file truncated
after its digest was taken).  Metrics, spans and recorder events are the
JAX package's."""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_state_dict", "load_state_dict", "async_save_state_dict",
           "validate_checkpoint", "Converter", "AutoCheckpoint"]

_SENTINEL = "checkpoint_meta.json"

_log = logging.getLogger("paddle_tpu.robustness.checkpoint")

_DURATION_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1, 5, 15, 60, 300, 900)

# dtype names of the index <-> torch dtypes
_TORCH = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16, "float64": torch.float64,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
          "float8_e4m3fn": torch.float8_e4m3fn,
          "complex64": torch.complex64}
_NAMES = {v: k for k, v in _TORCH.items()}
# the dtypes numpy lacks: the container a file's bits are read in, and
# the header descr np.save writes for the ml_dtypes array
_BITS = {"bfloat16": (np.int16, "<V2"), "float8_e4m3fn": (np.uint8, "<V1")}


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               "queue 1, item 8)")


def _ckpt_metrics():
    """Save/restore telemetry: per-process wall time of the shard I/O."""
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    return {
        "saves": reg.counter("paddle_tpu_checkpoint_saves_total",
                             "checkpoint save operations (this process's "
                             "shard write, sync or async)"),
        "restores": reg.counter("paddle_tpu_checkpoint_restores_total",
                                "checkpoint load operations"),
        "save_s": reg.histogram("paddle_tpu_checkpoint_save_seconds",
                                "wall time writing this process's shards",
                                buckets=_DURATION_BUCKETS),
        "restore_s": reg.histogram(
            "paddle_tpu_checkpoint_restore_seconds",
            "wall time assembling this process's regions",
            buckets=_DURATION_BUCKETS),
    }


# -- values <-> host arrays ----------------------------------------------------

def _host(value) -> Tuple[str, np.ndarray]:
    """``(index dtype name, host array)``: the array holds the value's
    bits, bfloat16 / float8_e4m3fn in their integer container."""
    if torch.is_tensor(value):
        t = value.detach()
        name = _NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"checkpoint: no index dtype for {t.dtype}")
        t = t.to("cpu").contiguous()
        if name in _BITS:
            cont = torch.int16 if name == "bfloat16" else torch.uint8
            return name, t.view(cont).numpy()
        return name, t.numpy()
    a = np.asarray(value)
    name = a.dtype.name
    if name in _BITS:
        return name, a.view(_BITS[name][0])
    return name, a


def _save_npy(f, name: str, data: np.ndarray):
    """``np.save(f, data)``, writing for bfloat16 / float8_e4m3fn the
    header np.save writes for an ml_dtypes array."""
    if name not in _BITS:
        np.save(f, data)
        return
    data = np.ascontiguousarray(data)
    np.lib.format.write_array_header_1_0(
        f, {"descr": _BITS[name][1], "fortran_order": False,
            "shape": tuple(data.shape)})
    f.write(data.tobytes())


def _load_npy(fpath: str, name: Optional[str], mmap: bool = False
              ) -> Tuple[np.ndarray, str]:
    """``(array, dtype name)`` of a shard file, bfloat16 / float8_e4m3fn
    (a void dtype in the file) viewed in their integer container; a file
    without an index dtype (format 1) names its own, a 2-byte void as
    bfloat16."""
    a = np.load(fpath, mmap_mode="r" if mmap else None)
    if a.dtype.kind == "V":
        if name not in _BITS:
            name = "bfloat16" if a.dtype.itemsize == 2 else "float8_e4m3fn"
        return a.view(_BITS[name][0]), name
    return a, name or a.dtype.name


def _to_tensor(a: np.ndarray, name: str, device, dtype=None):
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = np.array(a, copy=True, order="C")
    t = torch.from_numpy(a)
    if name in _BITS:
        t = t.view(_TORCH[name])
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# -- shards ----------------------------------------------------------------------

def _shard_fname(name: str, offsets: List[List[int]]) -> str:
    safe = name.replace("/", "__")
    if not offsets:
        return f"{safe}.shard.npy"
    tag = "_".join(f"{a}-{b}" for a, b in offsets)
    return f"{safe}.shard.{tag}.npy"


def _digest_file(path: str, sha: bool) -> Tuple[int, int, Optional[str]]:
    crc, n = 0, 0
    h = hashlib.sha256() if sha else None
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 22)
            if not chunk:
                break
            n += len(chunk)
            crc = zlib.crc32(chunk, crc)
            if h is not None:
                h.update(chunk)
    return n, crc & 0xFFFFFFFF, None if h is None else h.hexdigest()


def _file_digest(path: str) -> Dict[str, Any]:
    """Byte length + crc32 of one written shard file, plus sha256 under
    ``PADDLE_TPU_CKPT_DIGEST=sha256``, over the final file bytes."""
    n, crc, sha = _digest_file(
        path, os.environ.get("PADDLE_TPU_CKPT_DIGEST") == "sha256")
    out: Dict[str, Any] = {"bytes": n, "crc32": crc}
    if sha is not None:
        out["sha256"] = sha
    return out


def _verify_shard_file(path: str, entry: dict) -> Optional[str]:
    """None when the file matches the index entry's digests, else the
    reason.  Entries without digests verify trivially."""
    if "bytes" in entry:
        actual = os.path.getsize(path)
        if actual != entry["bytes"]:
            return (f"{os.path.basename(path)}: size {actual} != recorded "
                    f"{entry['bytes']} (truncated/torn write)")
    if "crc32" in entry or "sha256" in entry:
        _, crc, sha = _digest_file(path, "sha256" in entry)
        if "crc32" in entry and crc != entry["crc32"]:
            return (f"{os.path.basename(path)}: crc32 mismatch "
                    f"(bit rot / partial overwrite)")
        if sha is not None and sha != entry["sha256"]:
            return f"{os.path.basename(path)}: sha256 mismatch"
    return None


def _snapshot(state_dict: Dict[str, Any]) -> Dict[str, dict]:
    """Device to host, now: {name: {global_shape, dtype, shards:
    [(offsets, host array)]}}, one shard covering each tensor."""
    plan: Dict[str, dict] = {}
    for name, value in state_dict.items():
        dname, a = _host(value)
        plan[name] = {"global_shape": list(a.shape), "dtype": dname,
                      "shards": [([[0, d] for d in a.shape], a)]}
    return plan


def _purge_stale(path: str):
    """Remove a previous checkpoint's artifacts (and ``*.tmp.*`` orphans
    of an interrupted save) so a load never merges them with new ones."""
    for pattern in ("index.*.json", "*.shard.npy", "*.shard.*.npy",
                    "*.tmp.*"):
        for f in glob.glob(os.path.join(glob.escape(path), pattern)):
            os.remove(f)
    sentinel = os.path.join(path, _SENTINEL)
    if os.path.exists(sentinel):
        os.remove(sentinel)


def _write_shard(path: str, fname: str, dname: str, data: np.ndarray
                 ) -> dict:
    """Atomic shard publish: a pid-tagged tmp file, its digest, the
    rename.  A crash at any point leaves no file or a ``.tmp.*`` orphan,
    never a half-written file under the final name."""
    from paddle_tpu_torch.robustness import fault_fires, fault_point
    final = os.path.join(path, fname)
    tmp = final + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        _save_npy(f, dname, data)
    digest = _file_digest(tmp)
    # chaos: crash before publish — the orphan must stay invisible
    fault_point("checkpoint.shard_write", file=fname)
    if fault_fires("checkpoint.torn_shard", file=fname):
        # chaos: torn write — the digest is of the intended bytes, so
        # validation must catch the mismatch
        with open(tmp, "r+b") as f:
            f.truncate(max(1, digest["bytes"] // 2))
    os.replace(tmp, final)
    return digest


def _write_plan(plan: Dict[str, dict], path: str):
    """Write the shards and the index (purging stale artifacts first),
    then the sentinel, under ``checkpoint.save``."""
    from paddle_tpu_torch.observability import flight_recorder
    from paddle_tpu_torch.observability.tracing import tracer
    t0 = time.perf_counter()
    recorder = flight_recorder()
    recorder.record("checkpoint.save_begin", path=path, tensors=len(plan),
                    barrier=False)
    try:
        with tracer().span("checkpoint.save", path=path, tensors=len(plan),
                           root_eligible=False):
            _write_plan_inner(plan, path)
    except BaseException as e:
        recorder.record("checkpoint.save_failed", path=path,
                        error=type(e).__name__)
        raise
    m = _ckpt_metrics()
    m["saves"].inc()
    m["save_s"].observe(time.perf_counter() - t0)
    recorder.record("checkpoint.save_end", path=path,
                    seconds=time.perf_counter() - t0)


def _write_plan_inner(plan: Dict[str, dict], path: str):
    from paddle_tpu_torch.observability.tracing import tracer
    os.makedirs(path, exist_ok=True)
    _purge_stale(path)
    tr = tracer()
    index = {}
    for name, tmeta in plan.items():
        entries = []
        for offsets, data in tmeta["shards"]:
            fname = _shard_fname(name, offsets)
            with tr.span("checkpoint.shard", file=fname,
                         bytes=int(data.nbytes), root_eligible=False):
                digest = _write_shard(path, fname, tmeta["dtype"], data)
            entries.append({"file": fname, "offsets": offsets, **digest})
        index[name] = {"global_shape": tmeta["global_shape"],
                       "dtype": tmeta["dtype"], "shards": entries}
    _atomic_json(os.path.join(path, "index.0.json"),
                 {"tensors": index, "process": 0})
    _atomic_json(os.path.join(path, _SENTINEL), {"format": 2, "nprocs": 1})


def _atomic_json(path: str, obj):
    """tmp + rename JSON write: never a truncated index under the final
    name."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0):
    """Write {name: tensor or array} to `path/`, one shard file per
    tensor.  ``process_group`` / ``coordinator_rank`` are the reference
    API's; one process writes everything."""
    _write_plan(_snapshot(state_dict), path)


# -- load ------------------------------------------------------------------------

def _merge_indexes(path: str, expected_nprocs: Optional[int] = None
                   ) -> Dict[str, dict]:
    idx_files = sorted(glob.glob(os.path.join(glob.escape(path),
                                              "index.*.json")))
    if expected_nprocs is not None and len(idx_files) != expected_nprocs:
        raise ValueError(
            f"checkpoint has {len(idx_files)} index files but was written "
            f"by {expected_nprocs} processes — a writer crashed mid-save; "
            "tensors it owned would silently vanish, refusing to load")
    merged: Dict[str, dict] = {}
    for idx_file in idx_files:
        with open(idx_file) as f:
            tensors = json.load(f)["tensors"]
        for name, tmeta in tensors.items():
            if name not in merged:
                merged[name] = {"global_shape": tmeta["global_shape"],
                                "dtype": tmeta["dtype"], "shards": []}
            merged[name]["shards"].extend(tmeta["shards"])
    return merged


def _tile_region(shards: List[dict], want: List[List[int]]):
    """The shard entries overlapping region `want` as [(shard, src
    slices, dst slices)], after checking they tile it exactly (disjoint
    and covering); raises ValueError otherwise.  The loader and the
    validator share it, so they agree on what a complete checkpoint
    is."""
    covered, placed, out = 0, [], []
    for sh in shards:
        src_sl, dst_sl, empty = [], [], False
        for (wa, wb), (sa, sb) in zip(want, sh["offsets"]):
            lo, hi = max(wa, sa), min(wb, sb)
            if lo >= hi:
                empty = True
                break
            src_sl.append(slice(lo - sa, hi - sa))
            dst_sl.append(slice(lo - wa, hi - wa))
        if empty:
            continue
        dst_rng = [(s.start, s.stop) for s in dst_sl]
        for prev in placed:
            if all(a < pb and pa < b
                   for (a, b), (pa, pb) in zip(dst_rng, prev)):
                raise ValueError(
                    f"checkpoint shards overlap within region {want} — "
                    "duplicate or stale shard files from a previous save")
        placed.append(dst_rng)
        out.append((sh, tuple(src_sl), tuple(dst_sl)))
        covered += int(np.prod([b - a for a, b in dst_rng]))
    size = int(np.prod([b - a for a, b in want]))
    if covered != size:
        raise ValueError(
            f"checkpoint region {want} is under-covered by shard files "
            f"({covered}/{size} elements) — missing/partial shards "
            "(peer crashed mid-write?)")
    return out


def _check_0d(shards: List[dict]):
    if not shards:
        raise ValueError("checkpoint 0-d tensor is under-covered: its "
                         "single shard file is missing (owner process "
                         "crashed mid-write?)")
    if len(shards) > 1:
        raise ValueError("checkpoint 0-d tensor has duplicate shard "
                         "files — stale artifacts from a previous save")


def _read_whole(path: str, tmeta: dict) -> np.ndarray:
    """The whole tensor from the shard files that tile it (any layout
    the JAX package wrote), in its host container."""
    gshape = tmeta["global_shape"]
    name = tmeta["dtype"]
    if not gshape:
        _check_0d(tmeta["shards"])
        return _load_npy(os.path.join(path, tmeta["shards"][0]["file"]),
                         name)[0]
    want = [[0, d] for d in gshape]
    tiles = _tile_region(tmeta["shards"], want)
    if len(tiles) == 1:
        return _load_npy(os.path.join(path, tiles[0][0]["file"]), name)[0]
    cont = _BITS[name][0] if name in _BITS else np.dtype(name)
    out = np.empty(gshape, cont)
    for sh, src_sl, dst_sl in tiles:
        out[dst_sl] = _load_npy(os.path.join(path, sh["file"]), name,
                                mmap=True)[0][src_sl]
    return out


def load_state_dict(path: str, mesh=None,
                    specs: Optional[Dict[str, Any]] = None, dtype=None,
                    device=None) -> Dict[str, torch.Tensor]:
    """Load a checkpoint (format 2 or 1) as {name: tensor on `device`};
    ``dtype`` converts the floating tensors."""
    from paddle_tpu_torch.core.state import resolve_device
    from paddle_tpu_torch.observability import flight_recorder
    from paddle_tpu_torch.observability.tracing import tracer
    if mesh is not None or specs is not None:
        raise _unported("load_state_dict(mesh=, specs=) (re-sharding on "
                        "load)")
    dev = resolve_device(device)
    if isinstance(dtype, str):
        dtype = _TORCH[dtype]
    t0 = time.perf_counter()
    restore_span = tracer().start_span("checkpoint.restore", path=path,
                                       root_eligible=False)
    try:
        with open(os.path.join(path, _SENTINEL)) as f:
            meta = json.load(f)
        if meta.get("format", 1) < 2:
            out = {}
            for name, info in meta["tensors"].items():
                a, dname = _load_npy(os.path.join(path, info["file"]),
                                     info.get("dtype"))
                out[name] = _to_tensor(a, dname, dev, dtype)
        else:
            tensors = _merge_indexes(path,
                                     expected_nprocs=meta.get("nprocs"))
            out = {name: _to_tensor(_read_whole(path, tmeta),
                                    tmeta["dtype"], dev, dtype)
                   for name, tmeta in tensors.items()}
        restore_span.set_attribute("tensors", len(out))
    finally:
        restore_span.end()
    m = _ckpt_metrics()
    m["restores"].inc()
    m["restore_s"].observe(time.perf_counter() - t0)
    flight_recorder().record("checkpoint.restore", path=path,
                             tensors=len(out),
                             seconds=time.perf_counter() - t0)
    return out


def validate_checkpoint(path: str,
                        verify_digests: Optional[bool] = None) -> bool:
    """Integrity check: sentinel and index present and parseable, every
    shard file on disk, every tensor exactly tiled, and (by default)
    every file's size and crc32 / sha256 equal to the recorded digests.
    ``verify_digests=False`` (or ``PADDLE_TPU_CKPT_VERIFY=meta``) skips
    the re-read.  Returns False with a logged reason on any defect;
    never raises."""
    if verify_digests is None:
        verify_digests = os.environ.get(
            "PADDLE_TPU_CKPT_VERIFY", "digest") != "meta"

    def invalid(reason: str) -> bool:
        _log.warning("invalid checkpoint at %s: %s", path, reason)
        try:
            from paddle_tpu_torch.observability import flight_recorder
            flight_recorder().record("checkpoint.validate_failed",
                                     path=path, reason=reason[:200])
        except Exception:
            pass
        return False

    try:
        with open(os.path.join(path, _SENTINEL)) as f:
            meta = json.load(f)
        if meta.get("format", 1) < 2:
            for i in meta["tensors"].values():
                if not os.path.exists(os.path.join(path, i["file"])):
                    return invalid(f"missing tensor file {i['file']}")
            return True
        tensors = _merge_indexes(path, expected_nprocs=meta.get("nprocs"))
        for name, tmeta in tensors.items():
            shards = tmeta["shards"]
            for sh in shards:
                fpath = os.path.join(path, sh["file"])
                if not os.path.exists(fpath):
                    return invalid(f"{name}: missing shard {sh['file']}")
                if verify_digests:
                    reason = _verify_shard_file(fpath, sh)
                    if reason is not None:
                        return invalid(f"{name}: {reason}")
            gshape = tmeta["global_shape"]
            if not gshape:
                _check_0d(shards)
            else:
                _tile_region(shards, [[0, d] for d in gshape])
        return True
    except (ValueError, OSError, KeyError, json.JSONDecodeError) as e:
        return invalid(f"{type(e).__name__}: {e}")


class _AsyncSave:
    """An in-flight background save.  The writer's exception is kept and
    re-raised from :meth:`wait`.  The thread is a daemon; ``wait`` joins
    it with a timeout."""

    def __init__(self, target, args):
        self.error: Optional[BaseException] = None
        from paddle_tpu_torch.observability.tracing import tracer
        tr = tracer()
        ctx = tr.current_context()

        def run():
            try:
                with tr.attach(ctx):
                    target(*args)
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True,
                                       name="paddle_tpu_torch-ckpt-writer")
        self.thread.start()

    def wait(self, timeout: Optional[float] = 3600.0):
        """Join the writer (raising TimeoutError past `timeout` seconds)
        and re-raise its error."""
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise TimeoutError(f"checkpoint writer still running after "
                               f"{timeout} s")
        if self.error is not None:
            raise self.error

    def done(self):
        return not self.thread.is_alive()


def async_save_state_dict(state_dict: Dict[str, Any], path: str,
                          coordinator_rank: int = 0) -> _AsyncSave:
    """Copy every tensor to the host now, write the files on a
    background thread (the orbax pattern); ``.wait()`` / ``.done()`` on
    the handle."""
    return _AsyncSave(_write_plan, (_snapshot(state_dict), path))


class Converter:
    """Re-slice a checkpoint between parallel layouts
    (``static/converter.py``): the numpy merge / slice of per-rank
    shards; ``convert`` (a load onto a mesh) waits for meshes."""

    def __init__(self, checkpoint_path: str):
        self.path = checkpoint_path

    def convert(self, mesh, specs, dtype=None):
        raise _unported("Converter.convert (a load onto a mesh)")

    @staticmethod
    def _coord(rank, process_shape):
        coord, rem = [], rank
        for dim in reversed(process_shape):
            coord.append(rem % dim)
            rem //= dim
        return coord[::-1]

    @staticmethod
    def merge_with_dist_attr(shards, dist_attr) -> np.ndarray:
        """Reassemble a global array from per-rank shards.  `dist_attr`:
        {"dims_mapping": [tensor dim -> mesh axis or -1],
        "process_shape": [mesh dims], "process_group": [ranks]}."""
        dims_mapping = dist_attr["dims_mapping"]
        process_shape = dist_attr["process_shape"]
        first = np.asarray(shards[0])
        gshape = list(first.shape)
        for tdim, maxis in enumerate(dims_mapping):
            if maxis >= 0:
                gshape[tdim] *= process_shape[maxis]
        out = np.zeros(gshape, first.dtype)
        for rank, shard in zip(dist_attr["process_group"], shards):
            coord = Converter._coord(rank, process_shape)
            index = []
            for tdim, maxis in enumerate(dims_mapping):
                if maxis >= 0:
                    size = np.asarray(shard).shape[tdim]
                    start = coord[maxis] * size
                    index.append(slice(start, start + size))
                else:
                    index.append(slice(None))
            out[tuple(index)] = np.asarray(shard)
        return out

    @staticmethod
    def slice_with_dist_attr(global_arr: np.ndarray, dist_attr):
        """Global array -> per-rank shards (inverse of merge)."""
        dims_mapping = dist_attr["dims_mapping"]
        process_shape = dist_attr["process_shape"]
        shards = []
        for rank in dist_attr["process_group"]:
            coord = Converter._coord(rank, process_shape)
            index = []
            for tdim, maxis in enumerate(dims_mapping):
                if maxis >= 0:
                    size = global_arr.shape[tdim] // process_shape[maxis]
                    start = coord[maxis] * size
                    index.append(slice(start, start + size))
                else:
                    index.append(slice(None))
            shards.append(np.asarray(global_arr[tuple(index)]))
        return shards


class AutoCheckpoint:
    """Checkpoint-restart orchestration (``auto_checkpoint.py``): an
    async save every ``save_interval_steps``, the newest ``keep`` kept,
    and resume from the newest checkpoint that validates."""

    def __init__(self, directory: str, keep: int = 3,
                 save_interval_steps: int = 1000):
        self.dir = directory
        self.keep = keep
        self.interval = save_interval_steps
        self._pending: Optional[_AsyncSave] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:012d}")

    def _complete_steps(self) -> List[int]:
        """Steps whose checkpoints validate, newest first."""
        return sorted(
            (s for s in (int(n[5:]) for n in os.listdir(self.dir)
                         if n.startswith("step_"))
             if validate_checkpoint(self._step_dir(s))), reverse=True)

    def latest_step(self) -> Optional[int]:
        """The step :meth:`restore_latest` would restore."""
        steps = self._complete_steps()
        return steps[0] if steps else None

    def maybe_save(self, step: int, state_dict: Dict[str, Any]):
        """At the interval: wait out the previous save (one in flight),
        then start an async save of `step`; returns its handle (None off
        the interval)."""
        if step % self.interval:
            return None
        if self._pending is not None:
            self._pending.wait()
        step_dir = self._step_dir(step)
        shutil.rmtree(step_dir, ignore_errors=True)
        self._pending = async_save_state_dict(state_dict, step_dir)
        self._gc(step)
        return self._pending

    def restore_latest(self, mesh=None, specs=None, device=None):
        """``(step, {name: tensor})`` of the newest valid checkpoint,
        falling back step by step past one that fails to load; ``(None,
        None)`` when there is none.  When no candidate loads the last
        error propagates."""
        if mesh is not None or specs is not None:
            raise _unported("restore_latest(mesh=, specs=)")
        steps = self._complete_steps()
        if not steps:
            return None, None
        last_err = None
        for step in steps:
            try:
                return step, load_state_dict(self._step_dir(step),
                                             device=device)
            except Exception as e:  # noqa: BLE001 — re-raised when all fail
                last_err = e
                _log.warning("checkpoint step %d validated but failed to "
                             "load (%s: %s); falling back to next-older",
                             step, type(e).__name__, e)
                from paddle_tpu_torch.observability import flight_recorder
                flight_recorder().record("checkpoint.restore_fallback",
                                         step=step,
                                         error=type(e).__name__)
        raise last_err

    def save_now(self, step: int, state_dict: Dict[str, Any]) -> str:
        """Synchronous save (the preemption drain): wait out any async
        save, then write `step` before returning."""
        if self._pending is not None:
            self._pending.wait()
            self._pending = None
        step_dir = self._step_dir(step)
        shutil.rmtree(step_dir, ignore_errors=True)
        save_state_dict(state_dict, step_dir)
        self._gc(step)
        return step_dir

    def _gc(self, current_step: int):
        """Keep the newest ``keep - 1`` complete checkpoints before
        `current_step` (whose save makes ``keep``); incomplete leftovers
        always go."""
        complete, partial = [], []
        for n in os.listdir(self.dir):
            if not n.startswith("step_"):
                continue
            s = int(n[5:])
            if s >= current_step:
                continue
            if validate_checkpoint(self._step_dir(s)):
                complete.append(s)
            else:
                partial.append(s)
        complete.sort()
        doomed = partial + (
            complete[:-(self.keep - 1)] if self.keep > 1 else complete)
        for s in doomed:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
