"""The persistent compile cache and model-artifact bundles
(``paddle_tpu/compile_cache.py``).

A CUDA graph cannot be serialized, so an entry holds what the port pays
to build a program, not the program: its **recipe** (target, argument
signature, the ``extra`` key discriminator, and the ``CompileInfo``
stats: the cost model's FLOPs and bytes, the launches one replay makes,
the capture's pool bytes) and, on the card, the **keys of the kernel
libraries** (``ops/kernels/_build.py``'s :func:`library_key`, every
library: ``_build`` builds or installs them together).  A hit
captures the program without the counted warm-up (no cost-model run:
the stats come from the entry), runs no nvcc (the libraries come from
``<cache dir>/kernels/``), leaves ``paddle_tpu_compile_total{target}``
alone and returns ``CompileInfo(cached=True)`` whose ``compile_s`` is the
load-and-capture wall time.  A miss counts, warms up and captures as
``device_profiler.compile_static`` does, then stores the entry.

Kept from the JAX package:

* **Keys** — sha256 over the schema, target, signature, mesh and
  shardings tags (``None`` only: meshes wait, ROADMAP.md queue 1 item 8),
  the torch, CUDA and nvcc versions, the device's backend fingerprint
  (``core/state.py``) and ``extra``.
* **Entries** — one JSON file a key (no pickle), a ``schema``, written
  through a temporary file and ``os.replace``.
* **Fencing** — the fingerprint and the toolchain are in the key and
  checked again at load: a CPU entry is never served to a CUDA process.
* **Bad entries** — an unreadable, truncated, old-schema or foreign
  entry, or one whose libraries no longer match the sources, is a
  ``miss``; a hit whose library fails to load is a
  ``deserialize_error``.  Either is unlinked; neither raises.
* **Counters and spans** — ``paddle_tpu_compile_cache_total{target,
  result}`` (hit, miss, store, deserialize_error) and the
  ``compile.cache_hit`` span.

:func:`bundle` / :func:`load_bundle` package weights (through the
checksummed ``distributed.checkpoint`` writer), the entries, the kernel
libraries (each with the sha256 of its bytes, checked before it is
installed) and a manifest with the fingerprint.  The JAX bundle's
autotune section stays, empty: the port has no autotune cache yet
(ROADMAP.md, item 10), and no ``install_autotune`` option.

Env knobs::

  PADDLE_TPU_COMPILE_CACHE=1          enable (default off)
  PADDLE_TPU_COMPILE_CACHE_DIR=path   default ~/.cache/paddle_tpu_torch/
                                      executables

CLI (on ``cuda`` unless ``--device cpu``)::

    python -m paddle_tpu_torch.compile_cache stats
    python -m paddle_tpu_torch.compile_cache bundle OUT --checkpoint CKPT
    python -m paddle_tpu_torch.compile_cache load-bundle PATH
    python -m paddle_tpu_torch.compile_cache clear
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

__all__ = ["SCHEMA_VERSION", "enabled", "cache_dir", "backend_fingerprint",
           "cache_key", "lookup", "store", "aot_compile_cached",
           "compile_static_cached", "hit_info", "model_config_tag",
           "cached_entries", "clear_cache", "cache_stats", "bundle",
           "load_bundle", "main"]

SCHEMA_VERSION = 1
BUNDLE_SCHEMA = 1

# in-memory layer: an entry this process stored or already read
_mem: Dict[str, dict] = {}


# -- knobs + keys ------------------------------------------------------------

def enabled() -> bool:
    """Opt-in: ``PADDLE_TPU_COMPILE_CACHE=1``."""
    return os.environ.get("PADDLE_TPU_COMPILE_CACHE", "0") == "1"


def cache_dir() -> str:
    return os.environ.get(
        "PADDLE_TPU_COMPILE_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu_torch",
                     "executables"))


def backend_fingerprint(device=None) -> str:
    """``core.state.backend_fingerprint`` of `device` (the process's
    backend without one)."""
    from paddle_tpu_torch.core.state import backend_fingerprint as fp
    return fp(device)


def _toolchain() -> str:
    from paddle_tpu_torch.ops.kernels import _build
    return (f"torch{torch.__version__}|cuda{torch.version.cuda}"
            f"|nvcc:{_build.nvcc_version()}")


def _mesh_tag(mesh, shardings):
    if mesh is not None or shardings:
        raise NotImplementedError(
            "compile-cache keys over meshes and shardings are not ported "
            "yet (ROADMAP.md, queue 1, item 8)")
    return "nomesh", "nosharding"


def cache_key(target: str, signature: str, mesh=None, shardings=None,
              extra: str = "", device=None) -> str:
    """Content address of one program: ``signature`` is the
    ``signature_of`` of its arguments, ``extra`` the closed-over config
    the signature cannot see."""
    mesh_tag, sh_tag = _mesh_tag(mesh, shardings)
    material = "\x1f".join([
        f"schema{SCHEMA_VERSION}", target, signature, mesh_tag, sh_tag,
        _toolchain(), backend_fingerprint(device), extra])
    return hashlib.sha256(material.encode()).hexdigest()


def _entry_path(key: str, root: Optional[str] = None) -> str:
    return os.path.join(root or cache_dir(), f"{key}.json")


def model_config_tag(model) -> str:
    """Key discriminator for the config a model bakes into its programs
    (RoPE tables, norm epsilons): the class name and a hash of the
    config's fields."""
    cfg = getattr(model, "config", None)
    if cfg is None:
        return type(model).__name__
    try:
        d = sorted((k, repr(v)) for k, v in vars(cfg).items()
                   if not k.startswith("_"))
        digest = hashlib.sha256(repr(d).encode()).hexdigest()[:16]
    except TypeError:
        digest = hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]
    return f"{type(model).__name__}:{digest}"


# -- telemetry ---------------------------------------------------------------

def _count(target: str, result: str):
    try:
        from paddle_tpu_torch.observability import default_registry
        default_registry().counter(
            "paddle_tpu_compile_cache_total",
            "persistent executable-cache lookups/stores by outcome",
            labelnames=("target", "result")).labels(
                target=target, result=result).inc()
    except Exception:
        pass


# -- entry io ----------------------------------------------------------------

def _unlink_quiet(path: str):
    try:
        os.remove(path)
    except OSError:
        pass


def _libraries_current(kernels: Dict[str, str]) -> bool:
    from paddle_tpu_torch.ops.kernels import _build
    try:
        return all(_build.library_key(n) == k for n, k in kernels.items())
    except Exception:
        return False


def _read_entry(path: str, device=None, unlink: bool = True
                ) -> Optional[dict]:
    """Parse and validate one entry: None (the file unlinked, with
    `unlink`) when it is unreadable, truncated, of another schema,
    toolchain or backend, or names kernel libraries that no longer match
    their sources."""
    drop = _unlink_quiet if unlink else (lambda p: None)
    try:
        with open(path) as f:
            entry = json.load(f)
    except FileNotFoundError:
        return None
    except Exception:
        drop(path)
        return None
    if not isinstance(entry, dict) \
            or entry.get("schema") != SCHEMA_VERSION \
            or entry.get("toolchain") != _toolchain() \
            or entry.get("backend") != backend_fingerprint(device) \
            or not isinstance(entry.get("stats"), dict) \
            or not isinstance(entry.get("kernels"), dict) \
            or not _libraries_current(entry["kernels"]):
        drop(path)
        return None
    return entry


def _write_json(path: str, obj) -> bool:
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(obj, f, sort_keys=True)
        os.replace(tmp, path)
        return True
    except Exception:
        return False   # read-only fs: the in-memory layer still works


def lookup(key: str, target: str = "fn", root: Optional[str] = None,
           device=None) -> Optional[dict]:
    """The valid entry of ``key`` with its kernel libraries loaded, or
    None.  Counts ``hit`` / ``miss``; a library that fails to load counts
    ``deserialize_error`` and drops the entry."""
    if key in _mem:
        _count(target, "hit")
        return _mem[key]
    path = _entry_path(key, root)
    entry = _read_entry(path, device)
    if entry is None:
        _count(target, "miss")
        return None
    from paddle_tpu_torch.observability.tracing import tracer
    try:
        with tracer().span("compile.cache_hit", target=target,
                           key=key[:12]):
            from paddle_tpu_torch.ops.kernels import _build
            for name in entry["kernels"]:
                _build.library(name)
    except Exception:
        _count(target, "deserialize_error")
        _unlink_quiet(path)
        return None
    _mem[key] = entry
    _count(target, "hit")
    return entry


def store(key: str, info, target: str = "fn", signature: str = "",
          extra: str = "", root: Optional[str] = None, device=None) -> bool:
    """Store the recipe of a program just built (its ``CompileInfo``);
    False when the file cannot be written.  A CUDA entry names every
    kernel library; a CPU program launches none."""
    from paddle_tpu_torch.ops.kernels import _build
    backend = backend_fingerprint(device)
    libs = _build.SOURCES if backend.startswith("cuda:") else ()
    entry = {
        "schema": SCHEMA_VERSION,
        "toolchain": _toolchain(),
        "backend": backend,
        "target": target,
        "signature": signature,
        "extra": extra,
        "stats": dataclasses.asdict(info.stats),
        "launches": dict(info.launches or {}),
        "graph": bool(info.graph),
        "kernels": {n: _build.library_key(n) for n in libs},
        "created": time.time(),
    }
    ok = _write_json(_entry_path(key, root), entry)
    if ok:
        _mem[key] = entry
        _count(target, "store")
    return ok


def hit_info(target, signature, entry, seconds, graph: bool, launches):
    """The ``CompileInfo`` of a hit: its stats the entry's, ``compile_s``
    the load-and-capture seconds, ``graph`` / ``launches`` the capture's;
    recorded without moving the compile counter."""
    from paddle_tpu_torch.observability.device_profiler import (
        CompileInfo, ExecutableStats, record_compile_info)
    info = CompileInfo(
        target=target, signature=signature, lower_s=0.0, compile_s=seconds,
        stats=ExecutableStats(**entry["stats"]), cached=True, graph=graph,
        launches=dict(launches))
    record_compile_info(info)
    from paddle_tpu_torch.observability import flight_recorder
    flight_recorder().record("compile.cache_hit", target=target,
                             load_s=round(seconds, 4))
    return info


def compile_static_cached(body: Callable, inputs: Dict[str, torch.Tensor],
                          target: str, generator=None, warmup: int = 1,
                          extra: str = "", cache_only: bool = False,
                          what: Optional[str] = None,
                          signature: Optional[str] = None):
    """``device_profiler.compile_static`` with the cache in front:
    ``(StaticGraph or None, CompileInfo or None, hit)``.  A hit binds the
    body with `warmup` uncounted warm-ups; a miss compiles and stores, or
    with ``cache_only`` returns ``(None, None, False)``."""
    from paddle_tpu_torch.jit.static_graph import StaticGraph
    from paddle_tpu_torch.observability.device_profiler import (
        compile_static, signature_of)
    from paddle_tpu_torch.observability.tracing import tracer
    if not enabled():
        if cache_only:
            return None, None, False
        g, info = compile_static(body, inputs, target, generator=generator,
                                 warmup=warmup, what=what,
                                 signature=signature)
        return g, info, False
    dev = next(iter(inputs.values())).device
    signature = signature or signature_of(inputs)
    key = cache_key(target, signature, extra=extra, device=dev)
    t0 = time.perf_counter()
    entry = lookup(key, target=target, device=dev)
    if entry is not None:
        with tracer().span("compile", target=target, cached=True):
            g = StaticGraph(body, inputs, what or f"{target}'s capture",
                            generator=generator, warmup=warmup)
        return g, hit_info(target, signature, entry,
                           time.perf_counter() - t0, g.graph is not None,
                           g.launches), True
    if cache_only:
        return None, None, False
    g, info = compile_static(body, inputs, target, generator=generator,
                             warmup=warmup, what=what, signature=signature)
    store(key, info, target=target, signature=signature, extra=extra,
          device=dev)
    return g, info, False


def aot_compile_cached(fn: Callable, *args, target: str = "fn", mesh=None,
                       shardings=None, extra: str = "", registry=None,
                       cache_only: bool = False, **kwargs):
    """``device_profiler.aot_compile`` with the cache in front: ``(graph,
    CompileInfo, hit)``; with ``cache_only=True`` a miss returns ``(None,
    None, False)`` and builds nothing."""
    from paddle_tpu_torch.observability.device_profiler import (_bind,
                                                                signature_of)
    _mesh_tag(mesh, shardings)
    inputs, rebuild = _bind(args, kwargs)
    if not inputs:
        raise ValueError(f"aot_compile_cached {target}: no tensor argument")

    def body(**got):
        a, kw = rebuild(got)
        return fn(*a, **kw)

    return compile_static_cached(
        body, inputs, target, warmup=1, extra=extra, cache_only=cache_only,
        signature=signature_of((tuple(args), kwargs)))


# -- inventory ---------------------------------------------------------------

def cached_entries(root: Optional[str] = None, device=None) -> List[dict]:
    """Rows of every valid entry (invalid files skipped and unlinked, as
    a lookup would)."""
    root = root or cache_dir()
    rows = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return rows
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(root, name)
        entry = _read_entry(path, device)
        if entry is None:
            continue
        rows.append({"key": name[:-5], "target": entry["target"],
                     "signature": entry.get("signature", "")[:80],
                     "bytes": os.path.getsize(path),
                     "kernels": sorted(entry["kernels"]),
                     "created": entry.get("created", 0.0)})
    return rows


def clear_cache(root: Optional[str] = None):
    """Remove every entry and cached kernel library."""
    root = root or cache_dir()
    _mem.clear()
    try:
        for name in os.listdir(root):
            if name.endswith(".json") or ".json.tmp." in name:
                _unlink_quiet(os.path.join(root, name))
    except OSError:
        pass
    shutil.rmtree(os.path.join(root, "kernels"), ignore_errors=True)


def reset_memory():
    """Forget the entries read or stored in this process."""
    _mem.clear()


def cache_stats(root: Optional[str] = None, device=None) -> dict:
    rows = cached_entries(root, device)
    return {"entries": len(rows),
            "bytes": sum(r["bytes"] for r in rows),
            "targets": sorted({r["target"] for r in rows})}


# -- model-artifact bundle ---------------------------------------------------

def _libraries(root: str) -> Dict[str, str]:
    """The cached kernel libraries whose bytes match their recorded
    sha256, by file name."""
    from paddle_tpu_torch.ops.kernels import _build
    kdir = os.path.join(root, "kernels")
    try:
        names = sorted(n for n in os.listdir(kdir) if n.endswith(".so"))
    except OSError:
        return {}
    return {n: _build.file_sha256(os.path.join(kdir, n)) for n in names
            if _build.verified(os.path.join(kdir, n))}


def bundle(out_dir: str, *, state_dict: Optional[Dict[str, Any]] = None,
           checkpoint_dir: Optional[str] = None,
           targets: Optional[List[str]] = None,
           cache_root: Optional[str] = None, note: str = "",
           device=None) -> dict:
    """Package a model artifact: the weights (``state_dict`` saved here,
    or ``checkpoint_dir`` copied), every valid entry (or those of
    ``targets``), the cached kernel libraries and a manifest with the
    fingerprint (``MANIFEST.json``, also returned; its ``kernels`` maps
    each library to its sha256)."""
    os.makedirs(out_dir, exist_ok=True)
    manifest: dict = {"schema": BUNDLE_SCHEMA, "toolchain": _toolchain(),
                      "backend": backend_fingerprint(device),
                      "created": time.time(), "note": note}
    ckpt_out = os.path.join(out_dir, "checkpoint")
    if state_dict is not None:
        from paddle_tpu_torch.distributed.checkpoint import save_state_dict
        save_state_dict(state_dict, ckpt_out)
        manifest["checkpoint"] = "checkpoint"
    elif checkpoint_dir is not None:
        if os.path.abspath(checkpoint_dir) != os.path.abspath(ckpt_out):
            if os.path.isdir(ckpt_out):
                shutil.rmtree(ckpt_out)
            shutil.copytree(checkpoint_dir, ckpt_out)
        manifest["checkpoint"] = "checkpoint"
    else:
        manifest["checkpoint"] = None

    root = cache_root or cache_dir()
    exe_dir = os.path.join(out_dir, "executables")
    os.makedirs(exe_dir, exist_ok=True)
    copied = []
    for row in cached_entries(root, device):
        if targets is not None and row["target"] not in targets:
            continue
        try:
            shutil.copy2(_entry_path(row["key"], root),
                         os.path.join(exe_dir, f"{row['key']}.json"))
            copied.append({"key": row["key"], "target": row["target"],
                           "bytes": row["bytes"]})
        except OSError:
            continue
    manifest["executables"] = copied
    kdir = os.path.join(out_dir, "kernels")
    os.makedirs(kdir, exist_ok=True)
    libs = _libraries(root)
    for name in libs:
        shutil.copyfile(os.path.join(root, "kernels", name),
                        os.path.join(kdir, name))
    manifest["kernels"] = libs
    # the JAX bundle's tuned block sizes: the port has no autotune cache
    with open(os.path.join(out_dir, "autotune.json"), "w") as f:
        json.dump({"version": 0, "entries": []}, f)
    manifest["autotune_entries"] = 0
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def load_bundle(path: str, *, cache_root: Optional[str] = None,
                restore_weights: bool = True, device=None) -> dict:
    """Install a bundle: its kernel libraries whose bytes match the
    manifest's sha256 into ``<cache>/kernels`` (the rest, ``rejected``,
    are left out: nvcc rebuilds them), the entries whose fence matches
    this process into the cache (the rest counted as misses, never
    installed), and its weights loaded on `device` (``cuda`` unless the
    caller asks for another).  Returns ``{"manifest", "installed",
    "skipped", "kernels", "rejected", "autotune_entries",
    "state_dict"}``; a missing or foreign-schema manifest raises
    ValueError."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.core.state import resolve_device
    dev = resolve_device(device)
    try:
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
    except Exception as e:
        raise ValueError(f"not a model bundle (no readable MANIFEST.json "
                         f"at {path}): {e}")
    if manifest.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(f"bundle schema {manifest.get('schema')!r} != "
                         f"supported {BUNDLE_SCHEMA}")
    root = cache_root or cache_dir()
    kernels, rejected = [], []
    for name, sha in sorted((manifest.get("kernels") or {}).items()):
        src = os.path.join(path, "kernels", name)
        try:
            good = _build.file_sha256(src) == sha
        except OSError:
            good = False
        if good:
            _build.store_library(src, os.path.join(root, "kernels", name),
                                 sha)
            kernels.append(name)
        else:
            rejected.append(name)
    installed, skipped = [], 0
    exe_dir = os.path.join(path, "executables")
    for name in sorted(os.listdir(exe_dir)) if os.path.isdir(exe_dir) \
            else []:
        if not name.endswith(".json"):
            continue
        src = os.path.join(exe_dir, name)
        try:
            with open(src) as f:
                target = json.load(f).get("target", "fn")
        except Exception:
            target = "fn"
        entry = _read_entry(src, dev, unlink=False)
        if entry is not None and \
                _write_json(_entry_path(name[:-5], root), entry):
            installed.append(entry["target"])
        else:
            skipped += 1
            _count(target, "miss")
    state = None
    if restore_weights and manifest.get("checkpoint"):
        from paddle_tpu_torch.distributed.checkpoint import load_state_dict
        state = load_state_dict(os.path.join(path, manifest["checkpoint"]),
                                device=dev)
    from paddle_tpu_torch.observability import flight_recorder
    flight_recorder().record("compile_cache.load_bundle", path=path,
                             installed=len(installed), skipped=skipped,
                             rejected=len(rejected), autotune=0)
    return {"manifest": manifest, "installed": installed,
            "skipped": skipped, "kernels": kernels, "rejected": rejected,
            "autotune_entries": 0, "state_dict": state}


# -- CLI ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.compile_cache",
        description="Persistent compile cache + model-artifact bundles.")
    ap.add_argument("--device", default=None,
                    help="the device whose fingerprint fences the entries "
                         "(default: cuda)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("stats", help="list valid cache entries")
    sub.add_parser("clear", help="remove every cache entry")
    b = sub.add_parser("bundle", help="package weights + entries + kernel "
                                      "libraries")
    b.add_argument("out", help="bundle directory to write")
    b.add_argument("--checkpoint", default=None,
                   help="existing distributed.checkpoint dir to include")
    b.add_argument("--targets", default=None,
                   help="comma-separated targets to include (default: all)")
    b.add_argument("--note", default="", help="free-form manifest note")
    lb = sub.add_parser("load-bundle", help="install a bundle onto this "
                                            "machine")
    lb.add_argument("path")
    args = ap.parse_args(argv)
    from paddle_tpu_torch.core.state import resolve_device
    dev = resolve_device(args.device)

    if args.cmd == "stats":
        print(json.dumps({"dir": cache_dir(), **cache_stats(device=dev),
                          "enabled": enabled()}, indent=1))
        for row in cached_entries(device=dev):
            print(f"  {row['key'][:12]}  {row['bytes']:>10d}B  "
                  f"{row['target']}")
        return 0
    if args.cmd == "clear":
        n = len(cached_entries(device=dev))
        clear_cache()
        print(f"cleared {n} entries from {cache_dir()}")
        return 0
    if args.cmd == "bundle":
        targets = [t.strip() for t in args.targets.split(",")] \
            if args.targets else None
        man = bundle(args.out, checkpoint_dir=args.checkpoint,
                     targets=targets, note=args.note, device=dev)
        print(f"bundle {args.out}: {len(man['executables'])} entries, "
              f"{len(man['kernels'])} kernel libraries, "
              f"{man['autotune_entries']} autotune entries, "
              f"checkpoint={man['checkpoint']}")
        return 0
    if args.cmd == "load-bundle":
        out = load_bundle(args.path, restore_weights=False, device=dev)
        print(f"installed {len(out['installed'])} entries "
              f"({out['skipped']} skipped), {len(out['kernels'])} kernel "
              f"libraries ({len(out['rejected'])} rejected), "
              f"{out['autotune_entries']} autotune entries")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
