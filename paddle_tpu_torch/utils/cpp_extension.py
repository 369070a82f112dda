"""Build and load the native host components (``csrc/``), the port's
``load_native`` (``paddle_tpu/utils/cpp_extension.py``).

The JAX package builds ``csrc/`` with ``make`` into ``paddle_tpu/lib``.
The port reads the same sources and leaves both alone: each component
compiles with ``g++ -O2 -std=c++17 -shared -fPIC -pthread`` into
``ops/kernels/build/`` (ignored by git, beside the CUDA libraries), under
a name that carries the hash of its source and flags, so an edited
source builds anew and an unchanged one is reused.  The compile writes a
temporary file and renames it into place, so concurrent first uses
agree.  The components ported are the TCPStore
(``csrc/store/tcp_store.cpp``) and the token data feed
(``csrc/datafeed/datafeed.cpp``, ``io/token_dataset.py``); the rest of
``utils/cpp_extension.py`` waits (ROADMAP.md, item 7.8)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["NativeBuildError", "load_native", "native_target"]

_REPO = Path(__file__).resolve().parents[2]
CSRC = _REPO / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "kernels" / "build"
# the components the port loads, by the JAX package's name
SOURCES = {"store": Path("store") / "tcp_store.cpp",
           "datafeed": Path("datafeed") / "datafeed.cpp"}
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
         "-shared")

_lock = threading.Lock()
_cache: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def _source(name: str) -> Path:
    rel = SOURCES.get(name)
    if rel is None:
        raise NativeBuildError(f"native component {name!r} is not ported "
                               f"(ported: {sorted(SOURCES)})")
    src = CSRC / rel
    if not src.exists():
        raise NativeBuildError(f"native component {name!r}: its source "
                               f"{src} is missing")
    return src


def native_target(name: str) -> Path:
    """The library of component `name`: ``libpt_<name>-<hash>.so``, the
    hash over its source and the flags."""
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libpt_{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path):
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeBuildError("no C++ compiler (CXX, g++, c++) to build "
                               f"the native component {name!r}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(_source(name))],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"native build of {name!r} failed:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)


def load_native(name: str, build_if_missing: bool = True,
                required_symbol: Optional[str] = None
                ) -> Optional[ctypes.CDLL]:
    """The loaded library of component `name`, built on first use (None
    when it is not built and `build_if_missing` is False).  A library
    lacking `required_symbol` is an error: its name carries the source's
    hash, so it cannot be stale."""
    with _lock:
        lib = _cache.get(name)
        if lib is not None:
            return lib
        out = native_target(name)
        if not out.exists():
            if not build_if_missing:
                return None
            _build(name, out)
        lib = ctypes.CDLL(str(out))
        if required_symbol is not None and not hasattr(lib, required_symbol):
            raise NativeBuildError(f"{out.name} lacks {required_symbol}")
        _cache[name] = lib
        return lib
