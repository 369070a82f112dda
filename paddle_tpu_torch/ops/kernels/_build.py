"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  The build happens at
first use, from the sources in this directory alone, into
``ops/kernels/build/`` (ignored by git); a library whose name carries the
hash of its sources and flags is reused.  All sources build at once, one
``nvcc`` each, started together.

With the persistent compile cache on (``PADDLE_TPU_COMPILE_CACHE=1``,
``compile_cache.py``) a library missing from ``build/`` is looked for in
``<cache dir>/kernels/`` under :func:`library_key` (its sources, flags
and the nvcc version) before nvcc runs, and a library built, or found in
``build/``, is stored there: a bundle carries them, and a process that
installed one runs no nvcc.  Each cached library has the sha256 of its
bytes beside it (``<library>.sha256``); one whose bytes do not match, or
one that fails to load, is unlinked and rebuilt by nvcc.
:data:`NVCC_RUNS` counts the nvcc compiles this process started.

Every C entry point takes its pointers and the stream as ``c_void_p`` and
returns the CUDA error of its launch, which :func:`check` raises on."""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

__all__ = ["library", "build_all", "ptxas_report", "parse_ptxas", "check",
           "stream_of", "tickets", "workspace", "frozen", "sm_count",
           "charge", "plain", "library_key", "nvcc_version", "nvcc_runs",
           "file_sha256", "verified", "store_library",
           "DTYPE_CODES", "FP16_CODES", "FP16_ENTRY", "dtype_error",
           "count_dtype",
           "WEIGHT_CODES", "FLOAT16_CODE", "BUILD_DIR", "GatedDimError",
           "check_static"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_block", "paged_attention", "flash_attention",
           "quant_matmul", "grouped_matmul", "cross_entropy", "rmsnorm",
           "fused_decoder", "multi_tensor")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
# dtype codes of the C interface (csrc/common.cuh, enum DType): the io
# types every kernel takes, the stored types of quantized weights, and
# float16
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WEIGHT_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}
FLOAT16_CODE = 4
# the io types of the kernels that AMP's float16 reaches on a training
# step, which take float16 too: flash at head_dim 128, QKV, the MLP and
# fused_ffn past 16 rows, the cross-entropy pair and the multi-tensor
# norm and update
FP16_CODES = {**DTYPE_CODES, torch.float16: FLOAT16_CODE}
# where float16 waits for the rest: the serving kernels
FP16_ENTRY = ("ROADMAP.md, queue 1, item 11: float16 for serving (paged "
              "decode, the quant matmul, split-K QKV / MLP at 16 rows or "
              "fewer, rmsnorm, the decoder block, the grouped FFN)")


def count_dtype(fn, dtype):
    """Count one launch of wrapper `fn` under its io dtype in
    ``fn.launches_by_dtype`` (beside ``fn.launches``): AMP's levels send
    the same wrapper fp32 or bf16."""
    key = str(dtype).replace("torch.", "")
    fn.launches_by_dtype[key] = fn.launches_by_dtype.get(key, 0) + 1


class GatedDimError(ValueError):
    """A symbolic size (a dynamic dim of a ``torch.export`` trace)
    reached a kernel's gate: ``gate`` names the condition, ``symbols``
    the size's free symbols (``jit.save`` names the dim from them)."""

    def __init__(self, gate: str, size):
        self.gate = gate
        self.symbols = {str(s) for s in size.node.expr.free_symbols}
        super().__init__(f"a dynamic size ({size}) reaches the gate {gate}")


def check_static(size, gate: str):
    """Raise :class:`GatedDimError` if `size` is symbolic: a route chosen
    from a traced size would hold for the example only."""
    if isinstance(size, torch.SymInt):
        raise GatedDimError(gate, size)


def dtype_error(what, dtype) -> TypeError:
    """The error of a wrapper given a dtype it has no kernel for: a
    CUDA tensor never takes the plain version instead."""
    if dtype == torch.float16:
        return TypeError(f"{what}: float16 has no kernel here yet "
                         f"({FP16_ENTRY}); on the card run it in bfloat16")
    return TypeError(f"{what}: dtype {dtype} not supported (float32, "
                     "bfloat16)")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every exported function, by library
_SIGNATURES = {
    "fused_block": {
        "ptt_rmsnorm_qkv": [_I] + [_P] * 12 + [_I] * 4 + [_F, _P, _P],
        "ptt_qkv_splits": [_I] * 6,
        "ptt_mlp": [_I, _I] + [_P] * 9 + [_L, _P, _I, _I, _I, _P, _P],
        "ptt_wgmma_check": [_I, _P, _P, _P, _I, _P],
    },
    "paged_attention": {
        "ptt_paged_decode": [_I] + [_P] * 8 + [_I] * 6 + [_F, _P, _P],
        "ptt_paged_decode_quant": [_I] + [_P] * 10 + [_I] * 6 + [_F, _P,
                                                                 _P],
        "ptt_paged_splits": [_I, _I],
    },
    "flash_attention": {
        "ptt_flash_fwd": [_I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                          _I, _F, _I, _P],
        "ptt_flash_fp32_split": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                                 _P],
        "ptt_flash_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _F, _I, _P],
        "ptt_flash_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _F, _I, _P],
    },
    "quant_matmul": {
        "ptt_quant_matmul": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _P],
        "ptt_quant_splits": [_I, _I, _I, _I],
    },
    "cross_entropy": {
        "ptt_ce_fwd": [_I, _P, _P, _P, _P, _I, _I, _P],
        "ptt_ce_bwd": [_I, _P, _P, _P, _P, _P, _I, _I, _P],
    },
    "rmsnorm": {
        "ptt_rmsnorm": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    },
    "fused_decoder": {
        "ptt_fused_decoder": [_I] + [_P] * 20 + [_I] * 8 + [_F, _P, _P],
        "ptt_fused_decoder_grid": [_I, _P],
    },
    "multi_tensor": {
        "ptt_mt_chunk": [],
        "ptt_mt_norm": [_P, _I, _L, _P, _P, _P, _P],
        "ptt_mt_adam": [_P, _I, _L, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P,
                        _P, _P],
        "ptt_mt_digest": [_P, _I, _L, _L, _P, _P, _P, _P],
    },
    "grouped_matmul": {
        "ptt_grouped_ffn_up": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P, _P],
        "ptt_grouped_ffn_down": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _P, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_tickets: Dict[tuple, torch.Tensor] = {}
_workspaces: Dict[tuple, torch.Tensor] = {}
_sms: Dict[torch.device, int] = {}
_frozen = []        # non-empty while no ticket or workspace may be allocated
_held: List[list] = []  # the buffers handed out inside each frozen block


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
            "port's CUDA kernels are built from source at first use")
    return found


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)[:16]}.so"


NVCC_RUNS = 0           # nvcc compiles this process started
_NVCC_VERSION: List[str] = []


def nvcc_runs() -> int:
    return NVCC_RUNS


def nvcc_version() -> str:
    """``nvcc --version``'s last line (its build), once a process;
    ``"none"`` where there is no nvcc."""
    if not _NVCC_VERSION:
        try:
            out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
            lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
            _NVCC_VERSION.append(lines[-1] if lines else "unknown")
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _NVCC_VERSION.append("none")
    return _NVCC_VERSION[0]


def library_key(name: str) -> str:
    """What names library `name` in the persistent cache: the hash of its
    sources, the flags and the nvcc version."""
    h = hashlib.sha256(_source_hash(name).encode())
    h.update(nvcc_version().encode())
    return h.hexdigest()[:16]


def _cache_dir():
    """``<compile cache dir>/kernels`` when the persistent cache is on."""
    from paddle_tpu_torch import compile_cache
    if not compile_cache.enabled():
        return None
    return Path(compile_cache.cache_dir()) / "kernels"


def _cached(name: str, root: Path) -> Path:
    return root / f"lib{name}-{library_key(name)}.so"


def _copy(src: Path, dst: Path):
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_suffix(f".{os.getpid()}.tmp")
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)


def file_sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _sidecar(lib: Path) -> Path:
    return lib.with_name(lib.name + ".sha256")


def verified(lib) -> bool:
    """Whether cached library `lib` exists and its bytes match the sha256
    recorded beside it."""
    lib = Path(lib)
    try:
        return _sidecar(lib).read_text().strip() == file_sha256(lib)
    except OSError:
        return False


def store_library(src, dst, sha256: str = ""):
    """Copy library `src` to `dst` in a cache with its sha256 beside it
    (`sha256` when the caller has checked it already)."""
    dst = Path(dst)
    _copy(Path(src), dst)
    side = _sidecar(dst)
    tmp = side.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(sha256 or file_sha256(dst))
    os.replace(tmp, side)


def _discard(lib: Path):
    lib.unlink(missing_ok=True)
    _sidecar(lib).unlink(missing_ok=True)


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel;
    returns the wall seconds nvcc took (0.0 when every library was built
    or cached).  With the compile cache on, libraries come from it first
    and every library ends up in it.  A failed compile raises with
    nvcc's output."""
    global NVCC_RUNS
    cache = _cache_dir()
    todo = []
    for n in SOURCES:
        out = _target(n)
        if not out.exists() and cache is not None:
            if verified(_cached(n, cache)):
                _copy(_cached(n, cache), out)
            else:
                _discard(_cached(n, cache))
        if not out.exists():
            todo.append((n, out))
    seconds = 0.0
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = []
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            NVCC_RUNS += 1
        errors = []
        for name, out, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}.cu:\n{log.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)    # atomic: concurrent builds agree
        seconds = time.perf_counter() - t0
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    if cache is not None:
        for n in SOURCES:
            if not verified(_cached(n, cache)):
                store_library(_target(n), _cached(n, cache))
    return seconds


def parse_ptxas(log: str, kernels, source: str, report: Dict[str, dict]):
    """Add to `report`, under its mangled name, what a ``-Xptxas -v`` log
    says of each kernel whose mangled name contains one of `kernels`:
    registers, static shared memory, stack, spill stores and loads (bytes
    a thread), and every line that names a performance loss (wgmma
    serialised, for one)."""
    entry = None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?"
                      r"([\w$]+)", line)
        if m:
            kern = next((k for k in kernels if k in m.group(1)), None)
            entry = None if kern is None else report.setdefault(
                m.group(1), {"kernel": kern, "source": source})
            continue
        if entry is None:
            continue
        for key, pat in (("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem_static", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                entry[key] = int(m.group(1))
        if "Performance" in line or "serialized" in line:
            entry.setdefault("notes", []).append(line.strip())
    return report


def ptxas_report(names, kernels) -> Dict[str, dict]:
    """:func:`parse_ptxas` of the sources `names`, compiled once more
    (device code only) with ``-Xptxas -v`` into cubins beside the
    libraries, all at once; the libraries themselves are built with
    FLAGS alone."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    flags = [f for f in FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = []
    for n in names:
        cubin = BUILD_DIR / f"{n}.{os.getpid()}.cubin"
        procs.append((n, cubin, subprocess.Popen(
            [nvcc, *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin),
             str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    report: Dict[str, dict] = {}
    errors = []
    for name, cubin, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        cubin.unlink(missing_ok=True)
        if p.returncode != 0:
            errors.append(f"{name}.cu:\n{log}")
        else:
            parse_ptxas(log, kernels, f"{name}.cu", report)
    if errors:
        raise RuntimeError("nvcc -Xptxas -v failed:\n" + "\n".join(errors))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build_all()
        try:
            lib = ctypes.CDLL(str(_target(name)))
        except OSError:
            # a damaged library (a truncated copy, say): rebuilt by nvcc,
            # counted, or this raises
            _discard(_target(name))
            cache = _cache_dir()
            if cache is not None:
                _discard(_cached(name, cache))
            build_all()
            lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise if a launch reported a CUDA error (a refused launch never
    runs, and a later synchronize would not say so)."""
    if err != 0:
        msg = lib.ptt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def tickets(owner: str, device, n: int) -> torch.Tensor:
    """At least `n` int32 tickets of `owner`'s split kernels on `device`,
    all zero: a launch's last block of each tile (or row) resets its
    ticket, so they stay zero between launches.  Each owner keeps its
    own array, so two kernels' launches never share a ticket; two
    launches of one owner on one device must not run at once on two
    streams."""
    key = (owner, device)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        _refuse_growth("tickets", owner, n)
        t = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=device)
    _hold(t)
    return t


def workspace(owner: str, device, nbytes: int) -> int:
    """The address of at least `nbytes` of scratch memory on `device`,
    kept for `owner` and reused by its next call (grown when a call needs
    more), so a launch allocates nothing: the split kernels' fp32
    partials and the intermediates between two launches of one call.
    Reuse is safe in stream order; as with :func:`tickets`, two launches
    of one owner on one device must not run at once on two streams."""
    key = (owner, device)
    t = _workspaces.get(key)
    if t is None or t.numel() < nbytes:
        _refuse_growth("workspace", owner, nbytes)
        t = _workspaces[key] = torch.empty(max(nbytes, 1 << 16),
                                           dtype=torch.uint8, device=device)
    _hold(t)
    return t.data_ptr()


def _hold(t):
    if _held and not any(h is t for h in _held[-1]):
        _held[-1].append(t)


def _refuse_growth(kind, owner, n):
    if _frozen:
        raise RuntimeError(
            f"{owner} needs a {kind} of {n} that does not exist yet, inside "
            f"{_frozen[-1]}: a buffer allocated there would land in the CUDA "
            "graph's private pool (run the same call once before it)")


@contextlib.contextmanager
def frozen(what: str):
    """Inside the block, :func:`tickets` and :func:`workspace` raise
    rather than allocate or grow a buffer (a CUDA graph's capture: every
    kept buffer must exist before it).  Yields the list of the buffers
    they hand out inside it: a captured graph keeps its addresses, so
    its owner keeps these alive (a later call that grows a buffer
    replaces it in the cache, and the graph's would be freed)."""
    _frozen.append(what)
    _held.append([])
    try:
        yield _held[-1]
    finally:
        _frozen.pop()
        _held.pop()


def sm_count(device) -> int:
    """The streaming multiprocessors of `device`, looked up once (the
    split rules' input)."""
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


# The cost model's counter while one counts (analysis/passes/
# cost_model.py), else None.  A wrapper charges the operations and bytes
# of its kernel (each input read once, each output written once: the
# bound of PERF.md and chip_smoke.py) where it launches it, and where a
# CPU tensor sends it to the plain version; with no counter either costs
# one None check.
COUNTER = None


def charge(what: str, cost, *args):
    """Charge kernel `what` the ``(flops, bytes, products)`` that
    ``cost(*args)`` gives (`products`: whether the FLOPs are those of
    matrix products)."""
    c = COUNTER
    if c is not None:
        with c.paused():
            c.kernel(what, *cost(*args))


def plain(what: str, cost, ref, *args):
    """``ref(*args)``, the plain version of kernel `what`, charged as the
    kernel (``cost()`` gives what :func:`charge` takes) and with the
    operations inside it not counted again."""
    c = COUNTER
    if c is None:
        return ref(*args)
    with c.paused():
        c.kernel(what, *cost())
        return ref(*args)
