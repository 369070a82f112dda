"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  The build happens at
first use, from the sources in this directory alone, into
``ops/kernels/build/`` (ignored by git); a library whose name carries the
hash of its sources and flags is reused.  All sources build at once, one
``nvcc`` each, started together.

Every C entry point takes its pointers and the stream as ``c_void_p`` and
returns the CUDA error of its launch, which :func:`check` raises on."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

__all__ = ["library", "build_all", "ptxas_report", "parse_ptxas", "check",
           "stream_of", "tickets", "workspace", "sm_count", "DTYPE_CODES",
           "WEIGHT_CODES", "FLOAT16_CODE", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_block", "paged_attention", "flash_attention",
           "quant_matmul", "grouped_matmul", "cross_entropy", "rmsnorm",
           "fused_decoder")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
# dtype codes of the C interface (csrc/common.cuh, enum DType): the io
# types every kernel takes, the stored types of quantized weights, and
# float16, which only the cross-entropy kernels take
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WEIGHT_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}
FLOAT16_CODE = 4

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
        "ptt_flash_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
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


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel;
    returns the wall seconds spent (0.0 when everything was cached).
    A failed compile raises with nvcc's output."""
    todo = [(n, _target(n)) for n in SOURCES if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
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
        t = _tickets[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                        device=device)
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
        t = _workspaces[key] = torch.empty(max(nbytes, 1 << 16),
                                           dtype=torch.uint8, device=device)
    return t.data_ptr()


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
