"""Weight-only quantized matmul — wrapper of the CUDA kernel in
``csrc/quant_matmul.cu`` and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py``:
``quant_matmul`` replaces ``_quant_kernel`` (through
``quant_matmul_pallas``).  The weight is int8 or ``float8_e4m3fn`` in the
``[in, out]`` layout with one fp32 scale per output channel.  A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or
raises.  The wrapper counts its launches in ``quant_matmul.launches``,
per weight mode in ``quant_matmul.launches_by_mode`` and per kernel
design in ``quant_matmul.launches_by_path``: ``splitk`` (bf16, T <= 16),
``wgmma`` (bf16, T > 16) and ``tile`` (fp32 io).  Every call also counts
in the JAX package's series ``paddle_tpu_quant_kernel_path_total{kernel=
"matmul_<mode>", path}`` (:func:`record_path`, ``quant_matmul.py:91-101``):
``path="pallas"`` where the CUDA kernel launched, ``"fallback"`` where the
plain version ran.

Split-K takes a workspace: fp32 partials of the output, one a split
(the C entry's count, the rule of ``splitk.py``; ``splits * T * N * 4``
bytes, 1.2 MB for q/o at T = 8, 16 MB for the lm_head at T = 16), allocated per call where there is more than one
split, and one int32 ticket per 128-column tile, kept per device and
zero between launches (the kernel's last block of a tile resets it), so
two launches that share a device must not run at once on two streams.

The TPU package's autotune axis and ``verify_static`` check are TPU
tooling and are not ported (ROADMAP.md, queue 1)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build, costs
from paddle_tpu_torch.ops.kernels.splitk import SPLITK_BN, SPLITK_MAX_T

__all__ = ["quant_matmul", "quant_matmul_reference", "weight_dtype",
           "kernel_path", "record_path", "QUANT_WEIGHT_DTYPES",
           "QUANT_PATHS"]

QUANT_WEIGHT_DTYPES = ("int8", "fp8")
QUANT_PATHS = ("splitk", "wgmma", "tile")

def record_path(kernel: str, path: str):
    """One call in ``paddle_tpu_quant_kernel_path_total{kernel, path}``:
    ``"pallas"`` names the launched CUDA kernel, ``"fallback"`` the plain
    version (the JAX package's labels)."""
    from paddle_tpu_torch.observability import default_registry
    default_registry().counter(
        "paddle_tpu_quant_kernel_path_total",
        "quantized-kernel implementation chosen at trace time",
        labelnames=("kernel", "path")).labels(kernel=kernel,
                                              path=path).inc()


def kernel_path(T: int, dtype) -> str:
    """The design a launch of T rows in io dtype `dtype` takes."""
    if dtype != torch.bfloat16:
        return "tile"
    return "splitk" if T <= SPLITK_MAX_T else "wgmma"


def weight_dtype(mode: str) -> torch.dtype:
    """The storage dtype of a quant mode: ``int8`` or ``fp8``
    (``torch.float8_e4m3fn``)."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quant mode {mode!r}; expected int8|fp8")


def quant_matmul_reference(x, qw, scale):
    """``quant_matmul_reference`` (``quant_matmul.py:185-195``): the
    weight up-converted to x's dtype, fp32 accumulation, the
    per-output-channel scale on the fp32 accumulator, one final cast."""
    w = qw.to(x.dtype)
    acc = torch.matmul(x.float(), w.float())
    return (acc * scale.reshape(-1).float()).to(x.dtype)


def quant_matmul(x, qw, scale, mode: str = "int8"):
    """``x [..., K] @ dequant(qw [K, N], scale [N]) -> [..., N]`` in x's
    dtype.  ``mode`` names the weight's storage (``int8`` | ``fp8``) and
    must agree with ``qw.dtype``.  The kernel takes float32 or bfloat16
    activations, K and N multiples of 64, contiguous 16-byte-aligned
    operands."""
    wdt = weight_dtype(mode)
    if qw.dtype != wdt:
        raise TypeError(f"quant_matmul: mode {mode!r} stores {wdt}, the "
                        f"weight is {qw.dtype}")
    if x.device.type == "cpu":
        record_path(f"matmul_{mode}", "fallback")
        return _build.plain(
            "quant_matmul", lambda: costs.quant_matmul(x, qw, scale),
            quant_matmul_reference, x, qw, scale)
    what = "quant_matmul"
    K = x.shape[-1]
    N = qw.shape[1] if qw.ndim == 2 else -1
    scale = scale.reshape(-1)
    if qw.shape != (K, N) or scale.shape != (N,):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, qw "
                         f"{tuple(qw.shape)}, scale {tuple(scale.shape)} do "
                         "not agree")
    if K % 64 or N % 64:
        raise ValueError(f"{what}: K={K} and N={N} must be multiples of 64")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32, "
                        "bfloat16)")
    x2 = x.reshape(-1, K)
    for name, t, dt in (("x", x2, x.dtype), ("qw", qw, wdt),
                        ("scale", scale, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    T = x2.shape[0]
    y = torch.empty((T, N), dtype=x.dtype, device=x.device)
    if T:
        lib = _build.library("quant_matmul")
        code = _build.DTYPE_CODES[x.dtype]
        ws = tickets = None
        splits = lib.ptt_quant_splits(code, T, K, N)
        if splits > 1:
            ws = torch.empty(splits * T * N, dtype=torch.float32,
                             device=x.device)
            tickets = _build.tickets("quant_matmul", x.device,
                                     -(-N // SPLITK_BN))
        err = lib.ptt_quant_matmul(
            code, _build.WEIGHT_CODES[wdt], x2.data_ptr(), qw.data_ptr(),
            scale.data_ptr(), y.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(), T, K, N,
            _build.stream_of(x))
        _build.check(lib, err, what)
        _build.charge(what, costs.quant_matmul, x, qw, scale)
        quant_matmul.launches += 1
        quant_matmul.launches_by_mode[mode] += 1
        quant_matmul.launches_by_path[kernel_path(T, x.dtype)] += 1
    record_path(f"matmul_{mode}", "pallas")
    return y.reshape(*x.shape[:-1], N)


quant_matmul.launches = 0
quant_matmul.launches_by_mode = dict.fromkeys(QUANT_WEIGHT_DTYPES, 0)
quant_matmul.launches_by_path = dict.fromkeys(QUANT_PATHS, 0)
