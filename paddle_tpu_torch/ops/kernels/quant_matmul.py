"""Weight-only quantized matmul — wrapper of the CUDA kernel in
``csrc/quant_matmul.cu`` and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/quant_matmul.py``:
``quant_matmul`` replaces ``_quant_kernel`` (through
``quant_matmul_pallas``).  The weight is int8 or ``float8_e4m3fn`` in the
``[in, out]`` layout with one fp32 scale per output channel.  A tensor on
the CPU takes the plain version; a CUDA tensor launches the kernel or
raises.  The wrapper counts its launches in ``quant_matmul.launches`` and,
per weight mode, in ``quant_matmul.launches_by_mode``.

The TPU package's autotune axis, ``record_path`` counter and
``verify_static`` check are TPU tooling and are not ported (ROADMAP.md,
queue 1); the launch counts take the place of the path counter."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["quant_matmul", "quant_matmul_reference", "weight_dtype",
           "QUANT_WEIGHT_DTYPES"]

QUANT_WEIGHT_DTYPES = ("int8", "fp8")


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
        return quant_matmul_reference(x, qw, scale)
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
        err = lib.ptt_quant_matmul(
            _build.DTYPE_CODES[x.dtype], _build.WEIGHT_CODES[wdt],
            x2.data_ptr(), qw.data_ptr(), scale.data_ptr(), y.data_ptr(), T,
            K, N, _build.stream_of(x))
        _build.check(lib, err, what)
        quant_matmul.launches += 1
        quant_matmul.launches_by_mode[mode] += 1
    return y.reshape(*x.shape[:-1], N)


quant_matmul.launches = 0
quant_matmul.launches_by_mode = dict.fromkeys(QUANT_WEIGHT_DTYPES, 0)
