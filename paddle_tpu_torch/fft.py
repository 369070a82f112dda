"""paddle.fft parity — the spectral API surface (``paddle_tpu/fft.py``).

Every transform is a generated schema op (``ops/gen/ops.yaml`` ->
``ops/generated_math.py``) over ``torch.fft``; numpy oracles test each
one against the JAX package's."""

from __future__ import annotations

from paddle_tpu_torch.ops.generated_math import (  # noqa: F401
    fft, fft2, fftfreq, fftn, fftshift, hfft, ifft, ifft2, ifftn,
    ifftshift, ihfft, irfft, irfft2, irfftn, rfft, rfft2, rfftfreq, rfftn)

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "rfft",
           "irfft", "rfft2", "irfft2", "rfftn", "irfftn", "hfft", "ihfft",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq"]
