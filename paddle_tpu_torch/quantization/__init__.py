"""Quantization of the port (``paddle_tpu.quantization``): weight-only
quantized serving.

:class:`QuantedLinear` is the converted inference layer in its
weight-only flavour: int8 or ``float8_e4m3fn`` weights at rest with one
fp32 scale per output channel, its matmul through the quant-matmul kernel
(``ops/kernels/quant_matmul.py``).  :mod:`.serving` converts a model's
large Linears to it and back.

The calibration side of the JAX package — the weight + activation int8
flavour of ``QuantedLinear`` (``act_scale``), observers, fake-quant,
``PTQ``/``QAT`` — is not ported yet: each raises ``NotImplementedError``
(ROADMAP.md, queue 1)."""

from __future__ import annotations

from typing import Optional

from paddle_tpu_torch.nn.layer import Layer

__all__ = ["QuantedLinear", "quantize_for_serving", "restore_from_serving",
           "quant_weights_mode", "AbsMaxObserver",
           "MovingAverageAbsMaxObserver", "HistogramObserver", "KLObserver",
           "QuantConfig", "PTQ", "QAT", "FakeQuantLinear", "quant_dequant",
           "quantize_weight"]

_CALIBRATION = "calibration tooling is not ported yet (ROADMAP.md, queue " \
    "1: the rest of the serving engine)"


class QuantedLinear(Layer):
    """Weight-only quantized inference layer (``quantization/__init__.py:
    271-322``): buffers ``qweight`` ``[in, out]`` (int8 or
    ``float8_e4m3fn``) and ``w_scale`` ``[out]`` fp32, the source layer's
    ``bias``, and ``quantized = True`` (the marker the Llama layers route
    on).  ``forward``: quant matmul, then the bias, then a cast to x's
    dtype."""

    def __init__(self, linear, act_scale: Optional[float] = None,
                 mode: Optional[str] = None):
        if act_scale is not None or mode is None:
            raise NotImplementedError(
                f"QuantedLinear with act_scale / without mode: {_CALIBRATION}")
        from paddle_tpu_torch.quantization.serving import \
            quantize_linear_weight
        super().__init__(dtype=linear._dtype, device=linear.weight.device)
        q, scale = quantize_linear_weight(linear.weight, mode)
        self.register_buffer("qweight", q)
        self.register_buffer("w_scale", scale)
        self.bias = linear.bias
        self.mode = mode
        self.quantized = True

    def forward(self, x):
        from paddle_tpu_torch.ops.kernels.quant_matmul import quant_matmul
        out = quant_matmul(x, self.qweight, self.w_scale, mode=self.mode)
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype)

    def astype(self, dtype) -> "QuantedLinear":
        """Cast the bias and the kept original layer; ``qweight`` and
        ``w_scale`` keep their storage dtypes."""
        q, s = self.qweight.data, self.w_scale.data
        super().astype(dtype)
        self.qweight.data, self.w_scale.data = q, s
        return self


def _calibration_only(name: str):
    """A class of the calibration side: constructing it raises."""
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name}: {_CALIBRATION}")
    return type(name, (), {"__init__": __init__, "__doc__":
                           f"``{name}`` is not ported yet; constructing it "
                           "raises NotImplementedError."})


AbsMaxObserver = _calibration_only("AbsMaxObserver")
MovingAverageAbsMaxObserver = _calibration_only("MovingAverageAbsMaxObserver")
HistogramObserver = _calibration_only("HistogramObserver")
KLObserver = _calibration_only("KLObserver")
QuantConfig = _calibration_only("QuantConfig")
PTQ = _calibration_only("PTQ")
QAT = _calibration_only("QAT")
FakeQuantLinear = _calibration_only("FakeQuantLinear")


def quant_dequant(*args, **kwargs):
    """Fake-quant with a straight-through gradient: not ported yet."""
    raise NotImplementedError(f"quant_dequant: {_CALIBRATION}")


def quantize_weight(*args, **kwargs):
    """Int8 weight quantization for PTQ/QAT: not ported yet (serving uses
    :func:`.serving.quantize_linear_weight`)."""
    raise NotImplementedError(f"quantize_weight: {_CALIBRATION}")


from paddle_tpu_torch.quantization.serving import (  # noqa: E402
    quant_weights_mode, quantize_for_serving, restore_from_serving)
