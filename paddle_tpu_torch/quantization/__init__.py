"""Quantization of the port (``paddle_tpu.quantization``): calibration
(observers, fake-quant, ``PTQ`` / ``QAT``) and quantized serving.

Calibration (``quantization/__init__.py:49-400``): the four observers
collect activation ranges (abs-max, moving average, histogram, KL), the
histogram ones in float64 numpy on the host as in the JAX package;
:func:`quant_dequant` is symmetric fake-quant with JAX's straight-through
gradient; ``FakeQuantLinear`` fake-quantizes a Linear's weight and input
for QAT; ``PTQ`` and ``QAT`` wrap a model's Linears, then convert them to
:class:`QuantedLinear`.

:class:`QuantedLinear` has the JAX package's two flavours:

* weight + activation int8 (``act_scale`` given, the PTQ / QAT convert
  target): the input rounded to int8 codes at ``act_scale``, an int8 x
  int8 product accumulated in int32 (:func:`int8_linear_accumulate`:
  ``torch._int_mm`` on the card, an exact float64 product on the CPU;
  JAX has no Pallas kernel for it either, ``lax.dot_general`` with int32
  accumulation), rescaled by ``act_scale * w_scale``;
* weight-only (``act_scale=None``): int8 or ``float8_e4m3fn`` codes with
  one fp32 scale per output channel through the quant-matmul kernel
  (``ops/kernels/quant_matmul.py``); without ``mode`` the codes are
  :func:`quantize_weight`'s, clipped to [-128, 127].

The JAX package's quirks are kept (ROADMAP.md, queue 3):
``FakeQuantLinear`` and ``PTQ`` always observe with a
``MovingAverageAbsMaxObserver`` whatever ``QuantConfig`` names, and
``QuantConfig.add_type_config`` ignores its observer arguments.  The
observers read their ranges on the host (``float(...)``), so a
calibration or fake-quant forward cannot run inside a captured CUDA
graph, as it cannot run under ``jit`` in JAX.

:mod:`.serving` converts a model's large Linears (and, for the engine's
``int8_weights``, its embeddings: :class:`Int8Embedding`) and back."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.nn.layer import Layer

__all__ = ["AbsMaxObserver", "MovingAverageAbsMaxObserver",
           "HistogramObserver", "KLObserver", "QuantConfig",
           "PTQ", "QAT", "FakeQuantLinear", "QuantedLinear",
           "Int8Embedding", "quant_dequant", "quantize_weight",
           "int8_linear_accumulate", "quantize_for_serving",
           "restore_from_serving", "quant_weights_mode"]


# -- quant math --------------------------------------------------------------

def _qmax(bits: int) -> float:
    return 2.0 ** (bits - 1) - 1


def _over_qmax(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``t / qmax``, a true division in t's dtype on every device."""
    return t / torch.tensor(_qmax(bits), dtype=t.dtype, device=t.device)


def _absmax_scale(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """``max(max|x|, 1e-8) / qmax`` (``:51-53``), 0-d in x's dtype."""
    return _over_qmax(torch.clamp_min(x.abs().amax(), 1e-8), bits)


def _weak(value, like: torch.Tensor) -> torch.Tensor:
    """A Python number as JAX takes a weakly typed scalar: in `like`'s
    dtype (a bf16 operand rounds it to bf16 first), 0-d on its device.
    Dividing by a tensor is a true division on every device (a CUDA
    division by a Python scalar multiplies by its reciprocal, and a
    CUDA operand of another dtype is not rounded first), so card and
    CPU give the same bits."""
    return torch.tensor(float(value), dtype=like.dtype, device=like.device)


class _QuantDequant(torch.autograd.Function):
    """``q = clip(round(v / s), -qmax - 1, qmax); q * s`` with JAX's
    straight-through backward (``:56-76``): the gradient passes where
    ``|v / s| <= qmax + 1``, and s gets zeros."""

    @staticmethod
    def forward(ctx, v, s, qmax):
        ctx.save_for_backward(v, s)
        ctx.qmax = qmax
        q = torch.clamp(torch.round(v / s), -qmax - 1, qmax)
        return q * s

    @staticmethod
    def backward(ctx, g):
        v, s = ctx.saved_tensors
        mask = (torch.abs(v / s) <= ctx.qmax + 1).to(g.dtype)
        gs = torch.zeros_like(s) if ctx.needs_input_grad[1] else None
        return g * mask, gs, None


def quant_dequant(x, scale, bits: int = 8) -> torch.Tensor:
    """Symmetric fake-quant with a straight-through gradient; `scale` a
    tensor, or a number taken in x's dtype (a JAX weak scalar)."""
    if not torch.is_tensor(scale):
        scale = _weak(scale, x)
    return _QuantDequant.apply(x, scale, _qmax(bits))


def quantize_weight(w, bits: int = 8, axis: Optional[int] = None):
    """Real quantization (``:79-91``): ``(int8 codes, scale)``, per
    channel along `axis` when given (the out-features axis of a
    ``[in, out]`` weight is 1; the scale keeps the reduced axes as 1).
    Codes are clipped to [-128, 127], scales floored at 1e-8."""
    w = w.detach()
    qmax = _qmax(bits)
    if axis is None:
        scale = _absmax_scale(w, bits)
    else:
        red = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
        scale = _over_qmax(torch.clamp_min(
            w.abs().amax(dim=red, keepdim=True), 1e-8), bits)
    q = torch.clamp(torch.round(w / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale


def int8_linear_accumulate(x, act_scale: float, qweight, bits: int = 8):
    """The int32 accumulators of the W8A8 product: x rounded to int8
    codes at `act_scale` (``clip(round(x / act_scale), -qmax - 1,
    qmax)``, the scale taken in x's dtype as JAX takes a Python scalar),
    times the int8 ``[in, out]`` weight, summed exactly in int32.  On the card ``torch._int_mm`` (rows padded past 16, as it
    requires; K and N must be multiples of 8); on the CPU a float64
    product, exact while every sum stays below 2^53."""
    qmax = _qmax(bits)
    xq = torch.clamp(torch.round(x / _weak(act_scale, x)),
                     -qmax - 1, qmax).to(torch.int8)
    K, N = qweight.shape
    x2 = xq.reshape(-1, K)
    if x2.device.type == "cpu":
        acc = torch.matmul(x2.double(), qweight.double()).to(torch.int32)
    else:
        if K % 8 or N % 8:
            raise ValueError(f"int8_linear_accumulate: K={K} and N={N} "
                             "must be multiples of 8 on the card")
        T = x2.shape[0]
        pad = max(17, -(-T // 8) * 8) - T
        if pad:
            x2 = torch.cat([x2, x2.new_zeros(pad, K)])
        acc = torch._int_mm(x2.contiguous(), qweight.contiguous())[:T]
    return acc.reshape(*x.shape[:-1], N)


# -- observers ---------------------------------------------------------------

def _absmax_of(x) -> float:
    return float(x.detach().abs().amax())


class AbsMaxObserver:
    """Running ``max|x|`` over calibration batches → scale."""

    def __init__(self, quant_bits: int = 8):
        self.bits = quant_bits
        self._absmax = 0.0

    def observe(self, x):
        self._absmax = max(self._absmax, _absmax_of(x))

    __call__ = observe

    def scale(self) -> float:
        return max(self._absmax, 1e-8) / _qmax(self.bits)


class HistogramObserver(AbsMaxObserver):
    """An |x| histogram over the calibration batches (float64, re-binned
    into a wider range when a batch exceeds it); the scale from the
    `percent` quantile of its mass."""

    def __init__(self, quant_bits: int = 8, bins_count: int = 2048,
                 percent: float = 0.9999):
        super().__init__(quant_bits)
        self.bins_count = bins_count
        self.percent = percent
        self._hist = np.zeros(bins_count, np.float64)
        self._range = 0.0

    def observe(self, x):
        arr = np.abs(x.detach().float().cpu().numpy()).ravel()
        cur_max = float(arr.max()) if arr.size else 0.0
        if cur_max > self._range:
            # re-bin the existing histogram into the wider range
            if self._range > 0.0 and self._hist.sum() > 0:
                old_edges = np.linspace(0, self._range, self.bins_count + 1)
                centers = (old_edges[:-1] + old_edges[1:]) / 2
                new_hist, _ = np.histogram(
                    centers, bins=self.bins_count, range=(0, cur_max),
                    weights=self._hist)
                self._hist = new_hist.astype(np.float64)
            self._range = cur_max
        if self._range > 0.0 and arr.size:
            h, _ = np.histogram(arr, bins=self.bins_count,
                                range=(0, self._range))
            self._hist += h

    __call__ = observe

    def _threshold(self) -> float:
        total = self._hist.sum()
        if total == 0:
            return 1e-8
        cdf = np.cumsum(self._hist) / total
        idx = int(np.searchsorted(cdf, self.percent))
        idx = min(idx, self.bins_count - 1)
        return (idx + 1) * self._range / self.bins_count

    def scale(self) -> float:
        return max(self._threshold(), 1e-8) / _qmax(self.bits)


class KLObserver(HistogramObserver):
    """Entropy calibration: the clip threshold minimising
    KL(P_clipped || Q_quantized) over the histogram."""

    def __init__(self, quant_bits: int = 8, bins_count: int = 2048):
        super().__init__(quant_bits, bins_count=bins_count)

    def _threshold(self) -> float:
        total = self._hist.sum()
        if total == 0:
            return 1e-8
        levels = 2 ** (self.bits - 1)  # 128 for int8
        hist = self._hist
        best_kl, best_i = np.inf, self.bins_count
        for i in range(levels, self.bins_count + 1, 16):
            p = hist[:i].copy()
            p[i - 1] += hist[i:].sum()  # clip mass into the last bin
            p_sum = p.sum()
            if p_sum == 0:
                continue
            # the first i bins quantized down to `levels` buckets, then
            # expanded back, each bucket's mass over its nonzero bins
            chunks = np.array_split(hist[:i], levels)
            q = np.zeros(i)
            start = 0
            for c in chunks:
                n = len(c)
                nz = c > 0
                if nz.any():
                    q[start:start + n][nz] = c[nz].sum() / nz.sum()
                start += n
            q_sum = q.sum()
            if q_sum == 0:
                continue
            pn = p / p_sum
            qn = q / q_sum
            mask = pn > 0
            kl = float(np.sum(pn[mask] * np.log(
                pn[mask] / np.maximum(qn[mask], 1e-12))))
            if kl < best_kl:
                best_kl, best_i = kl, i
        return best_i * self._range / self.bins_count


class MovingAverageAbsMaxObserver(AbsMaxObserver):
    """``absmax = rate * absmax + (1 - rate) * max|x|`` after the first
    batch, in Python floats."""

    def __init__(self, quant_bits: int = 8, moving_rate: float = 0.9):
        super().__init__(quant_bits)
        self.rate = moving_rate
        self._initialized = False

    def observe(self, x):
        cur = _absmax_of(x)
        if not self._initialized:
            self._absmax = cur
            self._initialized = True
        else:
            self._absmax = self.rate * self._absmax + (1 - self.rate) * cur

    __call__ = observe


# -- config ------------------------------------------------------------------

class QuantConfig:
    """Which layer types get quantized (``Linear`` when none is added).
    The observer factories are kept but nothing reads them, as in the
    JAX package."""

    def __init__(self, activation=None, weight=None):
        self.activation_factory = activation or AbsMaxObserver
        self.weight_factory = weight or AbsMaxObserver
        self._layer_types = []

    def add_type_config(self, layer_types, activation=None, weight=None):
        if not isinstance(layer_types, (list, tuple)):
            layer_types = [layer_types]
        self._layer_types.extend(layer_types)

    def should_quantize(self, layer) -> bool:
        from paddle_tpu_torch.nn.common_layers import Linear
        types = self._layer_types or [Linear]
        return isinstance(layer, tuple(types))


# -- quantized layers --------------------------------------------------------

class FakeQuantLinear(Layer):
    """QAT wrapper: the wrapped Linear's weight fake-quantized at its
    abs-max scale and (with ``quant_act``) its input at the moving
    average of the inputs' abs-max, both with straight-through
    gradients."""

    def __init__(self, linear, weight_bits: int = 8, act_bits: int = 8,
                 quant_act: bool = True):
        super().__init__(dtype=linear._dtype, device=linear.weight.device)
        self.linear = linear
        self.weight_bits = weight_bits
        self.act_bits = act_bits
        self.quant_act = quant_act
        self.act_observer = MovingAverageAbsMaxObserver(act_bits)

    def forward(self, x):
        w = self.linear.weight
        w_scale = _absmax_scale(w.detach(), self.weight_bits)
        wq = quant_dequant(w, w_scale, bits=self.weight_bits)
        if self.quant_act:
            self.act_observer.observe(x)
            xq = quant_dequant(x, self.act_observer.scale(),
                               bits=self.act_bits)
        else:
            xq = x
        out = torch.matmul(xq, wq)
        if self.linear.bias is not None:
            out = out + self.linear.bias
        return out


class _Coded(Layer):
    """A layer holding int8 / fp8 codes ``qweight`` and fp32 (or, for
    PTQ / QAT, the weight's dtype) scales ``w_scale``: ``astype`` casts
    the rest and leaves both in their storage dtypes."""

    def astype(self, dtype):
        q, s = self.qweight.data, self.w_scale.data
        super().astype(dtype)
        self.qweight.data, self.w_scale.data = q, s
        return self


class QuantedLinear(_Coded):
    """Converted inference layer: buffers ``qweight`` ``[in, out]`` and
    ``w_scale`` ``[out]``, the source layer's ``bias``, and ``quantized =
    True`` (the JAX package's routing marker).

    With ``act_scale`` (the PTQ / QAT target) the forward is the W8A8
    product (:func:`int8_linear_accumulate`) times ``act_scale *
    w_scale``; without, the weight-only quant matmul (``mode`` int8 or
    fp8 with the serving rule, or :func:`quantize_weight`'s int8 codes
    when ``mode`` is None).  Then the bias, then a cast to x's dtype."""

    def __init__(self, linear, act_scale: Optional[float] = None,
                 bits: int = 8, mode: Optional[str] = None):
        if mode is None:
            q, scale = quantize_weight(linear.weight, bits=bits, axis=1)
            scale = scale.reshape(-1)
        else:
            from paddle_tpu_torch.quantization.serving import \
                quantize_linear_weight
            q, scale = quantize_linear_weight(linear.weight, mode)
        self._setup(linear, q, scale, mode or "int8", act_scale, bits)

    @classmethod
    def from_codes(cls, linear, q, scale, mode: str) -> "QuantedLinear":
        """A weight-only layer over codes and ``[out]`` scales made
        elsewhere (the engine's ``int8_weights`` rule)."""
        self = cls.__new__(cls)
        self._setup(linear, q, scale, mode, None, 8)
        return self

    def _setup(self, linear, q, scale, mode, act_scale, bits):
        Layer.__init__(self, dtype=linear._dtype,
                       device=linear.weight.device)
        if act_scale is None:
            # the quant matmul takes fp32 scales (a bf16 scale of a bf16
            # weight widens exactly)
            scale = scale.float()
        self.register_buffer("qweight", q)
        self.register_buffer("w_scale", scale)
        self.bias = linear.bias
        self.act_scale = act_scale
        self.bits = bits
        self.mode = mode
        self.quantized = True

    def forward(self, x):
        if self.act_scale is not None:
            acc = int8_linear_accumulate(x, self.act_scale, self.qweight,
                                         self.bits)
            out = acc.float() * (_weak(self.act_scale, self.w_scale) *
                                 self.w_scale)
        else:
            from paddle_tpu_torch.ops.kernels.quant_matmul import \
                quant_matmul
            out = quant_matmul(x, self.qweight, self.w_scale, mode=self.mode)
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype)


class Int8Embedding(_Coded):
    """The engine's ``int8_weights`` embedding: int8 codes ``qweight``
    ``[V, d]`` and fp32 scales ``w_scale`` ``[1, d]`` (one a hidden
    column, JAX's axis-0 rule).  A lookup gathers the int8 rows, then
    ``(rows.f32 * scale).astype(dtype)``: JAX's op order, bitwise equal to
    its dequantize-then-gather.  ``weight`` is the whole dequantized
    table (what a tied lm_head reads), made at each read."""

    quantized = True

    def __init__(self, embedding, q, scale):
        super().__init__(dtype=embedding._dtype,
                         device=embedding.weight.device)
        self.register_buffer("qweight", q)
        self.register_buffer("w_scale", scale)

    def _out_dtype(self):
        return self._orig.weight.dtype

    def forward(self, ids):
        return (self.qweight[ids].float() * self.w_scale[0]).to(
            self._out_dtype())

    @property
    def weight(self) -> torch.Tensor:
        return (self.qweight.float() * self.w_scale).to(self._out_dtype())


def _walk_replace(root: Layer, config: QuantConfig, make):
    from paddle_tpu_torch.nn.common_layers import Linear
    for name, child in list(root.named_children()):
        if config.should_quantize(child) and isinstance(child, Linear):
            setattr(root, name, make(child))
        else:
            _walk_replace(child, config, make)


class _Calib(Layer):
    """PTQ's calibration wrapper: observes its input, then runs the
    Linear unchanged (state-dict names ``inner.weight``)."""

    def __init__(self, linear, obs):
        super().__init__(dtype=linear._dtype, device=linear.weight.device)
        self.inner = linear
        self.obs = obs
        self._ptq_target = linear

    def forward(self, x):
        self.obs.observe(x)
        return self.inner(x)


class PTQ:
    """Post-training quantization: wrap (observers collect the inputs'
    ranges) → calibrate (the caller's forwards) → convert (W8A8
    :class:`QuantedLinear`)."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: Layer, inplace: bool = True) -> Layer:
        self._observers: Dict[int, MovingAverageAbsMaxObserver] = {}

        def make(linear):
            obs = MovingAverageAbsMaxObserver(8)
            self._observers[id(linear)] = obs
            return _Calib(linear, obs)
        _walk_replace(model, self.config, make)
        return model

    def convert(self, model: Layer, inplace: bool = True) -> Layer:
        def unwrap_calib(root):
            for name, child in list(root.named_children()):
                if isinstance(child, _Calib):
                    setattr(root, name, QuantedLinear(
                        child._ptq_target, act_scale=child.obs.scale()))
                else:
                    unwrap_calib(child)
        unwrap_calib(model)
        return model


class QAT:
    """Quantization-aware training: ``FakeQuantLinear`` wrappers, then,
    after training, W8A8 :class:`QuantedLinear` layers."""

    def __init__(self, config: Optional[QuantConfig] = None):
        self.config = config or QuantConfig()

    def quantize(self, model: Layer, inplace: bool = True) -> Layer:
        _walk_replace(model, self.config, lambda lin: FakeQuantLinear(lin))
        return model

    def convert(self, model: Layer, inplace: bool = True) -> Layer:
        def conv(root):
            for name, child in list(root.named_children()):
                if isinstance(child, FakeQuantLinear):
                    setattr(root, name, QuantedLinear(
                        child.linear, act_scale=child.act_observer.scale()
                        if child.quant_act else None))
                else:
                    conv(child)
        conv(model)
        return model


from paddle_tpu_torch.quantization.serving import (  # noqa: E402
    quant_weights_mode, quantize_for_serving, restore_from_serving)
