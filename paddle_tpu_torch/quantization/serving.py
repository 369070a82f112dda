"""Quantized serving — weight-only int8/fp8 conversion and the parity
report (``paddle_tpu/quantization/serving.py``).

* :func:`quantize_for_serving` replaces every large ``Linear`` of a model
  with a weight-only :class:`~paddle_tpu_torch.quantization.QuantedLinear`
  (int8 or ``float8_e4m3fn`` values, one fp32 scale per output channel),
  in place, on the model's device.  Its matmuls run the quant-matmul
  kernel (``ops/kernels/quant_matmul.py``).  Conversion is refcounted:
  several engines can adopt one model, and the last
  :func:`restore_from_serving` puts the original Linears back.
* :func:`quantize_int8_weights` is the engine's ``int8_weights=True``
  (``paddle_tpu/inference/serving.py:178-203``): every Linear and
  Embedding whose 2-D weight has at least ``1 << 16`` elements gets the
  JAX package's int8 codes and ``[1, out]`` fp32 scales bit for bit
  (:func:`quantize_weights_int8`); the Linears run the quant-matmul
  kernel, the embedding gathers int8 rows and scales them.  It shares
  the refcount of :func:`quantize_for_serving` (the mode
  ``"int8_weights"``), so one model holds one conversion at a time.
* :func:`parity_report` — one forward of the same ids through the
  original and the converted model, with the largest absolute and
  relative logit error.

``ContinuousBatchingEngine(quant_weights=...)`` (or the
``PADDLE_TPU_QUANT_WEIGHTS`` environment knob) and
``ContinuousBatchingEngine(int8_weights=True)`` convert at construction
and restore at ``close()``."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["quant_weights_mode", "quantize_linear_weight",
           "quantize_for_serving", "restore_from_serving", "parity_report",
           "quantize_weights_int8", "quantize_int8_weights", "QUANT_MODES",
           "INT8_WEIGHTS", "INT8_WEIGHTS_MIN_SIZE"]

QUANT_MODES = ("int8", "fp8")

# the engine's int8_weights conversion: its refcount mode and the
# smallest weight it converts (serving.py:178)
INT8_WEIGHTS = "int8_weights"
INT8_WEIGHTS_MIN_SIZE = 1 << 16

# fp8 e4m3fn: largest finite magnitude (no inf encoding); symmetric
# absmax scaling maps each channel's max onto it
_FP8_MAX = 448.0


def quant_weights_mode(explicit: Optional[str] = None) -> Optional[str]:
    """The weight-quant mode: an explicit value wins, else the
    ``PADDLE_TPU_QUANT_WEIGHTS`` environment knob.  Returns ``"int8"``,
    ``"fp8"`` or None (off)."""
    raw = explicit if explicit is not None \
        else os.environ.get("PADDLE_TPU_QUANT_WEIGHTS")
    if raw is None:
        return None
    raw = str(raw).strip().lower()
    if raw in ("", "0", "off", "none", "false"):
        return None
    if raw not in QUANT_MODES:
        raise ValueError(
            f"PADDLE_TPU_QUANT_WEIGHTS={raw!r}: expected int8|fp8 "
            "(or unset/0 for the unquantized engine)")
    return raw


def quantize_linear_weight(w: torch.Tensor, mode: str):
    """Symmetric per-output-channel quantization of a ``[in, out]``
    weight: ``(qw, scale)`` with ``qw`` in the mode's storage dtype and
    ``scale`` ``[out]`` fp32, ``dequant = qw * scale``.  The same fp32
    steps as the JAX package, so the bits agree: the channel absmax
    (floored at 1e-12) over ``qmax`` (127 or 448), then ``w / scale``
    rounded half to even and clipped to ±127 (int8) or rounded to nearest
    even e4m3 (fp8)."""
    from paddle_tpu_torch.ops.kernels.quant_matmul import weight_dtype
    wf = w.detach().float()
    qmax = 127.0 if mode == "int8" else _FP8_MAX
    scale = torch.clamp_min(wf.abs().amax(dim=0), 1e-12) / qmax
    scaled = wf / scale[None, :]
    if mode == "int8":
        q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    else:
        q = scaled.to(weight_dtype("fp8"))
    return q, scale


def quantize_weights_int8(w: torch.Tensor):
    """The JAX engine's rule for one floating 2-D weight
    (``serving.py:188-192``): ``scale = max|w| / 127`` over axis 0 as a
    ``[1, out]`` fp32 row (not floored), codes ``round(w / max(scale,
    1e-12))`` half to even, clipped to ±127, as int8.  The same fp32
    steps, so codes and scales equal JAX's bit for bit."""
    wf = w.detach().float()
    # a tensor divisor: true division on the card too
    scale = wf.abs().amax(dim=0, keepdim=True) / torch.tensor(
        127.0, device=wf.device)
    q = torch.clamp(torch.round(wf / torch.clamp_min(scale, 1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale


def _eligible(linear, min_size: int) -> bool:
    w = getattr(linear, "weight", None)
    return w is not None and w.ndim == 2 and w.numel() >= min_size


def _hold(model, mode: str):
    """Take one more reference on an existing conversion of `model`;
    None when it holds none."""
    refs = getattr(model, "_serving_quant_refs", 0)
    if refs == 0:
        return None
    if model._serving_quant_mode != mode:
        raise ValueError(
            f"model already quantized for serving as "
            f"{model._serving_quant_mode!r}; cannot re-quantize as "
            f"{mode!r} while {refs} engine(s) hold it")
    model._serving_quant_refs = refs + 1
    return {"layers": model._serving_quant_layers, "refs": refs + 1}


def _convert(model, mode: str, convert) -> Dict[str, int]:
    """Replace, depth first, every child for which ``convert(child)``
    returns a layer, and open the refcount at 1."""
    converted = 0

    def walk(root):
        nonlocal converted
        for name, child in list(root.named_children()):
            new = convert(child)
            if new is not None:
                new._orig = child
                setattr(root, name, new)
                converted += 1
            else:
                walk(child)

    walk(model)
    model._serving_quant_refs = 1
    model._serving_quant_mode = mode
    model._serving_quant_layers = converted
    return {"layers": converted, "refs": 1}


def quantize_for_serving(model, mode: Optional[str] = None,
                         min_size: int = 4096) -> Dict[str, int]:
    """Convert every ``Linear`` with a 2-D weight of at least `min_size`
    elements into a weight-only :class:`QuantedLinear`, in place.

    Refcounted: converting a converted model only raises the count (and
    a different mode raises ``ValueError``).  Each QuantedLinear keeps its
    source layer as the sublayer ``_orig``, on the device, so the state
    dict names are the JAX package's (``...q_proj._orig.weight``,
    ``...q_proj.qweight``, ``...q_proj.w_scale``).

    Returns ``{"layers": n_converted, "refs": current_refcount}``."""
    mode = quant_weights_mode(mode)
    if mode is None:
        raise ValueError("quantize_for_serving needs mode=int8|fp8 "
                         "(or PADDLE_TPU_QUANT_WEIGHTS set)")
    held = _hold(model, mode)
    if held is not None:
        return held

    from paddle_tpu_torch.nn.common_layers import Linear
    from paddle_tpu_torch.quantization import QuantedLinear

    def convert(child):
        if isinstance(child, Linear) and _eligible(child, min_size):
            return QuantedLinear(child, act_scale=None, mode=mode)
        return None

    return _convert(model, mode, convert)


def quantize_int8_weights(model, min_size: int = INT8_WEIGHTS_MIN_SIZE
                          ) -> Dict[str, int]:
    """The engine's ``int8_weights=True``, in place and refcounted like
    :func:`quantize_for_serving` (mode ``"int8_weights"``): every
    ``Linear`` and ``Embedding`` whose floating 2-D weight has at least
    `min_size` elements (the JAX engine's ``1 << 16``) gets
    :func:`quantize_weights_int8`'s codes and scales.  A Linear becomes a
    :class:`QuantedLinear` over the quant-matmul kernel (the scale taken
    on the fp32 sum, where JAX rounds the dequantized weight to the model
    dtype before its product); an Embedding an :class:`Int8Embedding`,
    bitwise equal to JAX's dequantize-then-gather.  Every source layer
    stays as the sublayer ``_orig`` and comes back at the last
    :func:`restore_from_serving`."""
    held = _hold(model, INT8_WEIGHTS)
    if held is not None:
        return held

    from paddle_tpu_torch.nn.common_layers import Embedding, Linear
    from paddle_tpu_torch.quantization import Int8Embedding, QuantedLinear

    def convert(child):
        if not isinstance(child, (Linear, Embedding)) or \
                not _eligible(child, min_size) or \
                not child.weight.is_floating_point():
            return None
        q, scale = quantize_weights_int8(child.weight)
        if isinstance(child, Embedding):
            return Int8Embedding(child, q, scale)
        return QuantedLinear.from_codes(child, q, scale.reshape(-1), "int8")

    return _convert(model, INT8_WEIGHTS, convert)


def restore_from_serving(model) -> bool:
    """Drop one conversion reference; with the last, swap every
    QuantedLinear and Int8Embedding back to its original layer.  True
    when the model is in its original form."""
    refs = getattr(model, "_serving_quant_refs", 0)
    if refs == 0:
        return True
    if refs > 1:
        model._serving_quant_refs = refs - 1
        return False

    from paddle_tpu_torch.quantization import Int8Embedding, QuantedLinear

    def walk(root):
        for name, child in list(root.named_children()):
            if isinstance(child, (QuantedLinear, Int8Embedding)) and \
                    getattr(child, "_orig", None) is not None:
                setattr(root, name, child._orig)
            else:
                walk(child)

    walk(model)
    model._serving_quant_refs = 0
    model._serving_quant_mode = None
    return True


def parity_report(model, mode: str, sample_ids,
                  min_size: int = 4096) -> Dict[str, float]:
    """Forward `sample_ids` (``[B, S]`` or ``[S]`` integers) through the
    model before and after weight-only conversion; the model is restored
    before returning, whatever happens.

    Returns ``{max_logit_err, ref_logit_absmax, rel_logit_err, layers}``
    (``rel_logit_err``: the largest absolute error over the reference's
    largest magnitude)."""
    ids = torch.as_tensor(np.asarray(sample_ids, np.int64))
    if ids.ndim == 1:
        ids = ids[None]
    dev = next(iter(model.parameters())).device
    ids = ids.to(dev)
    was_training = getattr(model, "training", False)
    if was_training:
        model.eval()
    try:
        with torch.inference_mode():
            ref = model(ids).float()
        info = quantize_for_serving(model, mode, min_size=min_size)
        try:
            with torch.inference_mode():
                got = model(ids).float()
        finally:
            restore_from_serving(model)
    finally:
        if was_training:
            model.train()
    err = float((got - ref).abs().max())
    absmax = float(ref.abs().max())
    return {"max_logit_err": err,
            "ref_logit_absmax": absmax,
            "rel_logit_err": err / max(absmax, 1e-12),
            "layers": info["layers"]}
