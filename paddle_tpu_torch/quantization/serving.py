"""Quantized serving — weight-only int8/fp8 conversion and the parity
report (``paddle_tpu/quantization/serving.py``).

* :func:`quantize_for_serving` replaces every large ``Linear`` of a model
  with a weight-only :class:`~paddle_tpu_torch.quantization.QuantedLinear`
  (int8 or ``float8_e4m3fn`` values, one fp32 scale per output channel),
  in place, on the model's device.  Its matmuls run the quant-matmul
  kernel (``ops/kernels/quant_matmul.py``).  Conversion is refcounted:
  several engines can adopt one model, and the last
  :func:`restore_from_serving` puts the original Linears back.
* :func:`parity_report` — one forward of the same ids through the
  original and the converted model, with the largest absolute and
  relative logit error.

``ContinuousBatchingEngine(quant_weights=...)`` (or the
``PADDLE_TPU_QUANT_WEIGHTS`` environment knob) converts at construction
and restores at ``close()``."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["quant_weights_mode", "quantize_linear_weight",
           "quantize_for_serving", "restore_from_serving", "parity_report",
           "QUANT_MODES"]

QUANT_MODES = ("int8", "fp8")

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


def _eligible(linear, min_size: int) -> bool:
    w = getattr(linear, "weight", None)
    return w is not None and w.ndim == 2 and w.numel() >= min_size


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
    refs = getattr(model, "_serving_quant_refs", 0)
    if refs > 0:
        if model._serving_quant_mode != mode:
            raise ValueError(
                f"model already quantized for serving as "
                f"{model._serving_quant_mode!r}; cannot re-quantize as "
                f"{mode!r} while {refs} engine(s) hold it")
        model._serving_quant_refs = refs + 1
        return {"layers": model._serving_quant_layers, "refs": refs + 1}

    from paddle_tpu_torch.nn.common_layers import Linear
    from paddle_tpu_torch.quantization import QuantedLinear

    converted = 0

    def walk(root):
        nonlocal converted
        for name, child in list(root.named_children()):
            if isinstance(child, Linear) and _eligible(child, min_size):
                q = QuantedLinear(child, act_scale=None, mode=mode)
                q._orig = child
                setattr(root, name, q)
                converted += 1
            else:
                walk(child)

    walk(model)
    model._serving_quant_refs = 1
    model._serving_quant_mode = mode
    model._serving_quant_layers = converted
    return {"layers": converted, "refs": 1}


def restore_from_serving(model) -> bool:
    """Drop one conversion reference; with the last, swap every
    QuantedLinear back to its original Linear.  True when the model is in
    its original form."""
    refs = getattr(model, "_serving_quant_refs", 0)
    if refs == 0:
        return True
    if refs > 1:
        model._serving_quant_refs = refs - 1
        return False

    from paddle_tpu_torch.quantization import QuantedLinear

    def walk(root):
        for name, child in list(root.named_children()):
            if isinstance(child, QuantedLinear) and \
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
