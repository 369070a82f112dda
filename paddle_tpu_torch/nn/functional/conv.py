"""Convolutions (``paddle_tpu/nn/functional/conv.py``).

The JAX package lowers each to ``lax.conv_general_dilated`` (no Pallas
kernel); here each is torch's ``F.conv{n}d`` / ``F.conv_transpose{n}d``
(cuDNN on the card).  The weight layout is the JAX package's (Paddle's):
``[out_c, in_c / groups, *k]``, and ``[in_c, out_c / groups, *k]`` for
the transposes, which is torch's layout too.  Covered:

- stride, dilation and groups;
- padding: an int, one int per spatial axis, ``2n`` ints as (before,
  after) pairs axis by axis, n pairs, or ``"SAME"`` / ``"VALID"``
  (SAME is XLA's: ``ceil(in / stride)`` outputs, the odd pad after);
  unequal sides pad the input first, then convolve unpadded;
- ``data_format`` NC... (default) or N...C (permuted around the call);
- the transposes' ``output_padding`` and ``output_size`` (the latter
  read as the output padding that reaches it; the JAX package ignores
  ``output_size``).  A transpose takes no string padding, as there."""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.dispatch import eager_op

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]


def _ntuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t * n if len(t) == 1 else t


def _pairs(pad, n):
    """Per-axis (before, after) pads, or the string itself."""
    if isinstance(pad, str):
        return pad.upper()
    if isinstance(pad, int):
        return [(pad, pad)] * n
    pad = list(pad)
    if len(pad) == n and all(isinstance(p, int) for p in pad):
        return [(p, p) for p in pad]
    if len(pad) == 2 * n and all(isinstance(p, int) for p in pad):
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(n)]
    return [tuple(int(q) for q in p) for p in pad]


def same_pads(sizes, k, stride, dilation):
    """XLA's SAME padding: ``ceil(in / s)`` outputs, the odd pad after."""
    out = []
    for L, kk, s, d in zip(sizes, k, stride, dilation):
        eff = (kk - 1) * d + 1
        total = max((-(-L // s) - 1) * s + eff - L, 0)
        out.append((total // 2, total - total // 2))
    return out


def _flat(pairs):
    """(before, after) pairs, axis order → ``F.pad``'s list (last axis
    first)."""
    return [p for lo_hi in reversed(pairs) for p in lo_hi]


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    first = data_format.startswith("NC")
    if not first:
        x = torch.movedim(x, -1, 1)
    stride = _ntuple(stride, n)
    dilation = _ntuple(dilation, n)
    pads = _pairs(padding, n)
    k = tuple(weight.shape[2:])
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        pads = same_pads(x.shape[2:], k, stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        x = TF.pad(x, _flat(pads))
        sym = [0] * n
    fn = (TF.conv1d, TF.conv2d, TF.conv3d)[n - 1]
    out = fn(x, weight, bias, stride, sym, dilation, groups)
    return out if first else torch.movedim(out, 1, -1)


def _conv_t(x, weight, bias, stride, padding, output_padding, groups,
            dilation, output_size, n, data_format):
    first = data_format.startswith("NC")
    if not first:
        x = torch.movedim(x, -1, 1)
    stride = _ntuple(stride, n)
    dilation = _ntuple(dilation, n)
    pads = _pairs(padding, n)
    if isinstance(pads, str):
        raise ValueError("string padding unsupported for conv_transpose")
    k = tuple(weight.shape[2:])
    sizes = x.shape[2:]
    base = [(L - 1) * s + (kk - 1) * d + 1 - lo - hi
            for L, s, kk, d, (lo, hi) in zip(sizes, stride, k, dilation,
                                             pads)]
    if output_size is not None:
        want = _ntuple(output_size, n)[-n:]
        opad = tuple(int(w) - b for w, b in zip(want, base))
    else:
        opad = _ntuple(output_padding, n)
    fn = (TF.conv_transpose1d, TF.conv_transpose2d,
          TF.conv_transpose3d)[n - 1]
    if all(lo == hi for lo, hi in pads) and all(
            0 <= o < max(s, d) for o, s, d in zip(opad, stride, dilation)):
        out = fn(x, weight, bias, stride, [lo for lo, _ in pads], opad,
                 groups, dilation)
        return out if first else torch.movedim(out, 1, -1)
    # unequal sides or a large output padding: the unpadded transpose,
    # then the window the padding selects (zeros past its end)
    full = fn(x, weight, None, stride, 0, 0, groups, dilation)
    for i, ((lo, _), b, o) in enumerate(zip(pads, base, opad)):
        ax = 2 + i
        length = b + o
        short = lo + length - full.shape[ax]
        if short > 0:
            widths = [0, 0] * (full.ndim - 2)
            widths[2 * (full.ndim - 1 - ax) + 1] = short
            full = TF.pad(full, widths)
        full = full.narrow(ax, lo, length)
    if bias is not None:
        full = full + bias.reshape((1, -1) + (1,) * n)
    return full if first else torch.movedim(full, 1, -1)


@eager_op
def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


@eager_op
def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


@eager_op
def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


@eager_op
def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL"):
    return _conv_t(x, weight, bias, stride, padding, output_padding, groups,
                   dilation, output_size, 1, data_format)


@eager_op
def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW"):
    return _conv_t(x, weight, bias, stride, padding, output_padding, groups,
                   dilation, output_size, 2, data_format)


@eager_op
def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW"):
    return _conv_t(x, weight, bias, stride, padding, output_padding, groups,
                   dilation, output_size, 3, data_format)
