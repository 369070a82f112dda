"""Pooling (``paddle_tpu/nn/functional/pooling.py``).

The JAX package reduces windows with ``lax.reduce_window`` (no Pallas
kernel).  Here equal padding on both sides of every axis goes to torch's
pooling (cuDNN / ATen on the card); unequal sides, string padding and
the other cases JAX's windows allow go through :func:`_windows`, which
pads (``-inf`` for max, excluded from the count for an exclusive
average) and reduces ``Tensor.unfold`` windows.

- ``ceil_mode`` gives ``ceil`` output lengths (the last window starts
  inside the input or its left padding), as the reference does; the JAX
  package ignores it;
- ``exclusive`` (default True) divides each average by the window's
  elements inside the input, else by those inside the padded input;
  with string padding the JAX package divides by the whole window, and
  so does this port;
- ``return_mask`` (max pooling, 1 to 3 dims, and the adaptive max
  pools) returns int32 indices into each channel's flattened input
  plane, JAX's convention for ``max_pool2d`` (``:74-150``) and what
  ``max_unpool2d`` reads; the first maximum of a window wins.  The JAX
  package returns masks from ``max_pool2d`` only, without ``ceil_mode``.
- ``data_format`` N...C is permuted around the call.

The adaptive pools' windows are ``[floor(i L / o), ceil((i + 1) L / o))``,
JAX's and torch's."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.nn.functional.conv import same_pads

__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "max_unpool2d",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d",
           "adaptive_avg_pool3d", "adaptive_max_pool1d",
           "adaptive_max_pool2d", "adaptive_max_pool3d"]


def _ntuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t * n if len(t) == 1 else t


def _pads(padding, n, sizes, kernel, stride):
    """Per-axis (before, after) pads, and whether they came from a
    string (SAME / VALID)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n, True
        return same_pads(sizes, kernel, stride, (1,) * n), True
    p = _ntuple(padding, n)
    if len(p) == 2 * n:
        return [(p[2 * i], p[2 * i + 1]) for i in range(n)], False
    return [(q, q) for q in p], False


def _out_len(L, k, s, lo, hi, ceil_mode):
    span = L + lo + hi - k
    out = (-(-span // s) if ceil_mode else span // s) + 1
    if ceil_mode and (out - 1) * s >= L + lo:
        out -= 1
    return out


def _torch_ok(pads, kernel, from_string):
    return not from_string and all(
        lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, kernel))


def _windows(x, kernel, stride, pads, ceil_mode, fill, tail_fill=None):
    """``[N, C, *out, *kernel]`` windows of x padded by `pads` with
    `fill`; the ceil-mode tail past the padding takes `tail_fill`
    (default `fill`)."""
    n = len(kernel)
    tails = []
    for i in range(n):
        L = x.shape[2 + i]
        lo, hi = pads[i]
        out = _out_len(L, kernel[i], stride[i], lo, hi, ceil_mode)
        tails.append(max(0, (out - 1) * stride[i] + kernel[i]
                         - (L + lo + hi)))
    xp = TF.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi],
                value=fill)
    if any(tails):
        xp = TF.pad(xp, [p for t in reversed(tails) for p in (0, t)],
                    value=fill if tail_fill is None else tail_fill)
    for i in range(n):
        xp = xp.unfold(2 + i, kernel[i], stride[i])
    return xp


def _max(x, kernel, stride, padding, n, ceil_mode, return_mask):
    kernel = _ntuple(kernel, n)
    stride = _ntuple(stride if stride is not None else kernel, n)
    pads, from_str = _pads(padding, n, x.shape[2:], kernel, stride)
    if _torch_ok(pads, kernel, from_str):
        fn = (TF.max_pool1d, TF.max_pool2d, TF.max_pool3d)[n - 1]
        out = fn(x, kernel, stride, [lo for lo, _ in pads], 1, ceil_mode,
                 return_mask)
        if return_mask:
            return out[0], out[1].to(torch.int32)
        return out
    neg = float("-inf") if x.is_floating_point() else \
        torch.iinfo(x.dtype).min
    win = _windows(x, kernel, stride, pads, ceil_mode, neg)
    flat = win.flatten(-n)
    out, arg = flat.max(dim=-1)
    if not return_mask:
        return out
    # each window element's index in the unpadded input plane
    plane = math.prod(x.shape[2:])
    idx = torch.arange(plane, device=x.device).reshape(
        (1, 1) + tuple(x.shape[2:]))
    iw = _windows(idx.to(torch.float64), kernel, stride, pads, ceil_mode,
                  -1.0)
    iw = iw.flatten(-n)
    iw = iw.expand(x.shape[0], x.shape[1], *iw.shape[2:])
    mask = torch.gather(iw, -1, arg.unsqueeze(-1)).squeeze(-1)
    return out, mask.to(torch.int32)


def _avg(x, kernel, stride, padding, n, ceil_mode, exclusive,
         divisor_override=None):
    kernel = _ntuple(kernel, n)
    stride = _ntuple(stride if stride is not None else kernel, n)
    pads, from_str = _pads(padding, n, x.shape[2:], kernel, stride)
    if _torch_ok(pads, kernel, from_str):
        sym = [lo for lo, _ in pads]
        if n == 1:
            return TF.avg_pool1d(x, kernel, stride, sym, ceil_mode,
                                 not exclusive)
        fn = TF.avg_pool2d if n == 2 else TF.avg_pool3d
        return fn(x, kernel, stride, sym, ceil_mode, not exclusive,
                  divisor_override)
    win = _windows(x.float(), kernel, stride, pads, ceil_mode, 0.0)
    summed = win.sum(dim=tuple(range(-n, 0)))
    if divisor_override:
        return (summed / divisor_override).to(x.dtype)
    if from_str:
        return (summed / math.prod(kernel)).to(x.dtype)
    # counted: the input, and without `exclusive` the explicit padding
    # too (never the ceil-mode tail)
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float32,
                      device=x.device)
    cw = _windows(ones, kernel, stride, pads, ceil_mode,
                  0.0 if exclusive else 1.0, 0.0)
    counts = cw.sum(dim=tuple(range(-n, 0)))
    return (summed / counts).to(x.dtype)


def _nc(fn, x, data_format, *args):
    """`fn` on channels-first x, permuted for N...C."""
    if data_format.startswith("NC"):
        return fn(x, *args)
    out = fn(torch.movedim(x, -1, 1), *args)
    if isinstance(out, tuple):
        return tuple(torch.movedim(o, 1, -1) for o in out)
    return torch.movedim(out, 1, -1)


@eager_op
def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL"):
    return _nc(_max, x, data_format, kernel_size, stride, padding, 1,
               ceil_mode, return_mask)


@eager_op
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    return _nc(_max, x, data_format, kernel_size, stride, padding, 2,
               ceil_mode, return_mask)


@eager_op
def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW"):
    return _nc(_max, x, data_format, kernel_size, stride, padding, 3,
               ceil_mode, return_mask)


@eager_op
def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL"):
    return _nc(_avg, x, data_format, kernel_size, stride, padding, 1,
               ceil_mode, exclusive)


@eager_op
def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    return _nc(_avg, x, data_format, kernel_size, stride, padding, 2,
               ceil_mode, exclusive, divisor_override)


@eager_op
def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    return _nc(_avg, x, data_format, kernel_size, stride, padding, 3,
               ceil_mode, exclusive, divisor_override)


@eager_op
def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW"):
    """Pooled values back at their argmax positions (scatter-assign),
    zeros elsewhere; `indices` as ``max_pool2d(return_mask=True)``
    gives them.  The default output is ``(in - 1) * stride + k - 2 p``."""
    if data_format != "NCHW":
        raise NotImplementedError("max_unpool2d: NCHW only")
    k = _ntuple(kernel_size, 2)
    s = _ntuple(stride if stride is not None else k, 2)
    p = _ntuple(padding, 2)
    n, c, ph, pw = x.shape
    if output_size is None:
        oh = (ph - 1) * s[0] + k[0] - 2 * p[0]
        ow = (pw - 1) * s[1] + k[1] - 2 * p[1]
    else:
        oh, ow = int(output_size[-2]), int(output_size[-1])
    out = torch.zeros((n, c, oh * ow), dtype=x.dtype, device=x.device)
    out.scatter_(2, indices.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return out.reshape(n, c, oh, ow)


def _adaptive(x, output_size, n, op, return_mask=False):
    out = _ntuple(output_size, n)
    out = tuple(x.shape[2 + i] if o is None else o for i, o in
                enumerate(out))
    if op == "avg":
        fn = (TF.adaptive_avg_pool1d, TF.adaptive_avg_pool2d,
              TF.adaptive_avg_pool3d)[n - 1]
        return fn(x, out)
    fn = (TF.adaptive_max_pool1d, TF.adaptive_max_pool2d,
          TF.adaptive_max_pool3d)[n - 1]
    got = fn(x, out, return_mask)
    if return_mask:
        return got[0], got[1].to(torch.int32)
    return got


@eager_op
def adaptive_avg_pool1d(x, output_size):
    return _adaptive(x, output_size, 1, "avg")


@eager_op
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    return _nc(_adaptive, x, data_format, output_size, 2, "avg")


@eager_op
def adaptive_avg_pool3d(x, output_size, data_format="NCDHW"):
    return _nc(_adaptive, x, data_format, output_size, 3, "avg")


@eager_op
def adaptive_max_pool1d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 1, "max", return_mask)


@eager_op
def adaptive_max_pool2d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 2, "max", return_mask)


@eager_op
def adaptive_max_pool3d(x, output_size, return_mask=False):
    return _adaptive(x, output_size, 3, "max", return_mask)
