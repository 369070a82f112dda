"""Normalization functionals (``paddle_tpu/nn/functional/norm.py``).

The conv-side norms keep the JAX package's arithmetic: statistics in
fp32 (the variance biased), the normalised activations cast back to
x's dtype, and only then the weight and the bias.  ``batch_norm`` with
an fp32 (or fp64) input is torch's ``F.batch_norm`` (cuDNN on the card:
one forward and one backward launch; its ``(x - mean) * rsqrt(var +
eps)`` rounds within an ulp of JAX's division); other dtypes take the
JAX package's operations.  ``batch_norm`` never updates running statistics:
the BatchNorm layers do (``norm_layers.py``) from
:func:`batch_norm_stats`."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.nn.functional.fused import _needs_grad
from paddle_tpu_torch.ops.kernels import rmsnorm as _RN

__all__ = ["layer_norm", "rms_norm", "rms_norm_residual", "batch_norm",
           "batch_norm_stats", "instance_norm", "group_norm",
           "local_response_norm"]


@eager_op
def layer_norm(x: torch.Tensor, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5) -> torch.Tensor:
    """Layer norm over the trailing ``normalized_shape`` axes, statistics
    in fp32 (``norm.py:16-32``): the normalised activations are cast back
    to x's dtype, and only then multiplied by the weight and shifted by
    the bias."""
    ndim = 1 if isinstance(normalized_shape, int) else \
        len(tuple(normalized_shape))
    axes = tuple(range(x.ndim - ndim, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = torch.square(xf - mean).mean(dim=axes, keepdim=True)
    out = ((xf - mean) / torch.sqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


@eager_op
def rms_norm(x: torch.Tensor, weight=None, epsilon: float = 1e-6,
             axis: int = -1) -> torch.Tensor:
    """RMS norm over ``axis``, statistics in fp32.  The cast points are
    the JAX package's (``norm.py:34-42``): the normalised activations
    are cast back to x's dtype before the weight multiplies them, and the
    weight broadcasts against x's trailing axes."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=axis, keepdim=True)
    out = (xf * torch.reciprocal(torch.sqrt(ms + epsilon))).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out


@eager_op
def rms_norm_residual(x: torch.Tensor, weight: torch.Tensor, residual=None,
                      epsilon: float = 1e-5):
    """``(y, h)``: h = x (+ residual), y = RMSNorm(h) * weight in the fused
    form (fp32 statistics and weight multiply, one cast), as
    ``norm.py:45-63``.  The returned ``h`` is the pre-norm sum the next
    residual branch consumes.  On the card the fused kernel
    (``ops/kernels/rmsnorm.py``), on the CPU its plain version; where
    autograd needs a gradient, through the custom VJP of both."""
    d = x.shape[-1]
    if not _needs_grad(*(t for t in (x, weight, residual) if t is not None)):
        y, h, _ = _RN.fused_rmsnorm(x, weight, residual, epsilon)
        return y, h
    x2d = x.reshape(-1, d)
    has_res = residual is not None
    # no residual: x is the unread placeholder, as in the JAX package
    res2d = residual.reshape(-1, d) if has_res else x2d
    y, h = _RN.FusedRMSNorm.apply(x2d, res2d, weight, float(epsilon),
                                  has_res)
    return y.reshape(x.shape), h.reshape(x.shape)


def _chan_axis(x, data_format):
    return 1 if data_format.startswith("NC") and x.ndim > 1 else x.ndim - 1


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@eager_op
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """Normalise over every axis but the channel axis (``norm.py:66-92``):
    with the batch's statistics in training (unless
    ``use_global_stats``), else with `running_mean` / `running_var`."""
    ax = _chan_axis(x, data_format)
    use_batch = training and not use_global_stats
    if x.dtype in (torch.float32, torch.float64):
        xc = torch.movedim(x, ax, 1) if ax != 1 else x
        out = torch.nn.functional.batch_norm(
            xc, None if use_batch else running_mean,
            None if use_batch else running_var, weight, bias,
            training=use_batch, eps=epsilon)
        return torch.movedim(out, 1, ax) if ax != 1 else out
    shape = [1] * x.ndim
    shape[ax] = x.shape[ax]
    axes = tuple(i for i in range(x.ndim) if i != ax)
    xf = x.float()
    if use_batch:
        var, mean = torch.var_mean(xf, dim=axes, correction=0)
    else:
        mean, var = running_mean.float(), running_var.float()
    out = ((xf - mean.reshape(shape)) /
           torch.sqrt(var.reshape(shape) + epsilon)).to(x.dtype)
    return _affine(out, weight, bias, shape)


def batch_norm_stats(x, data_format="NCHW"):
    """``(mean, var)`` of the batch over the non-channel axes, fp32 (fp64
    for an fp64 input), the variance biased (what the running statistics
    take)."""
    ax = _chan_axis(x, data_format)
    axes = tuple(i for i in range(x.ndim) if i != ax)
    xf = x if x.dtype == torch.float64 else x.float()
    var, mean = torch.var_mean(xf, dim=axes, correction=0)
    return mean, var


@eager_op
def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW"):
    """Per sample and channel over the spatial axes."""
    if data_format.startswith("NC"):
        axes = tuple(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
    else:
        axes = tuple(range(1, x.ndim - 1))
        shape = (1,) * (x.ndim - 1) + (-1,)
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=axes, correction=0, keepdim=True)
    out = ((xf - mean) / torch.sqrt(var + eps)).to(x.dtype)
    return _affine(out, weight, bias, shape)


@eager_op
def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW"):
    """Channels in `num_groups` groups, each normalised with the
    spatial axes."""
    if data_format == "NCHW" or x.ndim == 2:
        b, c = x.shape[:2]
        spatial = tuple(x.shape[2:])
        xg = x.reshape((b, num_groups, c // num_groups) + spatial)
        axes = tuple(range(2, xg.ndim))
        shape = (1, c) + (1,) * len(spatial)
    else:
        b, c = x.shape[0], x.shape[-1]
        spatial = tuple(x.shape[1:-1])
        xg = x.reshape((b,) + spatial + (num_groups, c // num_groups))
        axes = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
        shape = (1,) * (x.ndim - 1) + (c,)
    xf = xg.float()
    var, mean = torch.var_mean(xf, dim=axes, correction=0, keepdim=True)
    out = ((xf - mean) / torch.sqrt(var + epsilon)).to(x.dtype)
    return _affine(out.reshape(x.shape), weight, bias, shape)


@eager_op
def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW"):
    """``x / (k + alpha * mean of x^2 over `size` channels) ** beta``,
    the window centred (``size // 2`` before)."""
    ax = 1 if data_format.startswith("NC") else x.ndim - 1
    half = size // 2
    c = x.shape[ax]
    sq = torch.movedim(torch.square(x), ax, -1)
    sq = torch.nn.functional.pad(sq, (half, size - 1 - half))
    acc = torch.zeros(sq.shape[:-1] + (c,), dtype=torch.float32,
                      device=x.device)
    for i in range(size):
        acc = acc + sq[..., i:i + c].float()
    div = torch.pow(k + alpha * acc / size, beta).to(x.dtype)
    return x / torch.movedim(div, -1, ax)
