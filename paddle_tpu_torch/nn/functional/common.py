"""Common functionals (``paddle_tpu/nn/functional/common.py``): linear,
embedding (dense, or with a row-sparse gradient), the dropouts, cosine
similarity, the bilinear form, and the conv side: one_hot,
label_smooth, normalize, the pixel / channel shuffles, unfold / fold,
interpolate / upsample, affine_grid, grid_sample, zeropad2d and
temporal_shift."""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.core import state as _state
from paddle_tpu_torch.ops.manipulation import pad  # noqa: F401 (JAX's)

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "cosine_similarity", "bilinear", "one_hot",
           "label_smooth", "normalize", "pixel_shuffle", "pixel_unshuffle",
           "channel_shuffle", "unfold", "fold", "interpolate", "upsample",
           "affine_grid", "grid_sample", "zeropad2d", "temporal_shift",
           "pad"]


@eager_op
def linear(x, weight, bias=None):
    """``x @ weight + bias`` with the ``[in, out]`` weight."""
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias
    return out


def _embedding_pure(x, weight, padding_idx=None):
    out = weight[x]
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


# on the hook as the JAX package's dense path is (``common.py:92``)
_embedding_dense = eager_op(_embedding_pure, name="embedding")


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids; rows of ``padding_idx`` come back
    zero.  With ``sparse=True`` the weight's gradient is row-sparse (a
    sparse COO tensor of the looked-up rows, ``sparse_embed.py``) when
    the weight is a leaf that requires grad, grad mode is on, no
    substitution is active (``functional_call``, ``TrainStep``) and no
    CUDA graph is being captured; otherwise the dense path runs, as the
    JAX package's does (``common.py:95-113``)."""
    if sparse and _sparse_ok(weight):
        from paddle_tpu_torch.nn.functional.sparse_embed import \
            sparse_embedding_lookup
        return sparse_embedding_lookup(x, weight, padding_idx)
    return _embedding_dense(x, weight, padding_idx=padding_idx)


def _sparse_ok(weight) -> bool:
    from paddle_tpu_torch.core import functional as _func
    return (weight.is_leaf and weight.requires_grad
            and torch.is_grad_enabled()
            and not _func.substitution_active()
            and not (weight.is_cuda
                     and torch.cuda.is_current_stream_capturing()))


def _generator(device) -> torch.Generator:
    """The dropout stream of a functional call with ``rngs``, else the
    device's global generator."""
    from paddle_tpu_torch.core import functional as _func
    return _func.next_functional_generator("dropout", device) or \
        _state.generator(device)


def dropout(x: torch.Tensor, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train") -> torch.Tensor:
    """Zero each element with probability `p` (``common.py:24-55``).

    ``upscale_in_train`` scales the kept elements by ``1 / (1 - p)`` in
    training and is the identity in eval; ``downscale_in_infer`` keeps
    them unscaled in training and multiplies by ``1 - p`` in eval.  With
    `axis` (an int or a list) one mask is drawn over those axes and
    broadcast along the others.  The mask comes from the device's global
    generator (``core.state.generator``), or from the ``"dropout"``
    stream of a ``functional_call`` given ``rngs``."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return _dropout_scale(x, 1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.ndim for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, device=x.device,
                      generator=_generator(x.device)) < (1.0 - p)
    return _dropout_mask(x, keep, p, mode == "upscale_in_train")


# the masking on the hook as "dropout", as the JAX package dispatches it
# (``common.py:33, 54``); the mask is drawn before, from the generator
@eager_op(name="dropout")
def _dropout_mask(x, keep, p, upscale):
    kept = x / (1.0 - p) if upscale else x
    return torch.where(keep, kept, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(x.dtype)


@eager_op(name="dropout")
def _dropout_scale(x, keep_prob):
    return (x * keep_prob).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Whole channels dropped: one mask over batch and channel."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW"):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True):
    """SELU-preserving dropout (``common.py:67-81``): dropped elements
    take ``-alpha * scale``, then ``a * x + b`` keeps the mean and the
    variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.rand(x.shape, device=x.device,
                      generator=_generator(x.device)) < (1.0 - p)
    return _alpha_drop(x, keep, p, alpha_p)


@eager_op(name="alpha_dropout")
def _alpha_drop(x, keep, p, alpha_p):
    a = (1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5)
    b = -a * alpha_p * p
    dropped = torch.where(keep, x, torch.tensor(alpha_p, dtype=x.dtype,
                                                device=x.device))
    return (a * dropped + b).to(x.dtype)


@eager_op
def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.linalg.vector_norm(x1, dim=axis)
    n2 = torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp_min(n1 * n2, eps)


@eager_op
def bilinear(x1, x2, weight, bias=None):
    """``x1 W x2`` per output with weight ``[out, in1, in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    if bias is not None:
        out = out + bias
    return out


# -- the conv side (``common.py:116-371``) ------------------------------------
#
# ``interpolate`` follows the reference's modes through torch's: nearest
# (``floor(out * in / size)``), (bi/tri)linear and bicubic with
# ``align_corners``, area.  The JAX package resizes with
# ``jax.image.resize`` instead, which ignores ``align_corners``,
# antialiases a downsample and samples nearest at pixel centres; the two
# agree on upsampling by whole factors with ``align_corners=False``
# (ROADMAP.md, queue 3).  ``grid_sample`` keeps the JAX package's default
# ``align_corners=True``.

def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@eager_op
def one_hot(x, num_classes):
    """float32 one-hot rows (``jax.nn.one_hot``: an id out of range gives
    a row of zeros)."""
    ids = x.long()
    valid = (ids >= 0) & (ids < num_classes)
    out = TF.one_hot(torch.where(valid, ids, 0), num_classes)
    return (out * valid[..., None]).to(torch.float32)


@eager_op
def label_smooth(label, prior_dist=None, epsilon=0.1):
    k = label.shape[-1]
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / k


@eager_op
def normalize(x, p=2, axis=1, epsilon=1e-12):
    norm = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


@eager_op
def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    if data_format == "NCHW":
        return TF.pixel_shuffle(x, upscale_factor)
    r = upscale_factor
    b, h, w, c = x.shape
    oc = c // (r * r)
    x = x.reshape(b, h, w, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, oc)


@eager_op
def pixel_unshuffle(x, downscale_factor, data_format="NCHW"):
    if data_format == "NCHW":
        return TF.pixel_unshuffle(x, downscale_factor)
    out = TF.pixel_unshuffle(torch.movedim(x, -1, 1), downscale_factor)
    return torch.movedim(out, 1, -1)


@eager_op
def channel_shuffle(x, groups, data_format="NCHW"):
    if data_format == "NCHW":
        b, c, h, w = x.shape
        return x.reshape(b, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(b, c, h, w)
    b, h, w, c = x.shape
    return x.reshape(b, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(b, h, w, c)


@eager_op
def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1):
    """``[b, c * kh * kw, L]`` patches, channel-major (torch's and JAX's
    order)."""
    return TF.unfold(x, _pair(kernel_sizes), _pair(dilations),
                     _pair(paddings), _pair(strides))


@eager_op
def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1):
    """The adjoint of unfold: overlapping patches summed."""
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   _pair(dilations), _pair(paddings), _pair(strides))


_MODES = {"nearest": "nearest", "linear": "linear", "bilinear": "bilinear",
          "trilinear": "trilinear", "bicubic": "bicubic", "area": "area"}


@eager_op
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW"):
    first = data_format.startswith("NC")
    if not first:
        x = torch.movedim(x, -1, 1)
    spatial = x.shape[2:]
    if size is None:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * len(spatial)
        size = [int(s * f) for s, f in zip(spatial, scale_factor)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size] * len(spatial))]
    tmode = _MODES[mode]
    kw = {}
    if tmode in ("linear", "bilinear", "trilinear", "bicubic"):
        kw["align_corners"] = bool(align_corners)
    out = TF.interpolate(x, size=size, mode=tmode, **kw)
    return out if first else torch.movedim(out, 1, -1)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW", name=None):
    return interpolate(x, size=size, scale_factor=scale_factor, mode=mode,
                       align_corners=align_corners, data_format=data_format)


@eager_op
def affine_grid(theta, out_shape, align_corners=True):
    """``[n, h, w, 2]`` sampling grid of the affine maps `theta`
    ``[n, 2, 3]``."""
    return TF.affine_grid(theta, [int(s) for s in out_shape],
                          align_corners=align_corners)


@eager_op
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(f"grid_sample mode {mode}")
    if padding_mode not in ("zeros", "border"):
        raise NotImplementedError(f"grid_sample padding {padding_mode}")
    return TF.grid_sample(x, grid.to(x.dtype), mode=mode,
                          padding_mode=padding_mode,
                          align_corners=align_corners)


@eager_op
def zeropad2d(x, padding, data_format="NCHW"):
    """Zero-pad H and W; `padding` an int or ``[left, right, top,
    bottom]``."""
    if isinstance(padding, int):
        padding = (padding,) * 4
    left, right, top, bottom = padding
    if data_format == "NCHW":
        return TF.pad(x, (left, right, top, bottom))
    return TF.pad(x, (0, 0, left, right, top, bottom))


@eager_op
def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM's shift: the first ``c * shift_ratio`` channels move one
    segment back, the next as many one segment forward."""
    if data_format != "NCHW":
        raise NotImplementedError("temporal_shift: NCHW only")
    nt, c, h, w = x.shape
    n = nt // seg_num
    f = int(c * shift_ratio)
    xr = x.reshape(n, seg_num, c, h, w)
    back = torch.cat([xr[:, 1:, :f], torch.zeros_like(xr[:, :1, :f])], 1)
    fwd = torch.cat([torch.zeros_like(xr[:, :1, f:2 * f]),
                     xr[:, :-1, f:2 * f]], 1)
    return torch.cat([back, fwd, xr[:, :, 2 * f:]], 2).reshape(nt, c, h, w)
