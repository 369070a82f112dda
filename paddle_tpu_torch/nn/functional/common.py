"""Common functionals (``paddle_tpu/nn/functional/common.py``): linear,
embedding, the dropouts, cosine similarity and the bilinear form.  Pad,
interpolation, fold / unfold and the pixel / channel shuffles come with
conv (ROADMAP.md, queue 1, item 7.3)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.core import state as _state

__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "cosine_similarity", "bilinear"]


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


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of `weight` at the ids; rows of ``padding_idx`` come back
    zero.  ``sparse=True`` (row-sparse gradients) raises: ROADMAP.md,
    queue 1, item 7.2."""
    if sparse:
        raise NotImplementedError(
            "embedding(sparse=True): row-sparse gradients are not ported "
            "yet (ROADMAP.md, queue 1, item 7.2)")
    return _embedding_dense(x, weight, padding_idx=padding_idx)


def dropout(x: torch.Tensor, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train") -> torch.Tensor:
    """Zero each element with probability `p` (``common.py:24-55``).

    ``upscale_in_train`` scales the kept elements by ``1 / (1 - p)`` in
    training and is the identity in eval; ``downscale_in_infer`` keeps
    them unscaled in training and multiplies by ``1 - p`` in eval.  With
    `axis` (an int or a list) one mask is drawn over those axes and
    broadcast along the others.  The mask comes from the device's global
    generator (``core.state.generator``)."""
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
                      generator=_state.generator(x.device)) < (1.0 - p)
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
                      generator=_state.generator(x.device)) < (1.0 - p)
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
