"""Gradient clipping (``paddle_tpu/nn/clip.py``): ``ClipGradByGlobalNorm``,
``ClipGradByNorm`` and ``ClipGradByValue`` on dense gradients.

Each clip object is callable on a list of ``(param, grad)`` pairs, as in
the JAX package, and an optimizer given one as ``grad_clip`` applies it
before its update.  The reference's formula (``clip.py:33-43``): the
global norm is the square root of an fp32 sum of squares over every
gradient, the scale ``min(1, clip_norm / max(gnorm, 1e-12))``, and a
clipped gradient is ``fp32(g) * scale`` cast back to g's own dtype, so a
bf16 gradient rounds to bf16 before ``multi_precision`` lifts it to
fp32.  Under ``ClipGradByGlobalNorm`` the Adam family hands the scale to
the multi-tensor update, which multiplies and rounds at that same point.

A parameter whose ``need_clip`` is False keeps its gradient when the
clip is called on pairs, as an optimizer's eager ``step`` calls it;
``TrainStep`` clips every gradient, as the JAX ``TrainStep``'s
``apply_pytree`` does.

A row-sparse gradient (an embedding's with ``sparse=True``: a sparse
COO tensor or a ``RowSparseGrad``) is clipped as the JAX package clips
one (``clip.py:46-159``): coalesced first, so duplicate rows sum before
the norm or the clamp, then its values scaled or clamped; it comes back
coalesced and in the form it came in, never densified.  Its coalesced
values join the dense gradients in the global norm's one
``multi_tensor_norm`` launch."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.sparse_grad import RowSparseGrad, is_row_sparse

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]


def _values(grads):
    """Each gradient as a tensor of its values: a dense gradient
    itself, a row-sparse one its coalesced values; and the coalesced
    row-sparse gradients by position."""
    vals, sparse = [], {}
    for i, g in enumerate(grads):
        if is_row_sparse(g):
            sparse[i] = RowSparseGrad.of(g).coalesce()
            vals.append(sparse[i].values)
        else:
            vals.append(g)
    return vals, sparse


def _rebuild(grads, vals, sparse):
    """New values back into their gradients' forms."""
    out = []
    for i, (g, v) in enumerate(zip(grads, vals)):
        if i in sparse:
            rs = RowSparseGrad(sparse[i].rows, v, sparse[i].shape,
                               coalesced=True)
            out.append(rs if isinstance(g, RowSparseGrad) else rs.to_torch())
        else:
            out.append(v)
    return out


def clip_scale(norm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """``min(1, clip_norm / max(norm, 1e-12))`` in fp32, a true division
    (``scalar / tensor`` in torch is a reciprocal times the scalar)."""
    num = torch.full_like(norm, clip_norm)
    return torch.clamp_max(num / torch.clamp_min(norm, 1e-12), 1.0)


def scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(g * scale).astype(g.dtype)``: the product in fp32, one
    rounding to g's dtype."""
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def __call__(self, params_grads):
        """``[(param, grad)]`` → the same list with the clipped grads;
        a pair whose grad is None, or whose param has ``need_clip``
        False, passes through."""
        idx = [i for i, (p, g) in enumerate(params_grads)
               if g is not None and getattr(p, "need_clip", True)]
        if not idx:
            return list(params_grads)
        new = self.clip([params_grads[i][1] for i in idx])
        out = list(params_grads)
        for i, g in zip(idx, new):
            out[i] = (params_grads[i][0], g)
        return out

    def clip(self, grads, norm=None):
        """The clipped gradients of `grads`, a list of tensors (`norm`,
        their global norm if the caller has it, is read by the global
        clip alone)."""
        raise NotImplementedError


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def scale(self, grads, norm=None) -> torch.Tensor:
        """The 0-d fp32 scale of `grads`, from their global norm (the
        multi-tensor norm kernel on the card) unless `norm` is given."""
        if norm is None:
            from paddle_tpu_torch.ops.kernels.multi_tensor import \
                multi_tensor_norm
            norm = multi_tensor_norm(_values(grads)[0])
        return clip_scale(norm, self.clip_norm)

    def clip(self, grads, norm=None):
        vals, sparse = _values(grads)
        s = self.scale(vals, norm)
        return _rebuild(grads, [scaled(v, s) for v in vals], sparse)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def clip(self, grads, norm=None):
        vals, sparse = _values(grads)
        return _rebuild(grads, [
            scaled(v, clip_scale(torch.linalg.vector_norm(v.float()),
                                 self.clip_norm)) for v in vals], sparse)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def clip(self, grads, norm=None):
        vals, sparse = _values(grads)
        return _rebuild(grads, [torch.clamp(v, self.min, self.max)
                                for v in vals], sparse)
