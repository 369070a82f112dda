"""The sparse-gradient embedding lookup
(``paddle_tpu/nn/functional/sparse_embed.py``): a :class:`PyLayer` whose
backward gives the weight a row-sparse gradient, a hybrid sparse COO
tensor of the looked-up rows (``core/sparse_grad.py``), so no
``[vocab, d]`` gradient is ever made.  The rows of ``padding_idx`` look
up as zero and get a zero gradient."""

from __future__ import annotations

import torch

from paddle_tpu_torch.autograd import PyLayer
from paddle_tpu_torch.core.sparse_grad import RowSparseGrad

__all__ = ["sparse_embedding_lookup"]


class _SparseEmbedding(PyLayer):
    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        ctx.ids = ids
        ctx.padding_idx = padding_idx
        ctx.wshape = tuple(weight.shape)
        out = weight[ids]
        if padding_idx is not None:
            out = torch.where((ids == padding_idx)[..., None],
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device), out)
        return out

    @staticmethod
    def backward(ctx, g):
        rows = ctx.ids.reshape(-1)
        vals = g.reshape(-1, g.shape[-1])
        if ctx.padding_idx is not None:
            vals = torch.where((rows != ctx.padding_idx)[:, None], vals,
                               torch.zeros((), dtype=vals.dtype,
                                           device=vals.device))
        return RowSparseGrad(rows, vals, ctx.wshape).to_torch()


def sparse_embedding_lookup(x, weight, padding_idx=None):
    if x.is_floating_point() or x.is_complex():
        raise TypeError(f"embedding ids must be integer, got {x.dtype}")
    return _SparseEmbedding.apply(weight, x, padding_idx)
