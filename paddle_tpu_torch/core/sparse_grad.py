"""Row-sparse gradients (``paddle_tpu/core/sparse_grad.py``): the
SelectedRows analog of an embedding's ``sparse=True`` gradient.

On torch's tape the gradient is torch's own hybrid sparse COO tensor
(one sparse dimension, the rows; one dense, the width), so torch's
``AccumulateGrad`` keeps the JAX package's rules: two sparse gradients
concatenate their rows, a sparse and a dense one give a dense one.
:class:`RowSparseGrad` is the JAX package's API over the same pair of
tensors: ``rows`` ([N] int64, torch's index type; JAX's are int32) and
``values`` ([N, d]).  :meth:`RowSparseGrad.of` reads a COO tensor and
:meth:`RowSparseGrad.to_torch` makes one, neither copying the values.
The optimizers and the clips take either form."""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["RowSparseGrad", "is_row_sparse"]


def is_row_sparse(g) -> bool:
    """True for a :class:`RowSparseGrad` or a sparse COO tensor."""
    return isinstance(g, RowSparseGrad) or (
        torch.is_tensor(g) and g.layout == torch.sparse_coo)


class RowSparseGrad:
    """A gradient of shape `shape` that is zero outside `rows`.

    ``rows`` may repeat (a token twice in a batch): the semantics are
    scatter-add.  :meth:`coalesce` gives unique rows with summed values;
    the moment updates need that form, SGD's scatter-add does not."""

    def __init__(self, rows, values, shape: Tuple[int, ...],
                 coalesced: bool = False):
        self.rows = torch.as_tensor(rows, dtype=torch.int64,
                                    device=values.device)
        self.values = values
        self.shape = tuple(int(s) for s in shape)
        self.coalesced = coalesced
        if tuple(self.values.shape[1:]) != self.shape[1:]:
            raise ValueError(
                f"values trailing dims {tuple(self.values.shape[1:])} != "
                f"dense trailing dims {self.shape[1:]}")

    @classmethod
    def of(cls, g) -> "RowSparseGrad":
        """`g` as a RowSparseGrad: itself, or a sparse COO tensor's
        indices and values (views, no copy)."""
        if isinstance(g, RowSparseGrad):
            return g
        if g.sparse_dim() != 1:
            raise ValueError(f"a row-sparse gradient has one sparse "
                             f"dimension, got {g.sparse_dim()}")
        return cls(g._indices()[0], g._values(), tuple(g.shape),
                   coalesced=g.is_coalesced())

    def to_torch(self) -> torch.Tensor:
        """The hybrid sparse COO tensor over the same values."""
        return torch.sparse_coo_tensor(
            self.rows.reshape(1, -1), self.values, self.shape,
            is_coalesced=self.coalesced, check_invariants=False)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def nnz_rows(self) -> int:
        return int(self.rows.shape[0])

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.rows, self.values)

    def coalesce(self) -> "RowSparseGrad":
        """Unique rows (ascending) with summed values; a grad already
        coalesced is returned as it is (the clip coalesces, the
        optimizer does not pay again)."""
        if self.coalesced:
            return self
        uniq, inv = torch.unique(self.rows, return_inverse=True)
        summed = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                             dtype=self.values.dtype,
                             device=self.values.device)
        summed.index_add_(0, inv, self.values)
        return RowSparseGrad(uniq, summed, self.shape, coalesced=True)

    def scale(self, s) -> "RowSparseGrad":
        return RowSparseGrad(self.rows, self.values * s, self.shape,
                             coalesced=self.coalesced)

    def astype(self, dtype) -> "RowSparseGrad":
        from paddle_tpu_torch.core import dtypes as _dtypes
        return RowSparseGrad(self.rows,
                             self.values.to(_dtypes.to_torch(dtype)),
                             self.shape, coalesced=self.coalesced)

    def __add__(self, other):
        if is_row_sparse(other):
            other = RowSparseGrad.of(other)
            if other.shape != self.shape:
                raise ValueError(f"shape mismatch {self.shape} vs "
                                 f"{other.shape}")
            return RowSparseGrad(torch.cat([self.rows, other.rows]),
                                 torch.cat([self.values, other.values]),
                                 self.shape)
        # sparse + dense -> dense
        return self.to_dense() + other

    __radd__ = __add__

    def __repr__(self):
        return (f"RowSparseGrad(shape={self.shape}, "
                f"nnz_rows={self.nnz_rows}, dtype={self.dtype})")
