"""TensorArray ops (``paddle_tpu/ops/array_ops.py``; reference:
python/paddle/tensor/array.py — create_array / array_write /
array_read / array_length).

A TensorArray is a plain Python list of tensors, as in the reference's
dygraph branch.  Indices are read on the host."""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["create_array", "array_write", "array_read", "array_length"]


def _index(i) -> int:
    idx = int(i.item() if isinstance(i, torch.Tensor) else i)
    if idx < 0:
        raise IndexError(f"TensorArray indices are non-negative positions, "
                         f"got {idx}")
    return idx


def _tensor(v):
    if isinstance(v, torch.Tensor):
        return v
    from paddle_tpu_torch.ops.creation import to_tensor
    return to_tensor(v)


def create_array(dtype: str = "float32",
                 initialized_list: Optional[List] = None) -> List:
    """New TensorArray, optionally seeded (reference array.py:222)."""
    return [_tensor(v) for v in (initialized_list or [])]


def array_write(x, i, array: Optional[List] = None) -> List:
    """Write x at index i, growing the array as needed
    (reference array.py:141: i == len appends, i < len overwrites)."""
    if array is None:
        array = []
    idx = _index(i)
    if idx > len(array):
        raise IndexError(f"array_write index {idx} beyond length "
                         f"{len(array)} (only append or overwrite)")
    x = _tensor(x)
    if idx == len(array):
        array.append(x)
    else:
        array[idx] = x
    return array


def array_read(array: List, i):
    """Read array[i] (reference array.py:73)."""
    return array[_index(i)]


def array_length(array: List) -> int:
    """Length (reference array.py:24)."""
    return len(array)
