"""Comparison / logical ops (``paddle_tpu/ops/logic.py``; parity:
python/paddle/tensor/logic.py).

The op wrappers are GENERATED from the schema (``ops/gen/ops.yaml`` ->
``ops/generated_math.py``); this module re-exports the logic subset and
keeps the type predicates."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.generated_math import (  # noqa: F401
    all, allclose, any, bitwise_and, bitwise_left_shift, bitwise_not,
    bitwise_or, bitwise_right_shift, bitwise_xor, equal, equal_all,
    greater_equal, greater_than, isclose, less_equal, less_than,
    logical_and, logical_not, logical_or, logical_xor, not_equal)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_floating_point(x):
    return x.is_floating_point()


def is_integer(x):
    return not (x.is_floating_point() or x.is_complex()) and \
        x.dtype != torch.bool


def is_complex(x):
    return x.is_complex()


__all__ = [
    "all", "allclose", "any", "bitwise_and", "bitwise_left_shift",
    "bitwise_not", "bitwise_or", "bitwise_right_shift", "bitwise_xor",
    "equal", "equal_all", "greater_equal", "greater_than", "isclose",
    "is_complex", "is_floating_point", "is_integer", "is_tensor",
    "less_equal", "less_than", "logical_and", "logical_not", "logical_or",
    "logical_xor", "not_equal"]
