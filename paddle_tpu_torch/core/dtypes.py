"""Dtype names → torch dtypes (the Paddle-style spelling the JAX
package uses: ``"float32"``, ``"bfloat16"``, ...)."""

from __future__ import annotations

import torch

_NAME_TO_TORCH = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "float8_e5m2": torch.float8_e5m2,
}

# the top level's dtype names (``paddle_tpu/core/dtypes.py:44-55``): a
# dtype is spelled as its name, as users spell it in paddle
float32 = "float32"
float64 = "float64"
float16 = "float16"
bfloat16 = "bfloat16"
int8 = "int8"
uint8 = "uint8"
int16 = "int16"
int32 = "int32"
int64 = "int64"
bool_ = "bool"
complex64 = "complex64"
complex128 = "complex128"


def is_floating(dtype) -> bool:
    """Whether `dtype` (a name or a torch dtype) is a float or complex
    type (``paddle_tpu/core/dtypes.py:76``)."""
    dt = to_torch(dtype)
    return dt.is_floating_point or dt.is_complex


def to_torch(dtype) -> torch.dtype:
    """Accept a dtype name (``"bfloat16"``, ``"paddle.float32"``) or a
    torch dtype → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.replace("paddle.", "")
        if name in _NAME_TO_TORCH:
            return _NAME_TO_TORCH[name]
    raise ValueError(f"Unknown dtype: {dtype!r}")


def name_of(dtype: torch.dtype) -> str:
    """torch dtype → its name (``torch.bfloat16`` → ``"bfloat16"``)."""
    return str(to_torch(dtype)).replace("torch.", "")
