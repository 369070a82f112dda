"""Utilities of the port (``paddle_tpu.utils``): the native host
components' build and load (``cpp_extension.load_native``)."""

from paddle_tpu_torch.utils.cpp_extension import (  # noqa: F401
    NativeBuildError, load_native)

__all__ = ["NativeBuildError", "load_native"]
