"""Operators of the port; ``ops.kernels`` holds the CUDA kernels."""
