"""Linear and Embedding (``paddle_tpu/nn/common_layers.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Linear", "Embedding"]


class Linear(Layer):
    """y = x @ W + b with W of shape ``[in, out]`` (the JAX package's
    layout, so weights copy across without a transpose)."""

    def __init__(self, in_features, out_features, bias_attr=None,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter([in_features, out_features])
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([out_features], is_bias=True)

    def forward(self, x):
        out = torch.matmul(x, self.weight)
        if self.bias is not None:
            out = out + self.bias
        return out


class Embedding(Layer):
    """Row lookup into a ``[num_embeddings, embedding_dim]`` table,
    initialised N(0, 1)."""

    def __init__(self, num_embeddings, embedding_dim, dtype="float32",
                 device=None):
        super().__init__(dtype=dtype, device=device)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim],
            default_initializer=I.Normal(0.0, 1.0))

    def forward(self, ids):
        return self.weight[ids]
