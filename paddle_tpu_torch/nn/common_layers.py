"""Linear, Embedding, Dropout and LayerList
(``paddle_tpu/nn/common_layers.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.layer import Layer

__all__ = ["Linear", "Embedding", "Dropout", "LayerList"]


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


class Dropout(Layer):
    """``F.dropout`` with the layer's ``training`` flag (``:71``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class LayerList(Layer):
    """A list of sublayers named ``"0"``, ``"1"``, ... in the state dict,
    as in the JAX package (``:141``)."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._modules)), sublayer)
        return self

    def insert(self, index, sublayer):
        layers = list(self._modules.values())
        layers.insert(index, sublayer)
        self._modules.clear()
        for i, layer in enumerate(layers):
            self.add_sublayer(str(i), layer)

    def extend(self, sublayers):
        for layer in sublayers:
            self.append(layer)
        return self

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())
