"""Transformer layers (``paddle_tpu/nn/transformer.py``):
MultiHeadAttention, TransformerEncoder/Decoder and Transformer.

Layer names, child names (``LayerList``'s ``"0"``, ``"1"``, ...) and the
``[in, out]`` weight layout are the JAX package's, so a state dict moves
across as numpy arrays.  Attention goes through
``F.scaled_dot_product_attention`` over ``[batch, seq, heads,
head_dim]``.  The feed-forward goes through ``F.fused_ffn`` where JAX
routes it to its fused kernel (a relu/gelu/silu activation, and eval mode
or dropout p == 0): on the card the CUDA kernel at every row count, on
the CPU its plain version.  The port routes there always, not behind
``PADDLE_TPU_FUSED_BLOCK``, wherever d_model and dim_feedforward are
multiples of 64 (the kernel's tile).

Each class takes ``dtype`` (the parameters', float32 by default as in
the JAX package) and ``device`` (``cuda`` unless the caller passes
another)."""

from __future__ import annotations

import copy

import torch

from paddle_tpu_torch.core.state import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common_layers import Dropout, LayerList, Linear
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import LayerNorm
from paddle_tpu_torch.ops.kernels.fused_block import (SUPPORTED_ACTS,
                                                      record_path)

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]


def _ffn_forward(layer, x, act_name, dropout_layer):
    """linear1 -> act -> dropout -> linear2, through ``F.fused_ffn``
    when the activation is one the kernel has, dropout is inactive
    (``not training or p == 0``) and the widths fit the kernel's tile
    (``transformer.py:25-47``); the reference chain otherwise."""
    d = x.shape[-1]
    f = layer.linear1.weight.shape[-1]
    fused = act_name in SUPPORTED_ACTS and \
        (not layer.training or dropout_layer.p == 0) and \
        d % 64 == 0 and f % 64 == 0
    record_path("ffn", fused and x.device.type == "cuda")
    if fused:
        return F.fused_ffn(x, layer.linear1.weight, layer.linear2.weight,
                           layer.linear1.bias, layer.linear2.bias,
                           activation=act_name)
    return layer.linear2(dropout_layer(layer._act(layer.linear1(x))))


class MultiHeadAttention(Layer):
    Cache = tuple

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, dtype="float32", device=None):
        device = resolve_device(device)
        super().__init__(dtype=dtype, device=device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        kw = dict(weight_attr=weight_attr, bias_attr=bias_attr, dtype=dtype,
                  device=device)
        self.q_proj = Linear(embed_dim, embed_dim, **kw)
        self.k_proj = Linear(kdim, embed_dim, **kw)
        self.v_proj = Linear(vdim, embed_dim, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, **kw)

    def _split(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """Attention of `query` over `key`/`value` (both `query` when not
        given); a bool mask keeps True positions, a float mask is added.
        With a ``(k, v)`` cache the new keys and values are appended to
        it along the sequence and ``(out, (k, v))`` is returned."""
        key = query if key is None else key
        value = key if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        if cache is not None:
            pk, pv = cache
            k = torch.cat([pk, k], dim=1)
            v = torch.cat([pv, v], dim=1)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        if cache is not None:
            return out, (k, v)
        return out

    def gen_cache(self, key, value=None, type=None):
        """An empty ``(k, v)`` cache, ``[b, 0, heads, head_dim]`` each."""
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        kw = dict(dtype=self.q_proj.weight.dtype, device=self._device)
        return (torch.zeros(shape, **kw), torch.zeros(shape, **kw))


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 dtype="float32", device=None):
        device = resolve_device(device)
        super().__init__(dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout if attn_dropout is not None
            else dropout, weight_attr=weight_attr, bias_attr=bias_attr,
            **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self._act = getattr(F, activation)
        self._act_name = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        x = self.norm1(src) if self.normalize_before else src
        if cache is not None:
            x, cache = self.self_attn(x, x, x, attn_mask=src_mask,
                                      cache=cache)
        else:
            x = self.self_attn(x, x, x, attn_mask=src_mask)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = _ffn_forward(self, y, self._act_name, self.dropout2)
        y = residual + self.dropout(y)
        if not self.normalize_before:
            y = self.norm2(y)
        return (y, cache) if cache is not None else y


class TransformerEncoder(Layer):
    """`num_layers` copies of `encoder_layer` (the first is the layer
    itself) in a ``LayerList``, then `norm` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__(dtype=encoder_layer._dtype,
                         device=encoder_layer._device)
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 dtype="float32", device=None):
        device = resolve_device(device)
        super().__init__(dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        self.normalize_before = normalize_before
        ad = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, ad,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, ad,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(
            act_dropout if act_dropout is not None else dropout)
        self._act = getattr(F, activation)
        self._act_name = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        if cache is not None:
            raise NotImplementedError(
                "TransformerDecoderLayer takes no cache, as in the JAX "
                "package; MultiHeadAttention does")
        residual = tgt
        x = self.norm1(tgt) if self.normalize_before else tgt
        x = self.self_attn(x, x, x, attn_mask=tgt_mask)
        x = residual + self.dropout1(x)
        if not self.normalize_before:
            x = self.norm1(x)
        residual = x
        y = self.norm2(x) if self.normalize_before else x
        y = self.cross_attn(y, memory, memory, attn_mask=memory_mask)
        y = residual + self.dropout2(y)
        if not self.normalize_before:
            y = self.norm2(y)
        residual = y
        z = self.norm3(y) if self.normalize_before else y
        z = _ffn_forward(self, z, self._act_name, self.dropout3)
        z = residual + self.dropout(z)
        if not self.normalize_before:
            z = self.norm3(z)
        return z


class TransformerDecoder(Layer):
    """`num_layers` copies of `decoder_layer` (the first is the layer
    itself) in a ``LayerList``, then `norm` if given."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__(dtype=decoder_layer._dtype,
                         device=decoder_layer._device)
        self.layers = LayerList(
            [decoder_layer if i == 0 else copy.deepcopy(decoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(Layer):
    """The encoder-decoder of Vaswani et al. (2017); the defaults are
    its "base" model: d_model 512, 8 heads, 6 + 6 layers, FFN 2048, relu,
    post-LN."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, dtype="float32",
                 device=None):
        device = resolve_device(device)
        super().__init__(dtype=dtype, device=device)
        kw = dict(dtype=dtype, device=device)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **kw), num_encoder_layers,
                norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, **kw) if normalize_before else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **kw), num_decoder_layers,
                norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` float32: 0 on and below the diagonal,
        -inf above it (a CPU tensor unless `device` is given; attention
        moves a mask to its scores' device)."""
        m = torch.full((length, length), float("-inf"), device=device)
        return torch.triu(m, diagonal=1)
