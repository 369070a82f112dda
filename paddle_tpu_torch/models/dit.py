"""DiT — Diffusion Transformer (``paddle_tpu/models/dit.py``).

The DiT-XL/2 architecture (Peebles & Xie): patchify -> N blocks of
[adaLN-Zero modulated self-attention + MLP] conditioned on (timestep,
class) embeddings -> linear unpatchify predicting noise (and, with
``learn_sigma``, sigma).  Same config fields, layer names and ``[in,
out]`` weights as the JAX package: patchify is a reshape and one matrix
product, the timestep embedding is fp32, the 2-D sin-cos positions are a
fixed, non-persistable buffer.

Attention is ``F.scaled_dot_product_attention``; DiT-XL/2's head_dim 72
is one the flash kernels do not take (the JAX package's gate refuses it
too), so it runs the plain attention on every device, and the model
launches no kernel.  ``partition_specs`` / ``spec_for`` wait in
``ROADMAP.md``, queue 1, item 8."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from paddle_tpu_torch.core.state import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.common_layers import Embedding, Linear
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.nn.norm_layers import LayerNorm

__all__ = ["DiTConfig", "DiTBlock", "DiT", "TimestepEmbedder",
           "LabelEmbedder", "timestep_embedding"]


@dataclasses.dataclass
class DiTConfig:
    input_size: int = 32          # latent H=W
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True
    dtype: str = "float32"

    @property
    def num_patches(self):
        return (self.input_size // self.patch_size) ** 2

    @staticmethod
    def dit_xl_2():
        return DiTConfig(depth=28, hidden_size=1152, num_heads=16,
                         patch_size=2)

    @staticmethod
    def tiny(**over):
        cfg = dict(input_size=8, patch_size=2, in_channels=4,
                   hidden_size=64, depth=2, num_heads=4, num_classes=10)
        cfg.update(over)
        return DiTConfig(**cfg)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding in fp32 (``[N]`` -> ``[N, dim]``)."""
    t = torch.as_tensor(t).float()
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedder(Layer):
    def __init__(self, hidden_size: int, freq_dim: int = 256, device=None):
        super().__init__(device=device)
        self.freq_dim = freq_dim
        self.fc1 = Linear(freq_dim, hidden_size, device=device)
        self.fc2 = Linear(hidden_size, hidden_size, device=device)

    def forward(self, t):
        emb = timestep_embedding(t, self.freq_dim)
        return self.fc2(F.silu(self.fc1(emb)))


class LabelEmbedder(Layer):
    """Class embedding with a null class for classifier-free guidance."""

    def __init__(self, num_classes: int, hidden_size: int, device=None):
        super().__init__(device=device)
        self.table = Embedding(num_classes + 1, hidden_size, device=device)
        self.num_classes = num_classes

    def forward(self, labels):
        return self.table(labels)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _zero_(layer):
    with torch.no_grad():
        layer.weight.zero_()
        layer.bias.zero_()


class DiTBlock(Layer):
    """adaLN-Zero block: modulation params regressed from conditioning; the
    per-branch gates initialise to zero so each block starts as identity."""

    def __init__(self, config: DiTConfig, device=None):
        super().__init__(dtype=config.dtype, device=device)
        c = config
        kw = dict(dtype=c.dtype, device=device)
        self.num_heads = c.num_heads
        self.head_dim = c.hidden_size // c.num_heads
        self.norm1 = LayerNorm(c.hidden_size, epsilon=1e-6,
                               weight_attr=False, bias_attr=False, **kw)
        self.qkv = Linear(c.hidden_size, 3 * c.hidden_size, **kw)
        self.proj = Linear(c.hidden_size, c.hidden_size, **kw)
        self.norm2 = LayerNorm(c.hidden_size, epsilon=1e-6,
                               weight_attr=False, bias_attr=False, **kw)
        hidden = int(c.hidden_size * c.mlp_ratio)
        self.fc1 = Linear(c.hidden_size, hidden, **kw)
        self.fc2 = Linear(hidden, c.hidden_size, **kw)
        # adaLN-zero modulation: 6 params per block, zero-init
        self.adaLN = Linear(c.hidden_size, 6 * c.hidden_size, **kw)
        _zero_(self.adaLN)

    def forward(self, x, cond):
        b, s = x.shape[0], x.shape[1]
        mod = self.adaLN(F.silu(cond))
        sh1, sc1, g1, sh2, sc2, g2 = mod.reshape(b, 6, -1).unbind(dim=1)
        h = _modulate(self.norm1(x), sh1, sc1)
        qkv = self.qkv(h).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        att = F.scaled_dot_product_attention(q, k, v, is_causal=False)
        att = self.proj(att.reshape(b, s, self.num_heads * self.head_dim))
        x = x + g1[:, None, :] * att
        h2 = _modulate(self.norm2(x), sh2, sc2)
        h2 = self.fc2(F.gelu(self.fc1(h2)))
        return x + g2[:, None, :] * h2


class DiT(Layer):
    """Entry point: parameters on ``device`` (``cuda`` unless the caller
    asks for the CPU)."""

    def __init__(self, config: DiTConfig, device=None):
        device = resolve_device(device)
        super().__init__(dtype=config.dtype, device=device)
        self.config = config
        c = config
        p = c.patch_size
        kw = dict(dtype=c.dtype, device=device)
        self.patch_dim = p * p * c.in_channels
        self.x_embed = Linear(self.patch_dim, c.hidden_size, **kw)
        self.t_embed = TimestepEmbedder(c.hidden_size, device=device)
        self.y_embed = LabelEmbedder(c.num_classes, c.hidden_size,
                                     device=device)
        self.register_buffer(
            "pos_embed",
            torch.from_numpy(_sincos_2d(c.hidden_size, c.input_size // p)
                             ).to(device),
            persistable=False)
        self.blocks = []
        for i in range(c.depth):
            blk = DiTBlock(c, device=device)
            self.add_sublayer(f"blocks_{i}", blk)
            self.blocks.append(blk)
        self.norm_f = LayerNorm(c.hidden_size, epsilon=1e-6,
                                weight_attr=False, bias_attr=False, **kw)
        out_ch = c.in_channels * (2 if c.learn_sigma else 1)
        self.final = Linear(c.hidden_size, p * p * out_ch, **kw)
        _zero_(self.final)

    @property
    def device(self) -> torch.device:
        return self._device

    # -- patch ops (reshape + matmul; NCHW in, paddle convention) ----------
    def patchify(self, x):
        p = self.config.patch_size
        b, ch, hh, _ = x.shape
        g = hh // p
        x = x.reshape(b, ch, g, p, g, p).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(b, g * g, p * p * ch)      # B, g*g, (p, p, C)

    def unpatchify(self, tokens, out_ch):
        p = self.config.patch_size
        b, n, _ = tokens.shape
        g = int(math.isqrt(n))
        t = tokens.reshape(b, g, g, p, p, out_ch).permute(0, 5, 1, 3, 2, 4)
        return t.reshape(b, out_ch, g * p, g * p)   # B, C, g*p, g*p

    def forward(self, x, t, y):
        """x: [B, C, H, W] noisy latents; t: [B] timesteps; y: [B]
        labels."""
        tokens = self.patchify(x) @ self.x_embed.weight + self.x_embed.bias
        tokens = tokens + self.pos_embed[None]
        cond = self.t_embed(t) + self.y_embed(y)
        h = tokens
        for blk in self.blocks:
            h = blk(h, cond)
        out_tokens = self.final(self.norm_f(h))
        out_ch = self.config.in_channels * (2 if self.config.learn_sigma
                                            else 1)
        return self.unpatchify(out_tokens, out_ch)

    def loss(self, x, t, y, noise_target):
        """Simple eps-prediction MSE (first in_channels of the output)."""
        eps = self(x, t, y)[:, :self.config.in_channels]
        return torch.mean((eps - noise_target) ** 2)

    @staticmethod
    def partition_specs(config, dp_axis="dp", tp_axis="tp", fsdp_axis=None):
        raise NotImplementedError(
            "DiT.partition_specs (meshes and sharded placement) is not "
            "ported yet (ROADMAP.md, queue 1, item 8)")

    @staticmethod
    def spec_for(name, rules):
        raise NotImplementedError(
            "DiT.spec_for (meshes and sharded placement) is not ported "
            "yet (ROADMAP.md, queue 1, item 8)")


def _sincos_2d(dim: int, grid: int):
    """2D sin-cos positional embedding [grid*grid, dim] (DiT uses fixed)."""
    half = dim // 2

    def one_dim(pos, d):
        omega = np.arange(d // 2, dtype=np.float64) / (d / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    coords = np.arange(grid, dtype=np.float64)
    gy, gx = np.meshgrid(coords, coords, indexing="ij")
    emb = np.concatenate([one_dim(gy.reshape(-1), half),
                          one_dim(gx.reshape(-1), half)], axis=1)
    return emb.astype(np.float32)
