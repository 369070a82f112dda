"""Attention functionals (``paddle_tpu/nn/functional/attention.py``).

Layout is the JAX package's: ``[batch, seq, num_heads, head_dim]``.
``scaled_dot_product_attention`` routes CUDA tensors of the shapes the
JAX package sends to its flash kernel (``attention.py:55-132``) to the
port's flash-attention kernels, whose backward is a kernel too; every
other call, every call with active dropout and every call on the CPU
takes the plain reference in torch ops (``matmul`` and ``softmax``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch.core import state as _state
from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention

__all__ = ["scaled_dot_product_attention", "rotary_freqs",
           "apply_rotary_emb"]

_NEG = -1e30


def _sdpa_reference(q, k, v, attn_mask=None, is_causal=False, scale=None,
                    dropout_p=0.0):
    """Dense attention with fp32 scores and softmax; probabilities are
    cast to q's dtype before the product with v, as in the JAX
    reference (``attention.py:20-52``).  GQA repeats the kv heads.  A
    mask lying elsewhere is moved to the scores' device.  With
    ``dropout_p > 0`` the probabilities are dropped (and the kept ones
    scaled by ``1 / (1 - p)``) with a mask from q's device generator."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [b, h, s, d]
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if is_causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        causal = torch.ones((sq, sk), dtype=torch.bool,
                            device=scores.device).tril(sk - sq)
        scores = torch.where(causal, scores, _NEG)
    if attn_mask is not None:
        attn_mask = attn_mask.to(scores.device)
        if attn_mask.dtype == torch.bool:
            scores = torch.where(attn_mask, scores, _NEG)
        else:
            scores = scores + attn_mask.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, device=probs.device,
                          generator=_state.generator(probs.device)) \
            < (1.0 - dropout_p)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device)).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def _flash_eligible(query, head_dim):
    """``_use_pallas`` on the card: a CUDA tensor, lane-aligned head_dim
    and a block-aligned sequence (seq >= 128, seq % 128 == 0)."""
    s = query.shape[1]
    return query.device.type == "cuda" and head_dim % 128 == 0 and \
        s >= 128 and s % 128 == 0


@eager_op
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """``softmax(q k^T * scale + mask) v`` over ``[b, s, h, d]`` inputs;
    a boolean mask keeps True positions, a float mask is added; with
    ``training`` and ``dropout_p > 0`` the probabilities are dropped.

    With no mask, no active dropout, ``sq == sk`` and an eligible shape a
    CUDA tensor goes through flash attention (heads a multiple of kv
    heads, KV never repeated); active dropout takes the plain path, as in
    the JAX package (``attention.py:77, 96``).  head_dim 32 or 64 at seq
    >= 1024 is zero-padded to 128 and sliced back (exact: the pad adds
    nothing to q k^T or p v, and the scale keeps the true head_dim)."""
    use_dropout = dropout_p > 0.0 and training
    hd = query.shape[-1]
    same = attn_mask is None and not use_dropout and \
        query.shape[1] == key.shape[1]
    if same and hd in (32, 64) and query.shape[1] >= 1024 and \
            _flash_eligible(query, 128):
        pad = (0, 128 - hd)
        qp, kp, vp = (torch.nn.functional.pad(t, pad)
                      for t in (query, key, value))
        out = flash_attention(qp, kp, vp, causal=is_causal,
                              scale=scale if scale is not None
                              else hd ** -0.5)
        return out[..., :hd]
    if same and _flash_eligible(query, hd):
        # no try/except: a failed build or launch surfaces
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale)
    return _sdpa_reference(query, key, value, attn_mask, is_causal, scale,
                           dropout_p if use_dropout else 0.0)


def rotary_freqs(head_dim, max_position, base=10000.0, device="cpu"):
    """RoPE cos/sin tables, each ``[max_position, head_dim // 2]`` fp32."""
    inv = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                       device=device) / head_dim))
    t = torch.arange(max_position, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


@eager_op
def apply_rotary_emb(x, cos, sin, position_offset=0):
    """Rotary embedding, Llama/NeoX half-rotation, computed in fp32 and
    cast back.

    x: ``[batch, seq, heads, head_dim]``; cos/sin: tables from
    :func:`rotary_freqs`.  ``position_offset`` is an int, a 0-d integer
    tensor (one offset for every row) or a ``[B]`` integer tensor of
    per-row offsets (continuous batching).  An int, or a tensor on the
    host, is checked against the table and raises outside it (the JAX
    package clamps tensor offsets silently, ``attention.py:246``).  A
    tensor on the card is taken as it is: reading it would sync the
    host and break a CUDA graph's capture, so the callers check the
    bound on the host (the serving engine before each decode,
    ``generate`` once a call).

    A ``[B, seq]`` integer tensor gives every token's position (the
    serving engine's fixed-width prefill chunk, whose pad tokens may
    run past the table); those are clamped into the table on any
    device, as the JAX package's gather clamps them, and the caller
    checks the real positions on the host."""
    seq = x.shape[1]
    table = cos.shape[0]
    if torch.is_tensor(position_offset) and position_offset.ndim == 2:
        pos = position_offset.to(device=cos.device, dtype=torch.long) \
            .clamp(0, table - 1)
        c = cos[pos][:, :, None, :]                         # [B, s, 1, h]
        s = sin[pos][:, :, None, :]
    elif torch.is_tensor(position_offset):
        if position_offset.ndim not in (0, 1):
            raise ValueError(f"position_offset must be an int, a 0-d, a "
                             f"[B] or a [B, s] tensor, got "
                             f"{position_offset.ndim}-d")
        if position_offset.device.type == "cpu":
            lo = int(position_offset.min())
            hi = int(position_offset.max()) + seq
            if lo < 0 or hi > table:
                raise ValueError(
                    f"RoPE table overflow: positions [{lo}, {hi}) exceed "
                    f"table length {table} (max_position_embeddings)")
        off = position_offset.to(device=cos.device, dtype=torch.long)
        steps = torch.arange(seq, device=cos.device)
        if off.ndim == 1:
            pos = off[:, None] + steps[None]                # [B, s]
            c = cos[pos][:, :, None, :]                     # [B, s, 1, h]
            s = sin[pos][:, :, None, :]
        else:
            pos = off + steps                               # [s]
            c = cos[pos][None, :, None, :]
            s = sin[pos][None, :, None, :]
    else:
        off = int(position_offset)
        if off < 0 or off + seq > table:
            raise ValueError(
                f"RoPE table overflow: positions [{off}, {off + seq}) "
                f"exceed table length {table} (max_position_embeddings)")
        c = cos[off:off + seq][None, :, None, :]
        s = sin[off:off + seq][None, :, None, :]
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
