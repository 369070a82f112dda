"""Generation helpers (``paddle_tpu/generation/__init__.py``): the
sampling config, the mask guard of the cached forward signatures, and
the sampler.  ``generate`` and ``StaticCache`` wait for the
slot-contiguous serving path of a later slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["GenerationConfig", "reject_scalar_mask"]

_NEG = -1e30


def reject_scalar_mask(attn_mask):
    """Guard shared by the cached-decode forward signatures: a scalar
    attn_mask means the caller passed position_offset positionally where
    attn_mask sits.  Returns the mask (or None)."""
    if isinstance(attn_mask, (int, float)) or (
            torch.is_tensor(attn_mask) and attn_mask.ndim == 0):
        raise TypeError(
            "attn_mask got a scalar — position_offset must be passed by "
            "keyword (the forward signature gained attn_mask before it)")
    return attn_mask


@dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0


def _sample(logits, cfg: GenerationConfig,
            generator: Optional[torch.Generator] = None):
    """``[B, vocab]`` -> ``[B]`` next tokens: argmax, or a draw under
    temperature / top-k / nucleus from `generator`.  Torch's generator
    cannot reproduce JAX's random bits, so only the greedy path is held
    to the JAX package token for token."""
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(cfg.temperature, 1e-6)
    if cfg.top_k and cfg.top_k > 0:
        k = min(cfg.top_k, logits.shape[-1])   # top_k may exceed vocab
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = torch.where(logits < kth, _NEG, logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest prefix with mass >= top_p stays; its cutoff logit
        cutoff_idx = torch.sum(cum < cfg.top_p, dim=-1, keepdim=True) \
            .clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, _NEG, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
