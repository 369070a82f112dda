"""Losses (``paddle_tpu/nn/functional/loss.py``): the fused chunked
lm-head + cross-entropy that ``LlamaForCausalLM.loss`` runs, and
``cross_entropy``, whose hard-label case goes through the fused softmax
cross-entropy (``ops/kernels/cross_entropy.py``: the CUDA kernels on the
card, their plain versions on the CPU), as ``GPTForCausalLM.loss`` and
``nn.CrossEntropyLoss`` use it."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch import flags
from paddle_tpu_torch.ops.kernels.cross_entropy import (
    fused_softmax_cross_entropy)

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                     f"{reduction!r}")


def _is_int(t):
    return not (t.is_floating_point() or t.is_complex()) and \
        t.dtype != torch.bool


@eager_op
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy of logits against labels along `axis`
    (``loss.py:32-110``).

    Hard integer labels (``[...]`` or ``[..., 1]``) with no class
    `weight`, no `label_smoothing`, ``use_softmax`` and the last axis go
    through the fused softmax cross-entropy: ``ignore_index`` labels are
    mapped to class 0 before it and their loss zeroed after it (so their
    cotangent, and their gradient, is zero), and the mean divides by the
    count of valid labels.  Every other case is the plain fp32 form:
    ``soft_label`` targets (smoothed toward uniform), class weights (a
    weighted mean divides by the sum of the weights), label smoothing,
    ``use_softmax=False`` (the input is taken as probabilities) and any
    axis."""
    ax = axis % input.ndim
    if (use_softmax and not soft_label and weight is None
            and label_smoothing == 0.0 and input.ndim >= 2
            and ax == input.ndim - 1):
        lbl = label
        if lbl.ndim == input.ndim and lbl.shape[-1] == 1:
            lbl = lbl.squeeze(-1)
        if lbl.ndim == input.ndim - 1 and _is_int(lbl):
            v = input.shape[-1]
            lbl = lbl.to(device=input.device, dtype=torch.long)
            valid = lbl != ignore_index
            safe = torch.where(valid, lbl, 0)
            per = fused_softmax_cross_entropy(input.reshape(-1, v),
                                              safe.reshape(-1))
            loss = torch.where(valid, per.reshape(lbl.shape), 0.0)
            if reduction == "mean":
                return loss.sum() / valid.sum().clamp(min=1)
            return _reduce(loss, reduction)
    x = input.float()
    if use_softmax:
        logp = torch.log_softmax(x, dim=ax)
    else:
        logp = torch.log(torch.clamp(x, min=1e-30))
    n_classes = x.shape[ax]

    if soft_label:
        tgt = label.to(device=x.device, dtype=torch.float32)
        if label_smoothing > 0:
            tgt = (1 - label_smoothing) * tgt + label_smoothing / n_classes
        loss = -(tgt * logp).sum(dim=ax)
        if weight is not None:
            w = (tgt * weight.to(x.device)).sum(dim=ax)
            loss = loss * w
            if reduction == "mean":
                return loss.sum() / w.sum().clamp(min=1e-12)
        return _reduce(loss, reduction)

    lbl = label.to(x.device)
    if lbl.ndim == x.ndim and lbl.shape[ax] == 1:
        lbl = lbl.squeeze(ax)
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0:
        smooth = logp.mean(dim=ax)
        picked = (1 - label_smoothing) * picked + label_smoothing * smooth
    loss = -picked
    if weight is not None:
        w = weight.to(x.device)[safe]
        loss = torch.where(valid, loss * w, 0.0)
        if reduction == "mean":
            return loss.sum() / torch.where(valid, w, 0.0).sum().clamp(
                min=1e-12)
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    return _reduce(loss, reduction)


def _chunk(w, ci, chunk_size):
    """Vocab chunk ``ci`` of ``w`` ``[d, V]`` in fp32, zero-padded to
    ``chunk_size`` columns: the JAX package pads the whole vocab axis to a
    chunk multiple (128256 -> 131072); only the last chunk is short, so
    only it is padded here.  Returns (chunk, its live width)."""
    v = w.shape[1]
    base = ci * chunk_size
    live = min(chunk_size, v - base)
    wc = w[:, base:base + live].float()
    if live < chunk_size:
        wc = torch.nn.functional.pad(wc, (0, chunk_size - live))
    return wc, live


def _tf32_products(device) -> bool:
    """Whether the chunk products run TF32: on the card at
    ``FLAGS_default_matmul_precision="default"``, the reference's fp32
    dots at the accelerator's default precision (``loss.py:400``,
    ``:407``); exact fp32 at ``float32``, ``highest`` and
    ``bfloat16_3x`` (cuBLAS has no three-pass bf16; fp32 is at least as
    precise), and on the CPU at every value."""
    mode = flags.get("default_matmul_precision")
    if mode not in flags.MATMUL_PRECISIONS:
        raise ValueError(f"FLAGS_default_matmul_precision={mode!r}; "
                         f"expected one of {flags.MATMUL_PRECISIONS}")
    return device.type == "cuda" and mode == "default"


def _mm(a, b, tf32):
    """``a @ b`` in fp32, through TF32 where `tf32`: the process's TF32
    setting is saved, set for this one product and restored, so nothing
    outside the CE sees it change."""
    if not tf32:
        return a @ b
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class _FusedCE(torch.autograd.Function):
    """``_fused_ce``'s custom VJP (``loss.py:376-462``): the forward
    scans vocab chunks with an fp32 online logsumexp and picks the gold
    logit; the backward recomputes each chunk's probabilities and
    accumulates dh and dW, so the ``[T, V]`` fp32 logits never exist
    whole.  Each chunk's dW is cast to W's dtype as it is written, which
    rounds every element once, as the JAX package's final cast does.  The
    chunk products take the precision of ``_tf32_products``."""

    @staticmethod
    def forward(ctx, h, w, lbl, chunk_size):
        hf = h.float()
        tf32 = _tf32_products(h.device)
        t, v = h.shape[0], w.shape[1]
        n = -(-v // chunk_size)
        cols = torch.arange(chunk_size, device=h.device)
        m = torch.full((t,), -float("inf"), device=h.device)
        s = torch.zeros((t,), device=h.device)
        gold = torch.zeros((t,), device=h.device)
        for ci in range(n):
            wc, _ = _chunk(w, ci, chunk_size)
            logits = _mm(hf, wc, tf32)                         # [T, c]
            base = ci * chunk_size
            valid = (cols + base < v)[None, :]
            logits = torch.where(valid, logits, -float("inf"))
            cm = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - cm) + \
                torch.exp(logits - cm[:, None]).sum(dim=1)
            hit = ((lbl[:, None] - base) == cols[None, :]) & valid
            gold = gold + torch.where(hit, logits, 0.0).sum(dim=1)
            m = cm
        lse = m + torch.log(s)
        ctx.save_for_backward(h, w, lbl, lse)
        ctx.chunk_size = chunk_size
        return lse - gold

    @staticmethod
    def backward(ctx, g):
        h, w, lbl, lse = ctx.saved_tensors
        c = ctx.chunk_size
        hf = h.float()
        tf32 = _tf32_products(h.device)
        gf = g.float()
        v = w.shape[1]
        cols = torch.arange(c, device=h.device)
        dh = torch.zeros_like(hf)
        dw = torch.empty_like(w)
        for ci in range(-(-v // c)):
            wc, live = _chunk(w, ci, c)
            logits = _mm(hf, wc, tf32)
            base = ci * c
            valid = (cols + base < v)[None, :]
            p = torch.where(valid, torch.exp(logits - lse[:, None]), 0.0)
            onehot = (((lbl[:, None] - base) == cols[None, :]) & valid).float()
            delta = (p - onehot) * gf[:, None]                 # [T, c]
            dh = dh + _mm(delta, wc.t(), tf32)
            dw[:, base:base + live] = \
                _mm(hf.t(), delta, tf32)[:, :live].to(w.dtype)
        return dh.to(h.dtype), dw, None, None


@eager_op
def fused_linear_cross_entropy(hidden, weight, labels, chunk_size=8192,
                               reduction="mean", ignore_index=-100):
    """Fused lm-head + softmax cross-entropy over vocab chunks.

    hidden ``[T, d]``; weight ``[d, V]``; labels ``[T]`` integers
    (``ignore_index`` entries contribute neither loss nor gradient: they
    are masked outside the custom VJP, as ``loss.py:361-370`` does).
    Differentiable in hidden and weight; the loss is fp32."""
    lbl = labels.to(device=hidden.device, dtype=torch.long)
    mask = lbl != ignore_index
    safe = torch.where(mask, lbl, 0)
    per_tok = _FusedCE.apply(hidden, weight, safe, int(chunk_size))
    per_tok = torch.where(mask, per_tok, 0.0)
    if reduction == "mean":
        return per_tok.sum() / mask.sum().clamp(min=1)
    return _reduce(per_tok, reduction)
