"""Losses (``paddle_tpu/nn/functional/loss.py``): the fused chunked
lm-head + cross-entropy that ``LlamaForCausalLM.loss`` runs, and
``cross_entropy``, whose hard-label case goes through the fused softmax
cross-entropy (``ops/kernels/cross_entropy.py``: the CUDA kernels on the
card, their plain versions on the CPU), as ``GPTForCausalLM.loss`` and
``nn.CrossEntropyLoss`` use it.

The other losses are the JAX package's formulas in torch ops, each on the
op hook as there (``:115-337``, ``:472-595``); none reaches a kernel
(``softmax_with_cross_entropy`` stays plain, as in JAX).  Labels,
weights and other non-input operands may be numpy or tensors on another
device: they are moved to the input's device.  ``max(a, 0)`` is
``torch.maximum``, which splits a tie's gradient in halves as
``jnp.maximum`` does.  ``ctc_loss`` is JAX's log-space alpha recursion
(-1e30 for -inf, so an infeasible alignment costs ~1e30, never inf), a
Python loop over time; ``norm_by_times`` is accepted and changes nothing,
as there.  An unknown ``reduction`` raises (JAX returns the unreduced
loss)."""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.dispatch import eager_op
from paddle_tpu_torch import flags
from paddle_tpu_torch.ops.kernels.cross_entropy import (
    fused_softmax_cross_entropy)

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "l1_loss", "smooth_l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "ctc_loss",
           "sigmoid_focal_loss", "square_error_cost",
           "fused_linear_cross_entropy", "huber_loss", "poisson_nll_loss",
           "gaussian_nll_loss", "multi_margin_loss", "log_loss",
           "dice_loss", "npair_loss", "pairwise_distance",
           "margin_cross_entropy"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be 'mean', 'sum' or 'none', got "
                     f"{reduction!r}")


def _on(x, ref):
    """`x` (a tensor, numpy array or number) as a tensor on `ref`'s
    device (its own dtype)."""
    if torch.is_tensor(x):
        return x.to(ref.device)
    return torch.as_tensor(x, device=ref.device)


def _max0(x, c=0.0):
    """``jnp.maximum(x, c)`` for a number `c`: a tie's gradient halved."""
    return torch.maximum(x, torch.as_tensor(c, dtype=x.dtype,
                                            device=x.device))


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


@eager_op
def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               axis=-1):
    """The plain fp32 softmax cross-entropy (``:115-136``): the loss keeps
    the class axis as size 1 at the end; an ``ignore_index`` label costs
    0.  With ``return_softmax`` also the fp32 softmax."""
    x = logits.float()
    ax = axis % x.ndim
    logp = torch.log_softmax(x, dim=ax)
    label = _on(label, x)
    if soft_label:
        loss = -(label.float() * logp).sum(dim=ax, keepdim=True)
    else:
        lbl = label
        if lbl.ndim == x.ndim and lbl.shape[ax] == 1:
            lbl = lbl.squeeze(ax)
        lbl = lbl.long()
        valid = lbl != ignore_index
        safe = torch.where(valid, lbl, 0)
        picked = torch.gather(logp, ax, safe.unsqueeze(ax)).squeeze(ax)
        loss = torch.where(valid, -picked, 0.0)[..., None]
    if return_softmax:
        return loss, torch.softmax(x, dim=ax)
    return loss


@eager_op
def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - _on(label, input)), reduction)


@eager_op
def l1_loss(input, label, reduction="mean"):
    return _reduce(torch.abs(input - _on(label, input)), reduction)


@eager_op
def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = input - _on(label, input)
    ad = torch.abs(d)
    loss = torch.where(ad < delta, 0.5 * d * d / delta, ad - 0.5 * delta)
    return _reduce(loss, reduction)


@eager_op
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """Negative log likelihood of log-probabilities ``[N, C, ...]``
    against labels ``[N, ...]``; a weighted mean divides by the valid
    labels' weights."""
    label = _on(label, input).long()
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        w = _on(weight, input)[safe]
        loss = torch.where(valid, loss * w, 0.0)
        if reduction == "mean":
            return loss.sum() / torch.where(valid, w, 0.0).sum()
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    return _reduce(loss, reduction)


@eager_op
def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    x = torch.clamp(input.float(), 1e-12, 1 - 1e-12)
    label = _on(label, input)
    loss = -(label * torch.log(x) + (1 - label) * torch.log1p(-x))
    if weight is not None:
        loss = loss * _on(weight, input)
    return _reduce(loss, reduction)


@eager_op
def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    x = logit.float()
    label = _on(label, logit)
    neg_abs = -torch.abs(x)
    if pos_weight is not None:
        log_w = (_on(pos_weight, logit) - 1) * label + 1
        loss = (1 - label) * x + log_w * (torch.log1p(torch.exp(neg_abs)) +
                                          _max0(-x))
    else:
        loss = _max0(x) - x * label + torch.log1p(torch.exp(neg_abs))
    if weight is not None:
        loss = loss * _on(weight, logit)
    return _reduce(loss, reduction)


@eager_op
def kl_div(input, label, reduction="mean", log_target=False):
    label = _on(label, input)
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(_max0(label, 1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


@eager_op
def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    loss = _max0(-_on(label, input) * (input - _on(other, input)) + margin)
    return _reduce(loss, reduction)


@eager_op
def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    loss = torch.where(_on(label, input) == 1, input, _max0(margin - input))
    return _reduce(loss, reduction)


@eager_op
def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    input2 = _on(input2, input1)
    norms = torch.linalg.vector_norm(input1, dim=-1) * \
        torch.linalg.vector_norm(input2, dim=-1)
    cos = (input1 * input2).sum(dim=-1) / _max0(norms, 1e-12)
    loss = torch.where(_on(label, input1) == 1, 1 - cos,
                       _max0(cos - margin))
    return _reduce(loss, reduction)


@eager_op
def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    """``max(d(a, p) - d(a, n) + margin, 0)`` with ``d(a, b) = (sum |a -
    b|^p + epsilon)^(1/p)``, epsilon added to every element's power as
    in JAX's ``:226-236``."""
    positive, negative = _on(positive, input), _on(negative, input)

    def dist(a, b):
        return (torch.abs(a - b) ** p + epsilon).sum(dim=-1) ** (1.0 / p)
    dp = dist(input, positive)
    dn = dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(_max0(dp - dn + margin), reduction)


def _logaddexp_floor(terms, neg_inf):
    """``log(sum(exp(terms)))`` of JAX's recursion (``:283-297``): a state
    with no live term (max <= -1e29) stays at the -1e30 sentinel, and the
    sum is floored at 1e-30 so the log's gradient stays finite."""
    m = terms[0]
    for t in terms[1:]:
        m = torch.maximum(m, t)
    m_safe = _max0(m, -1e29)
    sum_exp = sum(torch.exp(t - m_safe) for t in terms)
    return torch.where(m <= -1e29, neg_inf,
                       m_safe + torch.log(_max0(sum_exp, 1e-30)))


@eager_op
def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of ``log_probs`` ``[T, B, C]`` against padded ``labels``
    ``[B, L]`` (``:239-320``): the alpha recursion over the extended
    label sequence ``[B, 2L + 1]`` in fp32 log space.  ``mean`` divides
    each sequence's loss by its label length (at least 1) first."""
    T, B, C = log_probs.shape
    dev = log_probs.device
    labels = _on(labels, log_probs).long()
    L = labels.shape[1]
    S = 2 * L + 1
    lp = log_probs.float()
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    neg_inf = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    prev2 = torch.nn.functional.pad(ext[:, :-2], (2, 0), value=-1)
    allow_skip = (ext != blank) & (ext != prev2)

    # t = 0: the first blank and the first label; every other state dead
    alpha = torch.gather(lp[0], 1, ext[:, :min(S, 2)])
    if S > 2:
        alpha = torch.cat([alpha, neg_inf.expand(B, S - 2)], dim=1)
    alphas = [alpha]
    for t in range(1, T):
        a1 = torch.nn.functional.pad(alpha[:, :-1], (1, 0), value=-1e30)
        a2 = torch.nn.functional.pad(alpha[:, :-2], (2, 0), value=-1e30)
        a2 = torch.where(allow_skip, a2, neg_inf)
        tot = _logaddexp_floor((alpha, a1, a2), neg_inf)
        alpha = tot + torch.gather(lp[t], 1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas)                              # [T, B, S]
    input_lengths = _on(input_lengths, log_probs).long()
    label_lengths = _on(label_lengths, log_probs).long()
    t_idx = torch.clamp(input_lengths - 1, 0, T - 1)
    per_b = alphas[t_idx, torch.arange(B, device=dev)]        # [B, S]
    s1 = torch.clamp(2 * label_lengths, 0, S - 1)
    s2 = torch.clamp(2 * label_lengths - 1, 0, S - 1)
    a1 = torch.gather(per_b, 1, s1[:, None])[:, 0]
    a2 = torch.gather(per_b, 1, s2[:, None])[:, 0]
    loss = -_logaddexp_floor((a1, a2), neg_inf)
    if reduction == "mean":
        return (loss / label_lengths.clamp(min=1)).mean()
    return _reduce(loss, reduction)


@eager_op
def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    label = _on(label, logit)
    p = torch.sigmoid(logit.float())
    ce = _max0(logit) - logit * label + torch.log1p(
        torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / _on(normalizer, logit)
    return _reduce(loss, reduction)


@eager_op
def square_error_cost(input, label):
    return torch.square(input - _on(label, input))


@eager_op
def huber_loss(input, label, delta=1.0, reduction="mean"):
    """Quadratic inside ``|d| <= delta``, linear outside (``:472-481``)."""
    d = input - _on(label, input)
    ad = torch.abs(d)
    loss = torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))
    return _reduce(loss, reduction)


@eager_op
def poisson_nll_loss(input, label, log_input=True, full=False,
                     epsilon=1e-8, reduction="mean"):
    label = _on(label, input)
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        stirling = label * torch.log(label) - label + \
            0.5 * torch.log(2.0 * math.pi * label)
        loss = loss + torch.where(label > 1, stirling, 0.0)
    return _reduce(loss, reduction)


@eager_op
def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    var = _max0(_on(variance, input), epsilon)
    loss = 0.5 * (torch.log(var) + torch.square(input - _on(label, input))
                  / var)
    if full:
        loss = loss + 0.5 * math.log(2.0 * math.pi)
    return _reduce(loss, reduction)


@eager_op
def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    """``sum_{j != y} max(0, margin - x_y + x_j)^p / C`` (``:518-530``)."""
    n, c = input.shape
    label = _on(label, input).long()
    x_y = torch.gather(input, 1, label[:, None])
    viol = _max0(margin - x_y + input) ** p
    if weight is not None:
        viol = viol * _on(weight, input)[label][:, None]
    mask = torch.arange(c, device=input.device)[None, :] != label[:, None]
    loss = torch.where(mask, viol, 0.0).sum(dim=1) / c
    return _reduce(loss, reduction)


@eager_op
def log_loss(input, label, epsilon=1e-4):
    label = _on(label, input)
    return -label * torch.log(input + epsilon) \
        - (1.0 - label) * torch.log(1.0 - input + epsilon)


@eager_op
def dice_loss(input, label, epsilon=1e-5):
    """Dice loss of probabilities ``[N, ..., C]`` against labels ``[N,
    ..., 1]``, the mean over the batch."""
    lbl = _on(label, input).long().squeeze(-1)
    onehot = torch.nn.functional.one_hot(lbl, input.shape[-1]).to(
        input.dtype)
    axes = tuple(range(1, input.ndim))
    inter = (input * onehot).sum(dim=axes)
    union = input.sum(dim=axes) + onehot.sum(dim=axes)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


@eager_op
def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Cross-entropy over ``anchor @ positive.T`` against the label
    matches, plus ``l2_reg / 4`` times the embeddings' mean squared
    norms (``:554-568``)."""
    positive = _on(positive, anchor)
    labels = _on(labels, anchor)
    sim = anchor @ positive.T
    logp = torch.log_softmax(sim, dim=1)
    w = (labels[:, None] == labels[None, :]).to(sim.dtype)
    w = w / w.sum(dim=1, keepdim=True)
    ce = -(w * logp).sum(dim=1).mean()
    reg = l2_reg * 0.25 * (torch.square(anchor).sum(dim=1).mean()
                           + torch.square(positive).sum(dim=1).mean())
    return ce + reg


@eager_op
def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False):
    """The p-norm of ``x - y + epsilon`` along the last axis (epsilon on
    the signed difference, ``:571-582``); ``p = ±inf`` the max / min."""
    d = torch.abs((x - _on(y, x)) + epsilon)
    if isinstance(p, (int, float)) and math.isinf(p):
        out = d.amax(dim=-1) if p > 0 else d.amin(dim=-1)
    else:
        out = (d ** p).sum(dim=-1) ** (1.0 / p)
    return out[..., None] if keepdim else out


@eager_op
def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, return_softmax=False,
                         reduction="mean"):
    """ArcFace-style margin softmax (``:585-595``): the target class's
    cosine becomes ``cos(margin1 * theta + margin2) - margin3``, all
    scaled by `scale`, then softmax cross-entropy."""
    onehot = torch.nn.functional.one_hot(
        _on(label, logits).long(), logits.shape[-1]).to(logits.dtype)
    cos = torch.clamp(logits, -1.0, 1.0)
    target = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    adjusted = torch.where(onehot > 0, target, cos) * scale
    logp = torch.log_softmax(adjusted, dim=-1)
    loss = _reduce(-(onehot * logp).sum(dim=-1), reduction)
    if return_softmax:
        return loss, torch.softmax(adjusted, dim=-1)
    return loss
