"""Fused softmax cross-entropy — wrappers of the CUDA kernels in
``csrc/cross_entropy.cu`` and their plain PyTorch versions.

Counterparts of ``paddle_tpu/ops/pallas/cross_entropy.py``:
``cross_entropy_fwd`` replaces ``_fwd_kernel`` (per-token loss and
logsumexp from ``[T, V]`` logits, the vocab streamed with an online
max/sum) and ``cross_entropy_bwd`` replaces ``_bwd_kernel`` (``dx =
(softmax(x) - onehot(label)) * g`` in x's dtype).  ``FusedSoftmaxCE`` is
the custom VJP around them (``_ce_core_fwd``/``_ce_core_bwd``): it saves
the logits, the labels and the lse, so neither the fp32 log-softmax nor
the one-hot ever exists at ``[T, V]``.  A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel or raises.

The TPU kernels route only where the vocab tiles the 128-lane VPU
(``fused_ce_eligible``: V a multiple of 128); the CUDA kernels take any
V >= 1 and any row alignment.  Logits may be float32, bfloat16 or
float16; labels are int64 (others are converted).  A label outside
``[0, V)`` matches no column: its loss is the row's lse and its gradient
has no one-hot term, as on the TPU (mask ``ignore_index`` before the
call).  Both versions start the running max at -1e30, as the TPU
kernel's scratch does, so a ``-inf`` logit has probability 0; a row that
is ``-inf`` throughout has lse ``-inf``.

Each wrapper counts its launches in a plain integer attribute
(``cross_entropy_fwd.launches``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build, costs

__all__ = ["cross_entropy_fwd", "cross_entropy_bwd", "ce_fwd_reference",
           "ce_bwd_reference", "FusedSoftmaxCE",
           "fused_softmax_cross_entropy"]

_NEG_INIT = -1e30     # the TPU kernel's _NEG_INF: the online max's start
_CODES = _build.FP16_CODES


# -- plain versions (the CPU path and the kernels' reference) ---------------

def ce_fwd_reference(logits, labels):
    """(loss, lse), each fp32 ``[T]``: the kernel's arithmetic in plain
    ops over the whole row (fp32 softmax statistics, max floored at
    -1e30, the gold logit taken only for a label in ``[0, V)``)."""
    x = logits.float()
    v = x.shape[-1]
    lbl = labels.long()
    m = x.amax(dim=-1).clamp(min=_NEG_INIT)
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=-1))
    hit = (lbl >= 0) & (lbl < v)
    gold = torch.gather(x, -1, lbl.clamp(0, v - 1)[:, None])[:, 0]
    return lse - torch.where(hit, gold, 0.0), lse


def ce_bwd_reference(logits, labels, lse, g):
    """``dx = (exp(x - lse) - onehot(label)) * g`` in fp32, cast to the
    logits' dtype."""
    x = logits.float()
    cols = torch.arange(x.shape[-1], device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dx = (torch.exp(x - lse[:, None]) - onehot) * g.float()[:, None]
    return dx.to(logits.dtype)


# -- wrappers -----------------------------------------------------------------

def _check(what, logits, labels, **rows):
    if logits.ndim != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"{what}: logits {tuple(logits.shape)} and labels "
                         f"{tuple(labels.shape)} must be [T, V] and [T]")
    if logits.dtype not in _CODES:
        raise TypeError(f"{what}: logits dtype {logits.dtype} not supported "
                        "(float32, bfloat16, float16)")
    if logits.shape[1] >= 2 ** 31:
        raise ValueError(f"{what}: V={logits.shape[1]} needs 64-bit columns")
    for name, t in dict(logits=logits, labels=labels, **rows).items():
        if t.device != logits.device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{logits.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def cross_entropy_fwd(logits, labels):
    """(loss, lse), each fp32 ``[T]``, from logits ``[T, V]`` and integer
    labels ``[T]``."""
    if logits.device.type == "cpu":
        return _build.plain("cross_entropy_fwd",
                            lambda: costs.ce_fwd(logits), ce_fwd_reference,
                            logits, labels)
    what = "cross_entropy_fwd"
    labels = labels.to(torch.long)
    _check(what, logits, labels)
    T, V = logits.shape
    loss = torch.empty((T,), dtype=torch.float32, device=logits.device)
    lse = torch.empty((T,), dtype=torch.float32, device=logits.device)
    if T and V:
        lib = _build.library("cross_entropy")
        err = lib.ptt_ce_fwd(_CODES[logits.dtype], logits.data_ptr(),
                             labels.data_ptr(), loss.data_ptr(),
                             lse.data_ptr(), T, V, _build.stream_of(logits))
        _build.check(lib, err, what)
        _build.charge(what, costs.ce_fwd, logits)
        cross_entropy_fwd.launches += 1
    return loss, lse


cross_entropy_fwd.launches = 0


def cross_entropy_bwd(logits, labels, lse, g):
    """``dx`` ``[T, V]`` in the logits' dtype from the saved ``lse`` and
    the per-row fp32 cotangent ``g`` ``[T]``."""
    if logits.device.type == "cpu":
        return _build.plain("cross_entropy_bwd",
                            lambda: costs.ce_bwd(logits), ce_bwd_reference,
                            logits, labels, lse, g)
    what = "cross_entropy_bwd"
    labels = labels.to(torch.long)
    g = g.to(torch.float32)
    for name, t in (("lse", lse), ("g", g)):
        if t.dtype != torch.float32 or t.shape != logits.shape[:1]:
            raise ValueError(f"{what}: {name} must be fp32 [T], got "
                             f"{t.dtype} {tuple(t.shape)}")
    _check(what, logits, labels, lse=lse, g=g)
    T, V = logits.shape
    dx = torch.empty_like(logits)
    if T and V:
        lib = _build.library("cross_entropy")
        err = lib.ptt_ce_bwd(_CODES[logits.dtype], logits.data_ptr(),
                             labels.data_ptr(), lse.data_ptr(),
                             g.data_ptr(), dx.data_ptr(), T, V,
                             _build.stream_of(logits))
        _build.check(lib, err, what)
        _build.charge(what, costs.ce_bwd, logits)
        cross_entropy_bwd.launches += 1
    return dx


cross_entropy_bwd.launches = 0


# -- custom VJP ---------------------------------------------------------------

class FusedSoftmaxCE(torch.autograd.Function):
    """``_ce_core`` (``cross_entropy.py:180-206``): the forward kernel
    saves (logits, labels, lse); the backward kernel takes the per-row
    fp32 cotangent and writes dlogits in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = cross_entropy_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return cross_entropy_bwd(logits, labels, lse,
                                 g.float().contiguous()), None


def fused_softmax_cross_entropy(logits, labels):
    """Per-token ``-log_softmax(logits)[labels]``, fp32 ``[T]``, from
    logits ``[T, V]`` (flatten leading dims first) and labels ``[T]``,
    differentiable in the logits (``cross_entropy.py:226-269``).  Map
    ``ignore_index`` to a safe class before the call and zero those rows'
    loss after it: the zeroed cotangent zeroes their dlogits."""
    return FusedSoftmaxCE.apply(logits.contiguous(), labels.contiguous())
