"""Grouped expert FFN — the wrapper of the CUDA kernel pair in
``csrc/grouped_matmul.cu``, its plain PyTorch version and its custom VJP.

Counterpart of ``paddle_tpu/ops/pallas/grouped_matmul.py``:
``grouped_expert_ffn`` replaces ``_grouped_kernel`` (reached through
``grouped_expert_ffn_pallas``), ``grouped_expert_ffn_reference`` is its
plain version and ``GroupedExpertFFN`` is ``_grouped_core``'s custom VJP,
whose backward is the masked chain of plain products of ``_grouped_bwd``
(the JAX package has no backward kernel here either).

The JAX package routes ``_expert_ffn`` to its kernel only behind
``PADDLE_TPU_GROUPED_MOE``; the port always takes this wrapper, which
launches the kernel for a CUDA tensor and takes the plain version for a
tensor on the CPU.  There is no fallback between the two.  The kernel
takes float32 and bfloat16, d and h multiples of 64, every operand
contiguous and 16-byte aligned, and the exact-erf gelu only (what
``ExpertFFN`` passes by default).  Each launch counts in
``grouped_expert_ffn.launches``, and in ``launches_by_path`` under the
design that the C entries report: ``wgmma`` (bf16: persistent walks on
the wgmma / TMA ring) or ``tile`` (fp32: the first design)."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.nn.functional.activation import gelu
from paddle_tpu_torch.ops.kernels import _build, costs
from paddle_tpu_torch.ops.kernels.fused_block import (GEMM_PATHS,
                                                      _check_cuda,
                                                      _check_width,
                                                      gelu_grad)

__all__ = ["grouped_expert_ffn", "grouped_expert_ffn_reference",
           "GroupedExpertFFN", "record_path"]


def _check_act(act):
    """The kernel computes the exact-erf gelu and nothing else: accept
    ``None``, ``"gelu"`` or the port's ``F.gelu`` (``ExpertFFN``'s
    default activation), refuse anything else.  (The JAX wrapper's
    ``act=None`` is ``jax.nn.gelu``'s tanh form; ``ExpertFFN`` passes the
    exact one.)"""
    if act is None or act is gelu or (isinstance(act, str) and
                                      act == "gelu"):
        return
    raise ValueError(f"grouped_expert_ffn: activation {act!r} is not "
                     "computed by the grouped kernel (exact gelu only)")


def _shapes(x, w1, b1, w2, b2):
    """(G, C, d, E, h, rep), raising where the operands do not agree."""
    if x.ndim != 3 or w1.ndim != 3:
        raise ValueError(f"grouped_expert_ffn: x {tuple(x.shape)} and w1 "
                         f"{tuple(w1.shape)} must be 3-D")
    G, C, d = x.shape
    E, _, h = w1.shape
    if w1.shape != (E, d, h) or b1.shape != (E, h) or \
            w2.shape != (E, h, d) or b2.shape != (E, d):
        raise ValueError(
            f"grouped_expert_ffn: shapes x {tuple(x.shape)}, w1 "
            f"{tuple(w1.shape)}, b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, "
            f"b2 {tuple(b2.shape)} do not agree")
    if E <= 0 or G % E:
        raise ValueError(f"group count {G} not divisible by experts {E}")
    return G, C, d, E, h, G // E


def _row_mask(counts, C):
    """``[G, C, 1]`` True for rows below each group's count."""
    rows = torch.arange(C, device=counts.device)[None, :]
    return (rows < counts[:, None])[..., None]


# -- plain version (the CPU path and the kernel's reference) ----------------

def grouped_expert_ffn_reference(x, w1, b1, w2, b2, counts=None, act=None):
    """``grouped_expert_ffn_reference`` (``grouped_matmul.py:195-215``):
    fp32 products, bias and gelu in fp32, the hidden cast to x's dtype
    between the two products, y cast to x's dtype and rows past
    ``counts`` zeroed."""
    _check_act(act)
    G, C, d, E, h, rep = _shapes(x, w1, b1, w2, b2)
    xr = x.reshape(E, rep * C, d)
    u = torch.bmm(xr.float(), w1.float()) + b1.float()[:, None, :]
    hb = gelu(u).to(x.dtype)
    y = torch.bmm(hb.float(), w2.float()) + b2.float()[:, None, :]
    y = y.to(x.dtype).reshape(G, C, d)
    if counts is not None:
        y = torch.where(_row_mask(counts.to(x.device), C), y, 0)
    return y


# -- wrapper ------------------------------------------------------------------

def record_path(path: str):
    """One grouped expert-FFN call in
    ``paddle_tpu_grouped_moe_path_total{path}`` (the JAX package's
    series, ``grouped_matmul.py:81-90``): ``"grouped"`` where the CUDA
    kernel launched; the plain version is not counted, as JAX counts
    nothing on its einsum path."""
    from paddle_tpu_torch.observability import default_registry
    default_registry().counter(
        "paddle_tpu_grouped_moe_path_total",
        "grouped expert-FFN implementation chosen at trace time",
        labelnames=("path",)).labels(path=path).inc()


def grouped_expert_ffn(x, w1, b1, w2, b2, counts=None, act="gelu"):
    """``y[g] = gelu(x[g] @ w1[e] + b1[e]) @ w2[e] + b2[e]``,
    ``e = g // (G // E)``, over capacity-grouped tokens.

    x ``[G, C, d]``; w1 ``[E, d, h]``; b1 ``[E, h]``; w2 ``[E, h, d]``;
    b2 ``[E, d]``; counts ``[G]`` integers, the valid-row prefix of each
    group (``None``: every row); rows at and past a count come back
    exactly zero.  On the card this is two launches: x @ w1 with bias and
    gelu into a ``[G, C, h]`` workspace in x's dtype, then the down
    product (``csrc/grouped_matmul.cu`` says why).  Not differentiable:
    :class:`GroupedExpertFFN` is."""
    _check_act(act)
    G, C, d, E, h, rep = _shapes(x, w1, b1, w2, b2)
    if counts is None:
        counts = torch.full((G,), C, dtype=torch.int32, device=x.device)
    if tuple(counts.shape) != (G,):
        raise ValueError(f"grouped_expert_ffn: counts {tuple(counts.shape)} "
                         f"must be [{G}]")
    if x.device.type == "cpu":
        return _build.plain(
            "grouped_expert_ffn",
            lambda: costs.grouped(x, w1, b1, w2, b2, counts),
            grouped_expert_ffn_reference, x, w1, b1, w2, b2, counts, act)
    what = "grouped_expert_ffn"
    _check_cuda(what, dict(x=x, w1=w1, b1=b1, w2=w2, b2=b2), x.dtype)
    _check_width(what, d=d, h=h)
    if counts.device != x.device:
        raise ValueError(f"{what}: counts is on {counts.device}, expected "
                         f"{x.device}")
    counts = counts.to(torch.int32).contiguous()   # as the JAX wrapper casts
    y = torch.empty((G, C, d), dtype=x.dtype, device=x.device)
    if C:
        hbuf = torch.empty((G, C, h), dtype=x.dtype, device=x.device)
        lib = _build.library("grouped_matmul")
        code, stream = _build.DTYPE_CODES[x.dtype], _build.stream_of(x)
        design = ctypes.c_int(-1)   # both launches report the same
        err = lib.ptt_grouped_ffn_up(code, x.data_ptr(), w1.data_ptr(),
                                     b1.data_ptr(), counts.data_ptr(),
                                     hbuf.data_ptr(), G, C, d, h, rep, stream,
                                     ctypes.byref(design))
        _build.check(lib, err, what + " (up)")
        err = lib.ptt_grouped_ffn_down(code, hbuf.data_ptr(), w2.data_ptr(),
                                       b2.data_ptr(), counts.data_ptr(),
                                       y.data_ptr(), G, C, h, d, rep, stream,
                                       ctypes.byref(design))
        _build.check(lib, err, what + " (down)")
        _build.charge(what, costs.grouped, x, w1, b1, w2, b2, counts)
        grouped_expert_ffn.launches += 1
        grouped_expert_ffn.launches_by_path[GEMM_PATHS[design.value]] += 1
    return y


grouped_expert_ffn.launches = 0
grouped_expert_ffn.launches_by_path = dict.fromkeys(GEMM_PATHS, 0)


# -- custom VJP ---------------------------------------------------------------

def _bmm_f32(a, b):
    """fp32 product of io-dtype operands, as ``dot_general`` with
    ``preferred_element_type=float32``: the fp32 sum is kept, not rounded
    to the io dtype (bf16 on the card through ``out_dtype``; the CPU
    takes the exact fp32 product of the upcast operands)."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.bmm(a.float(), b.float())
    return torch.bmm(a, b, out_dtype=torch.float32)


@torch.library.custom_op("ptt::grouped_expert_ffn", mutates_args=())
def grouped_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor, counts: torch.Tensor,
               act: str) -> torch.Tensor:
    """``grouped_expert_ffn`` as a dispatcher op, which the custom VJP
    calls, so a selective remat policy sees it (fused_block.py says
    why)."""
    return grouped_expert_ffn(x, w1, b1, w2, b2, counts, act)


class GroupedExpertFFN(torch.autograd.Function):
    """``_grouped_core``'s custom VJP: the forward is the wrapper (the
    kernel pair on the card); the backward is ``_grouped_bwd``
    (``grouped_matmul.py:233-261``): inputs and cotangents masked to the
    valid rows, the up product recomputed in fp32, the gelu derivative
    written out, weight and input grads from io-dtype operands with fp32
    sums cast once.  ``counts`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, counts, act):
        G, C = x.shape[0], x.shape[1]
        if counts is None:
            counts = torch.full((G,), C, dtype=torch.int32, device=x.device)
        ctx.save_for_backward(x, w1, b1, w2, b2, counts)
        _check_act(act)     # every activation taken is the exact gelu
        return grouped_op(x, w1, b1, w2, b2, counts, "gelu")

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2, counts = ctx.saved_tensors
        G, C, d = x.shape
        E = w1.shape[0]
        rep = G // E
        dt = x.dtype
        valid = _row_mask(counts, C)
        xm = torch.where(valid, x, 0).reshape(E, rep * C, d)
        gy = torch.where(valid, dy.to(dt), 0).reshape(E, rep * C, d)
        u = _bmm_f32(xm, w1) + b1.float()[:, None, :]
        s = gelu(u)
        dh = _bmm_f32(gy, w2.transpose(1, 2))
        dw2 = torch.bmm(s.to(dt).transpose(1, 2), gy).to(w2.dtype)
        db2 = gy.float().sum(dim=1).to(b2.dtype)
        du = dh * gelu_grad(u)
        del s, dh, u
        dub = du.to(dt)
        dw1 = torch.bmm(xm.transpose(1, 2), dub).to(w1.dtype)
        db1 = du.sum(dim=1).to(b1.dtype)
        dx = torch.bmm(dub, w1.transpose(1, 2)).reshape(G, C, d).to(dt)
        return dx, dw1, db1, dw2, db2, None, None
