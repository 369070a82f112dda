"""Fused residual add + RMSNorm — the wrapper of the CUDA kernel in
``csrc/rmsnorm.cu``, its plain PyTorch version and its custom VJP.

Counterpart of ``paddle_tpu/ops/pallas/rmsnorm.py``: ``fused_rmsnorm``
replaces ``_fwd_kernel`` (``h = x (+ residual)``, ``y = rmsnorm(h) * w``
with fp32 statistics; ``y`` and ``h`` in x's dtype, ``inv`` in fp32),
and ``FusedRMSNorm`` is ``_core``'s custom VJP, whose backward is plain
products as JAX's ``_bwd`` is jnp code.  A tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel or raises.  The kernel
takes any row count and any d (16-byte vectors held in registers where
every row is aligned, elements otherwise); x, residual and the weight
share one dtype (float32 or bfloat16).  Without a residual h is x itself
(x to fp32 and back is exact): both versions return x as h, and the
kernel writes none of it.  The wrapper counts its launches
(``fused_rmsnorm.launches``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build, costs

__all__ = ["fused_rmsnorm", "rmsnorm_reference", "FusedRMSNorm"]


def rmsnorm_reference(x, weight, residual=None, epsilon=1e-5):
    """``_ref_fwd`` (``rmsnorm.py:101-107``): ``(y, h, inv)`` with h =
    x (+ residual) summed in fp32, inv ``[..., 1]`` fp32, y = (h * inv)
    * w in fp32; y and h cast to x's dtype.  Without a residual that h
    is x's own values, and x itself is returned."""
    h = x.float()
    if residual is not None:
        h = h + residual.float()
    inv = torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + epsilon)
    y = (h * inv) * weight.float()
    return y.to(x.dtype), x if residual is None else h.to(x.dtype), inv


def fused_rmsnorm(x, weight, residual=None, epsilon=1e-5):
    """``(y, h, inv)``: h = x (+ residual), y = rmsnorm(h) * weight.

    x ``[..., d]``; weight ``[d]``; residual x's shape or None.  y and h
    have x's shape and dtype (h is x itself without a residual), inv
    ``[..., 1]`` fp32."""
    if x.device.type == "cpu":
        return _build.plain(
            "fused_rmsnorm", lambda: costs.rmsnorm(x, weight, residual),
            rmsnorm_reference, x, weight, residual, epsilon)
    what = "fused_rmsnorm"
    lead, d = x.shape[:-1], x.shape[-1]
    if tuple(weight.shape) != (d,) or \
            (residual is not None and residual.shape != x.shape):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, weight "
            f"{tuple(weight.shape)}, residual "
            f"{None if residual is None else tuple(residual.shape)} do not "
            "agree")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32, "
                        "bfloat16)")
    ops = dict(x=x, weight=weight)
    if residual is not None:
        ops["residual"] = residual
    for name, t in ops.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected "
                            f"{x.dtype} (x, residual and weight share one "
                            "dtype)")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    y = torch.empty_like(x2)
    h = x2 if residual is None else torch.empty_like(x2)
    inv = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if rows and d:
        lib = _build.library("rmsnorm")
        err = lib.ptt_rmsnorm(
            _build.DTYPE_CODES[x.dtype], x2.data_ptr(),
            None if residual is None else residual.data_ptr(),
            weight.data_ptr(), y.data_ptr(),
            None if residual is None else h.data_ptr(), inv.data_ptr(),
            rows, d, float(epsilon), _build.stream_of(x))
        _build.check(lib, err, what)
        _build.charge(what, costs.rmsnorm, x, weight, residual)
        fused_rmsnorm.launches += 1
    return y.reshape(x.shape), h.reshape(x.shape), inv.reshape(*lead, 1)


fused_rmsnorm.launches = 0


class FusedRMSNorm(torch.autograd.Function):
    """``_core`` / ``_fwd`` / ``_bwd`` (``rmsnorm.py:110-147``) over
    ``[R, d]`` rows.  ``res2d`` is the residual, or, with ``has_res``
    False, an unread placeholder (JAX passes x itself) whose cotangent is
    zero, so a caller's x gradient is not counted twice.  The backward
    keeps JAX's precision: fp32 from the saved h, inv and w; dx and dres
    in h's dtype, dw summed in fp32 and cast to w's dtype."""

    @staticmethod
    def forward(ctx, x2d, res2d, weight, epsilon, has_res):
        y, h, inv = fused_rmsnorm(x2d, weight, res2d if has_res else None,
                                  epsilon)
        ctx.save_for_backward(h, inv, weight)
        ctx.has_res = has_res
        return y, h

    @staticmethod
    def backward(ctx, gy, gh):
        h, inv, w = ctx.saved_tensors
        hf = h.float()
        gw_row = gy.float() * w.float()
        # dL/dh = inv * gw - h * inv^3 * mean(gw * h)
        dot = torch.mean(gw_row * hf, dim=-1, keepdim=True)
        dh = inv * gw_row - hf * inv ** 3 * dot
        if gh is not None:
            dh = dh + gh.float()
        dw = (gy.float() * hf * inv).sum(0).to(w.dtype)
        dx = dh.to(h.dtype)
        dres = dx if ctx.has_res else torch.zeros_like(dx)
        return dx, dres, dw, None, None
