"""Flash attention forward and backward — wrappers of the CUDA kernels in
``csrc/flash_attention.cu`` and their plain PyTorch versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``:
``flash_attention_fwd`` replaces ``_fwd_kernel``,
``flash_attention_bwd_dq`` ``_bwd_dq_kernel`` and
``flash_attention_bwd_dkv`` ``_bwd_dkv_kernel``.  :func:`flash_attention`
is the differentiable entry point at the JAX package's ``[batch, seq,
heads, head_dim]`` layout; its ``torch.autograd.Function`` saves
``(q, k, v, out, lse)`` as ``_flash_fwd`` does and runs the two backward
kernels.

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.  The kernels
take float32 and bfloat16, head_dim 128, sequences that are a multiple
of 64, and heads a multiple of kv heads; every operand contiguous and
16-byte aligned.  In bf16 all three are Hopper kernels (wgmma fed by TMA
through mbarrier rings, a producer warpgroup and two consumers, scores
and accumulators in registers, 128-row tiles, P in the exp2 domain from
the natural-log lse): the forward and dq per q tile, dk/dv per key tile
walking its GQA group in one block, so its sums are deterministic.
fp32, a parity path, runs the first, shared-memory design.  Each wrapper
counts its launches (``.launches``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build, costs

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "flash_fwd_reference",
           "flash_bwd_reference", "flash_delta", "FlashAttention"]

_NEG = -1e30
# the one head_dim the kernels are instantiated for (csrc header)
KERNEL_HEAD_DIM = 128


# -- plain versions (the CPU path and the kernels' reference) ---------------

def _grouped(t, hk):
    """``[b, s, h, d]`` -> ``[b, s, hk, h // hk, d]``: query head h is
    (kv head h // rep, member h % rep) of its group."""
    b, s, h, d = t.shape
    return t.reshape(b, s, hk, h // hk, d)


def _scores(q, k, causal, scale):
    """fp32 ``[b, hk, rep, sq, sk]`` scores, masked to -1e30 above the
    diagonal as the TPU kernels mask them."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", _grouped(q.float(), k.shape[2]),
                     k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).tril(sk - sq)
        s = torch.where(keep, s, _NEG)
    return s


def flash_fwd_reference(q, k, v, causal=False, scale=None):
    """``(out, lse)`` of ``_fwd_kernel``: fp32 scores and softmax
    statistics, probabilities cast to v's dtype before the product with
    v, fp32 accumulation; ``out`` in q's dtype, ``lse`` ``[b, h, s]``
    fp32.  KV is read per group, never repeated."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    sc = _scores(q, k, causal, scale)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bgrqk,bkgd->bqgrd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(b, h, s)
    return out.reshape(b, s, h, d).to(q.dtype), lse


def flash_delta(out, dout):
    """``delta = rowsum(dout * out)`` as ``[b, h, s]`` fp32 — a torch
    reduction before the backward launches, as ``_bwd_pallas`` computes it
    outside its kernels."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_reference(q, k, v, dout, lse, delta, causal=False, scale=None):
    """``(dq, dk, dv)`` by the flash-attention-2 equations of
    ``_bwd_pallas`` / ``_bwd_blockwise``: P recomputed from lse,
    ``dS = P * (dP - delta) * scale``, dq per query head, dk/dv summed over
    each GQA group without repeating KV.  Products in fp32; P and dS pass
    through the input dtype before their products, where the bf16 kernels
    round them for the tensor cores (an identity in fp32)."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    rep = h // hk
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    dt = q.dtype
    sc = _scores(q, k, causal, scale)
    p = torch.exp(sc - lse.reshape(b, hk, rep, s)[..., None])
    g = _grouped(dout.float(), hk)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", g, v.float())
    ds = p * (dp - delta.reshape(b, hk, rep, s)[..., None]) * scale
    p, ds = p.to(dt).float(), ds.to(dt).float()
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, g)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float())
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, _grouped(q.float(), hk))
    return (dq.reshape(b, s, h, d).to(dt), dk.to(k.dtype), dv.to(v.dtype))


# -- wrappers -----------------------------------------------------------------

def _check(what, q, k, v, extra=()):
    b, s, h, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[:2] != (b, s) or \
            k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must be [b, s, h, d] / "
                         "[b, s, hk, d] with one b, s and d")
    if h % k.shape[2]:
        raise ValueError(f"{what}: heads {h} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if q.device.type == "cpu":
        return
    if d != KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"{what}: the CUDA kernels are built for head_dim "
            f"{KERNEL_HEAD_DIM}; head_dim {d} waits (ROADMAP.md, queue 2)")
    if s % 64:
        raise ValueError(f"{what}: seq {s} must be a multiple of 64")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {q.dtype} not supported (float32, "
                        "bfloat16)")
    for name, t, dt in (("q", q, q.dtype), ("k", k, q.dtype),
                        ("v", v, q.dtype)) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def _scale(q, scale):
    return float(scale) if scale is not None else 1.0 / (q.shape[-1] ** 0.5)


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """``(out [b, s, h, d], lse [b, h, s] fp32)``; q ``[b, s, h, d]``,
    k/v ``[b, s, hk, d]``."""
    what = "flash_attention_fwd"
    _check(what, q, k, v)
    if q.device.type == "cpu":
        return _build.plain(what, lambda: costs.flash_fwd(q, k, v, causal),
                            flash_fwd_reference, q, k, v, causal, scale)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention")
    err = lib.ptt_flash_fwd(_build.DTYPE_CODES[q.dtype], q.data_ptr(),
                            k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            lse.data_ptr(), b, s, h, k.shape[2], d,
                            _scale(q, scale), int(bool(causal)),
                            _build.stream_of(q))
    _build.check(lib, err, what)
    _build.charge(what, costs.flash_fwd, q, k, v, causal)
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _bwd_extra(q, dout, lse, delta):
    return (("dout", dout, q.dtype), ("lse", lse, torch.float32),
            ("delta", delta, torch.float32))


def _check_stats(what, q, lse, delta):
    b, s, h, _ = q.shape
    if tuple(lse.shape) != (b, h, s) or tuple(delta.shape) != (b, h, s):
        raise ValueError(f"{what}: lse {tuple(lse.shape)} and delta "
                         f"{tuple(delta.shape)} must be [b, h, s] = "
                         f"{(b, h, s)}")


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False,
                           scale=None):
    """dq ``[b, s, h, d]`` from the saved lse and ``delta`` (both
    ``[b, h, s]`` fp32)."""
    what = "flash_attention_bwd_dq"
    _check_stats(what, q, lse, delta)
    _check(what, q, k, v, _bwd_extra(q, dout, lse, delta))
    if q.device.type == "cpu":
        return _build.plain(what, lambda: costs.flash_dq(q, k, v, causal),
                            flash_bwd_reference, q, k, v, dout, lse, delta,
                            causal, scale)[0]
    b, s, h, d = q.shape
    dq = torch.empty_like(q)
    lib = _build.library("flash_attention")
    err = lib.ptt_flash_bwd_dq(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), b, s, h, k.shape[2], d, _scale(q, scale),
        int(bool(causal)), _build.stream_of(q))
    _build.check(lib, err, what)
    _build.charge(what, costs.flash_dq, q, k, v, causal)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False,
                            scale=None):
    """``(dk, dv)``, each ``[b, s, hk, d]``, summed over each kv head's
    query group."""
    what = "flash_attention_bwd_dkv"
    _check_stats(what, q, lse, delta)
    _check(what, q, k, v, _bwd_extra(q, dout, lse, delta))
    if q.device.type == "cpu":
        return _build.plain(what, lambda: costs.flash_dkv(q, k, v, causal),
                            flash_bwd_reference, q, k, v, dout, lse, delta,
                            causal, scale)[1:]
    b, s, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.library("flash_attention")
    err = lib.ptt_flash_bwd_dkv(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, s, h, k.shape[2], d,
        _scale(q, scale), int(bool(causal)), _build.stream_of(q))
    _build.check(lib, err, what)
    _build.charge(what, costs.flash_dkv, q, k, v, causal)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0


@torch.library.custom_op("ptt::flash_attention_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, scale: float | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as a dispatcher op, which the custom VJP
    calls, so a selective remat policy sees it (fused_block.py says
    why)."""
    return flash_attention_fwd(q, k, v, causal, scale)


class FlashAttention(torch.autograd.Function):
    """``_flash_core``'s custom VJP: the forward kernel saves
    ``(q, k, v, out, lse)``; the backward is the dq and dk/dv kernels
    (the JAX package's ``pallas_bwd=True`` route)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_fwd_op(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()     # autograd may hand over a strided view
        delta = flash_delta(out, dout)
        dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, ctx.causal,
                                    ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Differentiable flash attention over ``[b, s, h, d]`` q and
    ``[b, s, hk, d]`` k/v (heads a multiple of kv heads); ``scale``
    defaults to ``head_dim ** -0.5``.  Returns ``[b, s, h, d]``."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), bool(causal), scale)
