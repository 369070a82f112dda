"""Fused RMSNorm+QKV, gated SwiGLU MLP, the act + bias feed-forward and
the whole Llama decoder block — wrappers of the CUDA kernels in
``csrc/fused_block.cu`` and ``csrc/fused_decoder.cu`` and their plain
PyTorch versions.

Counterparts of ``paddle_tpu/ops/pallas/fused_block.py``:
``fused_rmsnorm_qkv`` replaces ``_qkv_kernel`` (the forward-only variant,
and with ``residuals=True`` the training variant that also emits
``(xn, inv)``), ``fused_mlp`` replaces ``_mlp_kernel`` (gated silu) and
``fused_ffn`` its non-gated variant (``act(x W1 + b1) W2 + b2`` with
relu, exact-erf gelu or silu), and ``fused_decoder_block`` replaces
``_decoder_kernel``.  ``FusedRMSNormQKV``, ``FusedMLP`` and ``FusedFFN``
are the custom VJPs around the first three (``_qkv_fwd``/``_qkv_bwd``,
``_mlp_gated_fwd``/``_mlp_gated_bwd``, ``_ffn_fwd``/``_ffn_bwd``); their
backward passes are plain matrix products, as in the JAX package, where
they run outside any Pallas kernel.  ``FusedDecoderBlock`` is the
block's block-boundary remat (``_decoder_fwd``/``_decoder_bwd``).  A
tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.

The TPU kernels route only where Mosaic can tile the shape
(``fused_qkv_eligible``: rows a multiple of 8/16); the CUDA kernels mask
ragged row tiles themselves and take any row count.  They need the
feature widths (d, dq, dkv, f) to be multiples of 64, all operands of
one dtype (float32 or bfloat16), contiguous and 16-byte aligned.

The decoder tier (``PADDLE_TPU_FUSED_BLOCK=decoder``) routes a Llama
layer to the block kernel where ``fused_decoder_eligible`` takes its
shape: JAX's shape conditions, with the Hopper kernel's own needs in
place of the TPU's VMEM budget.  The ``measured`` tier makes that choice
per shape from the measurement ledger (``measured_tier_for``).

Each wrapper counts its launches in a plain integer attribute
(``fused_rmsnorm_qkv.launches``), so a run can show the kernels were on
its path."""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from paddle_tpu_torch.ops.kernels import _build, costs
from paddle_tpu_torch.ops.kernels.splitk import (MLP_BN, SPLITK_BN,
                                                 mlp_splits, splitk_splits)
from paddle_tpu_torch.ops.kernels.flash_attention import (KERNEL_HEAD_DIM,
                                                          flash_fwd_reference)

__all__ = ["fused_rmsnorm_qkv", "fused_mlp", "fused_ffn",
           "fused_decoder_block", "qkv_reference", "mlp_reference",
           "ffn_reference", "decoder_reference", "decoder_segments",
           "fused_block_tier", "measured_tier_for",
           "clear_measured_tiers", "fused_decoder_eligible",
           "decoder_workspace_bytes", "FusedRMSNormQKV", "FusedMLP",
           "FusedFFN", "FusedDecoderBlock", "SUPPORTED_ACTS", "GEMM_PATHS",
           "gemm_path", "qkv_path", "qkv_column_tiles", "qkv_splits",
           "mlp_workspace", "record_path", "tf32x3_qkv_floats",
           "tf32x3_mlp_floats", "TF32X3_F64_FACTOR"]

# the smallest row count at which the bf16 QKV kernel runs as a row pass
# and a wgmma GEMM (csrc/fused_block.cu, kRowPassMinT); the forward
# variant's normalised rows then go to a workspace.  The bf16 MLP and
# fused_ffn take the wgmma GEMM from the same row count, and split-K below
# it (SPLITK_MAX_T = ROW_PASS_MIN_T - 1).
ROW_PASS_MIN_T = 17
# the blocks per SM QKV's split rule aims at (csrc/fused_block.cu,
# kQkvSplitFactor); its largest row count and tile width are splitk.py's
# (SPLITK_MAX_T, SPLITK_BN: csrc/splitk.cuh), shared with the quant matmul
QKV_SPLIT_FACTOR = 4
# the designs a launch of QKV, the MLP, fused_ffn, the decoder block or the
# grouped expert FFN takes, counted in each wrapper's `launches_by_path`
# (csrc/common.cuh, enum Design, in its order); QKV, the MLP and fused_ffn
# take ``splitk`` at decode rows in bf16 and ``tf32x3`` past them in fp32
GEMM_PATHS = ("wgmma", "tile", "splitk", "tf32x3")


# a 3xTF32 output's largest error against the same function in float64,
# at most this many times the plain fp32 version's own (the card tests and
# chip_smoke.py hold the kernels to it)
TF32X3_F64_FACTOR = 8


def tf32x3_qkv_floats(T: int, d: int, dq: int, dkv: int) -> int:
    """The fp32 values of 3xTF32 QKV's split operands: W^T's hi and lo of
    q | k | v, then xn's hi and lo (``qkv_tf32x3_floats`` in
    ``csrc/fused_block.cu``)."""
    return 2 * (dq + 2 * dkv) * d + 2 * T * d


def tf32x3_mlp_floats(T: int, d: int, f: int, gated: bool) -> int:
    """The fp32 values of the 3xTF32 MLP's (or fused_ffn's) split
    operands: W1^T's (and Wu^T's) hi and lo, W2^T's, x's, then h's
    (``mlp_tf32x3_floats``)."""
    return 2 * (3 if gated else 2) * f * d + 2 * T * (d + f)


def gemm_path(T: int, dtype) -> str:
    """The MLP's and fused_ffn's design: in bf16 ``wgmma`` (the TMA /
    wgmma ring of ``csrc/hopper_gemm.cuh``) at ``ROW_PASS_MIN_T`` rows or
    more and ``splitk`` (splitk.cuh's strip stream) below; in fp32
    ``tf32x3`` (three TF32 products on wgmma, ``csrc/tf32x3.cuh``) at
    ``ROW_PASS_MIN_T`` rows or more and ``tile`` (the fp32 tile of
    ``csrc/gemm_tile.cuh``) below."""
    if dtype != torch.bfloat16:
        return "tf32x3" if T >= ROW_PASS_MIN_T else "tile"
    return "wgmma" if T >= ROW_PASS_MIN_T else "splitk"


def qkv_path(T: int, dtype, residuals: bool = False) -> str:
    """QKV's design: ``gemm_path``'s, except the training variant at
    ``SPLITK_MAX_T`` rows or fewer, which keeps the wmma ``tile``."""
    path = gemm_path(T, dtype)
    return "tile" if residuals and path == "splitk" else path


def qkv_column_tiles(dq: int, dkv: int):
    """QKV split-K's column tiles, in launch order: ``(part, first
    column in the part, columns)`` for q (part 0), k and v, each tile
    ``SPLITK_BN`` wide and inside its part (a part's last tile may be
    narrower)."""
    return [(part, c, min(SPLITK_BN, n - c))
            for part, n in enumerate((dq, dkv, dkv))
            for c in range(0, n, SPLITK_BN)]


def qkv_splits(d: int, dq: int, dkv: int, sms: int) -> int:
    """QKV split-K's K splits (``qkv_splits`` in the source): the quant
    matmul's rule at QKV_SPLIT_FACTOR blocks a SM, over the column tiles
    of q | k | v."""
    return splitk_splits(d, len(qkv_column_tiles(dq, dkv)) * SPLITK_BN, sms,
                         QKV_SPLIT_FACTOR)


@functools.lru_cache(maxsize=256)
def _qkv_workspace(lib, T, d, dq, dkv):
    """(fp32 values of the partials, tickets) of QKV split-K at T rows:
    `lib`'s split count (on its device) over the column tiles, (0, 0)
    with one split."""
    splits = lib.ptt_qkv_splits(_build.DTYPE_CODES[torch.bfloat16], T, d,
                                dq, dkv, 0)
    tiles = len(qkv_column_tiles(dq, dkv))
    return (splits * T * tiles * SPLITK_BN, tiles) if splits > 1 else (0, 0)


@functools.lru_cache(maxsize=256)
def mlp_workspace(T: int, d: int, f: int, gated: bool, sms: int):
    """(fp32 values of the partials, tickets) of the MLP's split-K at T
    rows on `sms` SMs: the larger of its two launches' ``splits * NB *
    tiles * MLP_BN * ntok`` (NB = 2 for the gated gate/up; ntok, the
    tokens a fragment holds, 8 at T <= 8, else 16), and the wider
    product's MLP_BN-column tiles.  The C entry checks the size against
    its own split counts and refuses a smaller workspace."""
    up, down = -(-f // MLP_BN), -(-d // MLP_BN)
    ntok = 8 if T <= 8 else 16
    return (max(mlp_splits(d, f, sms) * (1 + gated) * up,
                mlp_splits(f, d, sms) * down) * MLP_BN * ntok,
            max(up, down))


# fused_ffn's activations and their codes in csrc/fused_block.cu (enum Act)
ACT_CODES = {"relu": 0, "gelu": 1, "silu": 2}
SUPPORTED_ACTS = tuple(ACT_CODES)


def _act(name, u):
    """relu, exact-erf gelu (``jax.nn.gelu(approximate=False)``) or
    silu of `u`, in u's dtype."""
    if name == "relu":
        return torch.relu(u)
    if name == "gelu":
        return 0.5 * u * torch.erfc(-u * 0.5 ** 0.5)
    return u * torch.sigmoid(u)


def gelu_grad(u):
    """d gelu / du of the exact gelu: Phi(u) + u phi(u)."""
    return 0.5 * torch.erfc(-u * 0.5 ** 0.5) + \
        u * torch.exp(-0.5 * u * u) * (2 * torch.pi) ** -0.5


def _act_grad(name, u):
    """d act / d u at `u` (fp32)."""
    if name == "relu":
        return (u > 0).to(u.dtype)
    if name == "gelu":
        return gelu_grad(u)
    sg = torch.sigmoid(u)
    return sg * (1 + u * (1 - sg))


# -- plain versions (the CPU path and the kernels' reference) ---------------

def qkv_reference(x, norm_weight, wq, wk, wv, epsilon=1e-5,
                  residuals=False):
    """``_qkv_reference`` (``fused_block.py:345-356``): fp32 statistics,
    xn cast to x's dtype before the products, fp32 accumulation, outputs
    in x's dtype.  ``residuals`` adds ``xn`` (x's dtype) and ``inv``
    (``[..., 1]`` fp32)."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + epsilon)
    xn = ((xf * inv) * norm_weight.float()).to(x.dtype)

    def proj(w):
        return torch.matmul(xn.float(), w.float()).to(x.dtype)

    out = (proj(wq), proj(wk), proj(wv))
    return out + (xn, inv) if residuals else out


def ffn_reference(x, w1, b1, w2, b2, activation="relu"):
    """``_ffn_reference`` (``fused_block.py:633-637``): fp32 products with
    the fp32 biases added, h = act(u) cast to x's dtype, fp32 down
    product plus b2, one cast to x's dtype."""
    u = torch.matmul(x.float(), w1.float()) + b1.float()
    h = _act(activation, u).to(x.dtype)
    y = torch.matmul(h.float(), w2.float()) + b2.float()
    return y.to(x.dtype)


def mlp_reference(x, w_gate, w_up, w_down):
    """``_mlp_gated_reference`` (``fused_block.py:581-585``): fp32
    products, h = silu(g) * u cast to x's dtype, fp32 down product."""
    g = torch.matmul(x.float(), w_gate.float())
    u = torch.matmul(x.float(), w_up.float())
    h = (g * torch.sigmoid(g) * u).to(x.dtype)
    return torch.matmul(h.float(), w_down.float()).to(x.dtype)


# -- wrappers -----------------------------------------------------------------

def _check_cuda(what, tensors, dtype):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             "the CUDA device of x")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype} "
                            "(all operands share one dtype)")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if dtype not in _build.DTYPE_CODES:
        raise _build.dtype_error(what, dtype)


def _check_width(what, **dims):
    for name, n in dims.items():
        if n % 64:
            raise ValueError(f"{what}: {name}={n} must be a multiple of 64")


def fused_rmsnorm_qkv(x, norm_weight, wq, wk, wv, epsilon=1e-5,
                      residuals=False):
    """``q, k, v = (rmsnorm(x) * norm_weight) @ (wq | wk | wv)``.

    x ``[..., d]``; norm_weight ``[d]``; wq ``[d, dq]``; wk/wv
    ``[d, dkv]`` (``[in, out]``).  Returns projections with x's leading
    dims, in x's dtype; with ``residuals`` also the normalised rows
    ``xn`` (``[..., d]``, x's dtype) and the inverse RMS ``inv``
    (``[..., 1]`` fp32) from the same call (the training variant).  On
    the card, bf16 at ``ROW_PASS_MIN_T`` rows or more is a row pass and
    a wgmma GEMM over its ``xn`` (a workspace in the forward variant),
    two launches of one call; the bf16 forward variant at
    ``SPLITK_MAX_T`` rows or fewer is the same row pass and a split-K
    launch (its fp32 partials in a workspace of ``splits * T * tiles *
    128 * 4`` bytes, 2.1 MB at Llama-3-8B width and T = 8); the training
    variant at fewer rows, and fp32 at fewer rows, are one launch of the
    wmma / fp32 tile.  fp32 at ``ROW_PASS_MIN_T`` rows or more is 3xTF32
    (``tf32x3``): the weights split into W^T's TF32 hi and lo, the row
    pass (also xn's hi and lo), then the GEMM on wgmma, three launches,
    the split operands in a buffer of ``tf32x3_qkv_floats`` fp32 values
    (470 MB at Llama-3-8B width and T = 8192) allocated for the call, as
    the bf16 ring's h is.  At decode rows the forward variant's
    workspaces are kept per device (``_build.workspace``) and reused by
    the next call.
    ``launches_by_path`` counts the design the C entry reports."""
    if x.device.type == "cpu":
        return _build.plain(
            "fused_rmsnorm_qkv",
            lambda: costs.qkv(x, norm_weight, wq, wk, wv, residuals),
            qkv_reference, x, norm_weight, wq, wk, wv, epsilon, residuals)
    what = "fused_rmsnorm_qkv"
    lead, d = x.shape[:-1], x.shape[-1]
    dq, dkv = wq.shape[1], wk.shape[1]
    if norm_weight.shape != (d,) or wq.shape[0] != d or \
            wk.shape != (d, dkv) or wv.shape != (d, dkv):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, norm_weight "
            f"{tuple(norm_weight.shape)}, wq {tuple(wq.shape)}, wk "
            f"{tuple(wk.shape)}, wv {tuple(wv.shape)} do not agree")
    _check_cuda(what, dict(x=x, norm_weight=norm_weight, wq=wq, wk=wk,
                           wv=wv), x.dtype)
    _check_width(what, d=d, dq=dq, dkv=dkv)
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    dev = x.device
    q = torch.empty((T, dq), dtype=x.dtype, device=dev)
    k = torch.empty((T, dkv), dtype=x.dtype, device=dev)
    v = torch.empty((T, dkv), dtype=x.dtype, device=dev)
    xn = inv = None
    if residuals:
        xn = torch.empty((T, d), dtype=x.dtype, device=dev)
        inv = torch.empty((T, 1), dtype=torch.float32, device=dev)
    elif x.dtype == torch.bfloat16 and qkv_path(T, x.dtype) == "wgmma":
        # the row pass's output, read by the GEMM: a workspace
        xn = torch.empty((T, d), dtype=x.dtype, device=dev)
    if T:
        lib = _build.library("fused_block")
        code = _build.DTYPE_CODES[x.dtype]
        xn_ptr = None if xn is None else xn.data_ptr()
        ws = tickets = None
        path = qkv_path(T, x.dtype, residuals)
        if path == "tf32x3":
            split = torch.empty(tf32x3_qkv_floats(T, d, dq, dkv),
                                dtype=torch.float32, device=dev)
            ws = split.data_ptr()
        elif path == "splitk":
            # decode rows: the row pass's output and the partials in
            # workspaces kept for the next call
            xn_ptr = _build.workspace("fused_rmsnorm_qkv.xn", dev, 2 * T * d)
            floats, tiles = _qkv_workspace(lib, T, d, dq, dkv)
            if floats:
                ws = _build.workspace("fused_rmsnorm_qkv.ws", dev,
                                      4 * floats)
                tickets = _build.tickets("fused_rmsnorm_qkv", dev,
                                         tiles).data_ptr()
        design = ctypes.c_int(-1)
        err = lib.ptt_rmsnorm_qkv(
            code, x2.data_ptr(), norm_weight.data_ptr(), wq.data_ptr(),
            wk.data_ptr(), wv.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), xn_ptr, None if inv is None else inv.data_ptr(),
            ws, tickets, T, d, dq, dkv, float(epsilon), _build.stream_of(x),
            ctypes.byref(design))
        _build.check(lib, err, what)
        _build.charge(what, costs.qkv, x, norm_weight, wq, wk, wv,
                      residuals)
        fused_rmsnorm_qkv.launches += 1
        _build.count_dtype(fused_rmsnorm_qkv, x.dtype)
        fused_rmsnorm_qkv.launches_by_path[GEMM_PATHS[design.value]] += 1
    out = (q.reshape(*lead, dq), k.reshape(*lead, dkv),
           v.reshape(*lead, dkv))
    if residuals:
        out += (xn.reshape(*lead, d), inv.reshape(*lead, 1))
    return out


fused_rmsnorm_qkv.launches = 0
fused_rmsnorm_qkv.launches_by_dtype = {}
fused_rmsnorm_qkv.launches_by_path = dict.fromkeys(GEMM_PATHS, 0)


def _mlp_launch(fn, x, w1, wu, w2, b1, b2, act):
    """One ``ptt_mlp`` call (its two GEMM launches) over x's rows,
    counted on `fn`: the gated form with `wu`, else fused_ffn's; at decode
    rows (split-K) h and the partials in workspaces kept per device, and
    in fp32 past them (3xTF32) the split operands, h's among them, in one
    buffer of ``tf32x3_mlp_floats`` fp32 values allocated for the call."""
    what = fn.__name__
    d, f = x.shape[-1], w1.shape[1]
    x2 = x.reshape(-1, d)
    T = x2.shape[0]
    dev = x.device
    y = torch.empty((T, d), dtype=x.dtype, device=dev)
    if T:
        lib = _build.library("fused_block")
        ws = tickets = None
        floats = 0
        path = gemm_path(T, x.dtype)
        if path == "tf32x3":
            h = None
            floats = tf32x3_mlp_floats(T, d, f, wu is not None)
            split = torch.empty(floats, dtype=torch.float32, device=dev)
            ws = split.data_ptr()
        elif path == "splitk":
            h = _build.workspace(what + ".h", dev, 2 * T * f)
            floats, tiles = mlp_workspace(T, d, f, wu is not None,
                                          _build.sm_count(dev))
            ws = _build.workspace(what + ".ws", dev, 4 * floats)
            tickets = _build.tickets(what, dev, tiles).data_ptr()
        else:
            hbuf = torch.empty((T, f), dtype=x.dtype, device=dev)
            h = hbuf.data_ptr()
        design = ctypes.c_int(-1)
        err = lib.ptt_mlp(
            _build.DTYPE_CODES[x.dtype], act, x2.data_ptr(), w1.data_ptr(),
            None if wu is None else wu.data_ptr(), w2.data_ptr(),
            None if b1 is None else b1.data_ptr(),
            None if b2 is None else b2.data_ptr(), h, y.data_ptr(), ws,
            floats, tickets, T, d, f, _build.stream_of(x),
            ctypes.byref(design))
        _build.check(lib, err, what)
        if wu is None:
            _build.charge(what, costs.ffn, x, w1, w2, b1, b2)
        else:
            _build.charge(what, costs.mlp, x, w1, wu, w2)
        fn.launches += 1
        fn.launches_by_path[GEMM_PATHS[design.value]] += 1
        _build.count_dtype(fn, x.dtype)
    return y.reshape(x.shape)


def fused_mlp(x, w_gate, w_up, w_down):
    """``y = (silu(x @ w_gate) * (x @ w_up)) @ w_down`` (SwiGLU).

    x ``[..., d]``; w_gate/w_up ``[d, f]``; w_down ``[f, d]``.  On the
    card this is two launches of one call: gate/up with the activation
    product written to a ``[T, f]`` workspace in x's dtype, then the down
    product (``csrc/fused_block.cu`` says why); in bf16 on the wgmma /
    TMA ring at ``ROW_PASS_MIN_T`` rows or more and split-K below
    (``gemm_path``), in fp32 as 3xTF32 on wgmma at ``ROW_PASS_MIN_T``
    rows or more (the weights and x split first; h's TF32 halves in place
    of h) and on the fp32 tile below.  ``launches_by_path`` counts the
    design the C entry reports."""
    if x.device.type == "cpu":
        return _build.plain(
            "fused_mlp", lambda: costs.mlp(x, w_gate, w_up, w_down),
            mlp_reference, x, w_gate, w_up, w_down)
    what = "fused_mlp"
    d = x.shape[-1]
    f = w_gate.shape[1]
    if w_gate.shape != (d, f) or w_up.shape != (d, f) or \
            w_down.shape != (f, d):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, w_gate "
            f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, w_down "
            f"{tuple(w_down.shape)} do not agree")
    _check_cuda(what, dict(x=x, w_gate=w_gate, w_up=w_up, w_down=w_down),
                x.dtype)
    _check_width(what, d=d, f=f)
    return _mlp_launch(fused_mlp, x, w_gate, w_up, w_down, None, None, 0)


fused_mlp.launches = 0
fused_mlp.launches_by_dtype = {}
fused_mlp.launches_by_path = dict.fromkeys(GEMM_PATHS, 0)


def fused_ffn(x, w1, w2, b1=None, b2=None, activation="relu"):
    """``y = act(x @ w1 + b1) @ w2 + b2``, the classic Transformer
    feed-forward (``fused_block.py:1172``).

    x ``[..., d]``; w1 ``[d, f]``; w2 ``[f, d]``; b1 ``[f]`` and b2
    ``[d]`` may be None (zeros, as the JAX wrapper makes them);
    ``activation`` one of relu, gelu (exact erf) and silu.  On the card
    this is two launches of one call, on ``fused_mlp``'s designs: x @ w1
    + b1 and the activation into a ``[T, f]`` workspace in x's dtype,
    then the down product plus b2."""
    if activation not in ACT_CODES:
        raise ValueError(f"unsupported activation {activation!r}; "
                         f"expected one of {SUPPORTED_ACTS}")
    d = x.shape[-1]
    f = w1.shape[-1]
    if b1 is None:
        b1 = torch.zeros((f,), dtype=x.dtype, device=x.device)
    if b2 is None:
        b2 = torch.zeros((w2.shape[-1],), dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return _build.plain(
            "fused_ffn", lambda: costs.ffn(x, w1, w2, b1, b2),
            ffn_reference, x, w1, b1, w2, b2, activation)
    what = "fused_ffn"
    if w1.shape != (d, f) or w2.shape != (f, d) or b1.shape != (f,) or \
            b2.shape != (d,):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 "
            f"{tuple(w2.shape)}, b1 {tuple(b1.shape)}, b2 "
            f"{tuple(b2.shape)} do not agree")
    _check_cuda(what, dict(x=x, w1=w1, w2=w2, b1=b1, b2=b2), x.dtype)
    _check_width(what, d=d, f=f)
    return _mlp_launch(fused_ffn, x, w1, None, w2, b1, b2,
                       ACT_CODES[activation])


fused_ffn.launches = 0
fused_ffn.launches_by_dtype = {}
fused_ffn.launches_by_path = dict.fromkeys(GEMM_PATHS, 0)


# -- the wrappers as dispatcher ops -------------------------------------------
# The custom VJPs' forwards call these, so a selective remat policy (the
# "dots" policies of jit/train_step.py) sees the products the kernels
# compute inside their C calls and can keep their results.

T_ = torch.Tensor


@torch.library.custom_op("ptt::fused_rmsnorm_qkv", mutates_args=())
def qkv_train_op(x: T_, norm_weight: T_, wq: T_, wk: T_, wv: T_,
                 epsilon: float) -> tuple[T_, T_, T_, T_, T_]:
    """``fused_rmsnorm_qkv(..., residuals=True)``: q, k, v, xn, inv."""
    return fused_rmsnorm_qkv(x, norm_weight, wq, wk, wv, epsilon,
                             residuals=True)


@torch.library.custom_op("ptt::fused_mlp", mutates_args=())
def mlp_op(x: T_, w_gate: T_, w_up: T_, w_down: T_) -> T_:
    """``fused_mlp``."""
    return fused_mlp(x, w_gate, w_up, w_down)


@torch.library.custom_op("ptt::fused_ffn", mutates_args=())
def ffn_op(x: T_, w1: T_, b1: T_ | None, w2: T_, b2: T_ | None,
           activation: str) -> T_:
    """``fused_ffn``."""
    return fused_ffn(x, w1, w2, b1, b2, activation)


# -- custom VJPs --------------------------------------------------------------

class FusedRMSNormQKV(torch.autograd.Function):
    """``_qkv_fwd`` / ``_qkv_bwd`` over ``[T, d]`` rows: the forward
    launches the training variant, which also emits ``xn`` and ``inv``,
    so the backward never recomputes the norm.  The backward keeps the
    JAX package's precision: the dx products and their sum in the io
    dtype, weight grads accumulated in fp32 and cast to the weight dtype,
    the rmsnorm backward in fp32 from the saved ``inv``."""

    @staticmethod
    def forward(ctx, x2d, norm_weight, wq, wk, wv, epsilon):
        q, k, v, xn, inv = qkv_train_op(x2d, norm_weight, wq, wk, wv,
                                        epsilon)
        ctx.save_for_backward(x2d, norm_weight, wq, wk, wv, xn, inv)
        return q, k, v

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x2d, wn, wq, wk, wv, xn, inv = ctx.saved_tensors
        dt = x2d.dtype
        dq, dk, dv = (g.to(dt) for g in (dq, dk, dv))
        # products of io-dtype operands accumulate in fp32 and round once
        # to the io dtype, as dot_general without preferred_element_type
        dxn = (dq @ wq.t() + dk @ wk.t() + dv @ wv.t()).float()
        dwq = (xn.t() @ dq).to(wq.dtype)
        dwk = (xn.t() @ dk).to(wk.dtype)
        dwv = (xn.t() @ dv).to(wv.dtype)
        xf = x2d.float()
        xhat = xf * inv
        dwn = (dxn * xhat).sum(0).to(wn.dtype)
        # rmsnorm backward: dx = inv * g - x * inv^3 * mean(g * x)
        gx = dxn * wn.float()
        dot = torch.mean(gx * xf, dim=-1, keepdim=True)
        dx = (inv * gx - xf * inv ** 3 * dot).to(dt)
        return dx, dwn, dwq, dwk, dwv, None


class FusedMLP(torch.autograd.Function):
    """``_mlp_gated_fwd`` / ``_mlp_gated_bwd`` over ``[T, d]`` rows: the
    forward is the fused kernel pair; the backward recomputes the gate
    and up products in the io dtype (fp32 accumulation), as the JAX
    package does, instead of saving the ``[T, f]`` intermediates."""

    @staticmethod
    def forward(ctx, x2d, w_gate, w_up, w_down):
        ctx.save_for_backward(x2d, w_gate, w_up, w_down)
        return mlp_op(x2d, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        x2d, wg, wu, wd = ctx.saved_tensors
        dt = x2d.dtype
        dy = dy.to(dt)
        g = x2d @ wg                                   # recompute
        u = x2d @ wu
        sg = torch.sigmoid(g)
        s = g * sg                                     # silu(g)
        h = s * u
        dh = dy @ wd.t()                               # [T, f]
        dwd = (h.t() @ dy).to(wd.dtype)
        du = dh * s
        dg = ((dh * u) * (sg * (1 + g * (1 - sg)))).to(dt)   # silu'
        dx = dg @ wg.t() + du @ wu.t()
        dwg = (x2d.t() @ dg).to(wg.dtype)
        dwu = (x2d.t() @ du).to(wu.dtype)
        return dx.to(dt), dwg, dwu, dwd


class FusedFFN(torch.autograd.Function):
    """``_ffn_fwd`` / ``_ffn_bwd`` (``fused_block.py:648-672``) over
    ``[T, d]`` rows: the forward is the kernel pair; the backward
    recomputes u = x W1 + b1 (fp32 sum, cast to the io dtype), as the JAX
    package does, with its rounding points: dh, du and dx in the io
    dtype, weight grads from fp32 sums cast to each weight's dtype, bias
    grads summed in fp32.  The activation's derivative is written out in
    fp32 (JAX differentiates it in the io dtype: equal in fp32).  A bias
    may be None (no bias, no gradient)."""

    @staticmethod
    def forward(ctx, x2d, w1, b1, w2, b2, activation):
        ctx.save_for_backward(x2d, w1, b1, w2, b2)
        ctx.activation = activation
        return ffn_op(x2d, w1, b1, w2, b2, activation)

    @staticmethod
    def backward(ctx, dy):
        x2d, w1, b1, w2, b2 = ctx.saved_tensors
        act = ctx.activation
        dt = x2d.dtype
        dy = dy.to(dt)
        u = torch.matmul(x2d.float(), w1.float())
        if b1 is not None:
            u = u + b1.float()
        u = u.to(dt)
        h = _act(act, u)
        dh = dy @ w2.t()                                  # [T, f]
        dw2 = (h.t() @ dy).to(w2.dtype)
        db2 = None if b2 is None else dy.float().sum(0).to(b2.dtype)
        du = (dh.float() * _act_grad(act, u.float())).to(dt)
        dx = du @ w1.t()
        dw1 = (x2d.t() @ du).to(w1.dtype)
        db1 = None if b1 is None else du.float().sum(0).to(b1.dtype)
        return dx.to(dt), dw1, db1, dw2, db2, None


# -- the whole-block decoder kernel (csrc/fused_decoder.cu) ----------------

def record_path(kernel: str, fused: bool):
    """One routing choice in ``paddle_tpu_fused_block_path_total{kernel,
    path}`` (the JAX package's series, ``fused_block.py:208-221``):
    ``path="fused"`` where the CUDA kernel launches, ``"reference"``
    where the plain path runs (a quantized layer, or the CPU)."""
    from paddle_tpu_torch.observability import default_registry
    default_registry().counter(
        "paddle_tpu_fused_block_path_total",
        "fused-block kernel routing chosen at trace time",
        labelnames=("kernel", "path")).labels(
        kernel=kernel, path="fused" if fused else "reference").inc()


def fused_block_tier() -> str:
    """The ``PADDLE_TPU_FUSED_BLOCK`` knob, read at call time
    (``fused_block.py:109-131``): ``"decoder"`` routes eligible Llama
    layers through the whole-block kernel; ``"measured"`` makes that
    choice per shape from the measurement ledger
    (:func:`measured_tier_for`); every other value, unset included, is
    ``"segments"``: the per-segment kernels (fused RMSNorm+QKV, flash,
    fused MLP), which the port runs on every device and every knob value,
    as ``nn/transformer.py`` says of its feed-forward, so JAX's ``off``
    and auto tiers have no counterpart here."""
    env = os.environ.get("PADDLE_TPU_FUSED_BLOCK", "").strip().lower()
    if env in ("decoder", "measured"):
        return env
    return "segments"


# measured_tier_for's answers, by (shape, dtype, backend, ledger file): a
# layer's route never reads the disk after its shape's first call
_MEASURED: dict = {}


def measured_tier_for(shape, dtype) -> str:
    """The ``measured`` tier's route for a decoder activation shape ``(b,
    s, d)`` (``fused_block.py:146-184``): ``"decoder"`` or
    ``"segments"``, whichever the ledger recorded as faster on this
    backend, ``decoder_block_fused`` at ``tier=decoder`` against
    ``decoder_block`` at ``tier=segments`` (the device profiler tags each
    row with the tier it ran at).  A tier without a record does not
    compete; with none the answer is ``"segments"``, the port's
    counterpart of JAX's ``"fused"`` default.  The answer is read once
    per shape and kept (:func:`clear_measured_tiers` forgets them)."""
    from paddle_tpu_torch.observability import calibration
    dtype = str(dtype).replace("torch.", "")
    key = (tuple(int(d) for d in shape), dtype, calibration.backend_tag(),
           calibration.ledger().path)
    tier = _MEASURED.get(key)
    if tier is None:
        model = calibration.CalibratedCostModel()
        times = {}
        for name, op in (("decoder", "decoder_block_fused"),
                         ("segments", "decoder_block")):
            t = model.measured_for(op, shape, dtype, layout=f"tier={name}")
            if t is not None:
                times[name] = t
        tier = min(times, key=times.get) if times else "segments"
        _MEASURED[key] = tier
    return tier


def clear_measured_tiers():
    """Forget :func:`measured_tier_for`'s answers (after new records)."""
    _MEASURED.clear()


# the most scratch one launch may ask for: 5% of an H100's 80 GB
# (T = 65,536 rows at Llama-3-8B width in bf16)
DECODER_WORKSPACE_BUDGET = 4 << 30


def _row_quantum(dtype) -> int:
    """JAX's sublane tile (``fused_block.py:187-190``): 16 rows for
    16-bit types, 8 otherwise."""
    s = str(dtype)
    return 16 if ("bfloat16" in s or "float16" in s) else 8


def _workspace_widths(d, dq, dkv, f):
    """Widths of the block kernel's workspace, each ``[b * s, width]`` in
    the io dtype, in the C entry point's order: the normalised rows, q,
    k, v, the attention output, x2 and h."""
    return (d, dq, dkv, dkv, dq, d, f)


def decoder_workspace_bytes(b, s, d, dq, dkv, f, dtype) -> int:
    """Bytes of the block kernel's workspace."""
    item = 2 if "bfloat16" in str(dtype) else 4
    return b * s * sum(_workspace_widths(d, dq, dkv, f)) * item


def fused_decoder_eligible(b, s, d, dq, dkv, hd, f, dtype="float32") -> bool:
    """The port's gate for the block kernel.  JAX's shape conditions
    (``fused_block.py:810-827``): s a multiple of the row quantum and of
    ``min(128, s)``; d, dq, dkv and f multiples of 128; whole heads and
    GQA groups.  In place of the TPU's 12 MB VMEM budget, what the Hopper
    kernel needs: head_dim 128 (its flash tile's, and the backward's
    flash), s a multiple of 64 (its q and key blocks), float32 or
    bfloat16, and a workspace within ``DECODER_WORKSPACE_BUDGET``.  Its
    shared memory plan is fixed (checked when it compiles) and a
    cooperative grid that cannot be formed raises at launch, so neither
    depends on the shape.  Llama-3-8B width passes at every s it runs;
    JAX's VMEM budget refuses it at every s."""
    q = _row_quantum(dtype)
    if s < q or s % q or s % min(128, s):
        return False
    if d % 128 or dq % 128 or dkv % 128 or f % 128:
        return False
    if hd <= 0 or hd % 128 or dq % hd or dkv % hd:
        return False
    if (dq // hd) % (dkv // hd):
        return False
    if hd != KERNEL_HEAD_DIM or s % 64 or \
            not any(t in str(dtype) for t in ("float32", "bfloat16")):
        return False
    return decoder_workspace_bytes(b, s, d, dq, dkv, f, dtype) <= \
        DECODER_WORKSPACE_BUDGET


def _rope_ref(x, cos, sin):
    """``_rope_ref`` (``fused_block.py:1031-1040``): the half rotation of
    ``[b, s, heads, hd]`` with ``[s, hd // 2]`` tables, in fp32, cast
    back to x's dtype."""
    c = cos[None, :, None, :].float()
    s_ = sin[None, :, None, :].float()
    half = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * c - x2 * s_, x2 * c + x1 * s_],
                     dim=-1).to(x.dtype)


def decoder_reference(x, wn1, wq, wk, wv, rope_cos, rope_sin, wo, wn2, wg,
                      wu, wd, num_heads, num_kv_heads, epsilon=1e-5):
    """``_decoder_reference`` (``fused_block.py:1043-1073``) in plain
    torch with fp32 products: the fused-form norm and projections, RoPE,
    causal attention (``flash_fwd_reference``'s math), the o-projection
    cast to x's dtype, ``x2 = x + .``, norm2 in the fused form (fp32
    multiply by the weight, one cast), the SwiGLU MLP, ``x2 + .``.
    Differentiable in every weight and x; the RoPE tables (rows
    ``[0, s)`` are used) take no gradient."""
    b, s, d = x.shape
    dq = wq.shape[1]
    nh, nkvh = int(num_heads), int(num_kv_heads)
    hd = dq // nh
    q, k, v = qkv_reference(x.reshape(-1, d), wn1, wq, wk, wv, epsilon)
    cos, sin = rope_cos[:s].detach(), rope_sin[:s].detach()
    q = _rope_ref(q.reshape(b, s, nh, hd), cos, sin)
    k = _rope_ref(k.reshape(b, s, nkvh, hd), cos, sin)
    o, _ = flash_fwd_reference(q, k, v.reshape(b, s, nkvh, hd), causal=True)
    h = torch.matmul(o.reshape(-1, dq).float(), wo.float()).to(x.dtype)
    x2 = x + h.reshape(b, s, d)
    xf = x2.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + epsilon)
    xn2 = ((xf * inv) * wn2.float()).to(x.dtype)
    y = mlp_reference(xn2.reshape(-1, d), wg, wu, wd)
    return x2 + y.reshape(b, s, d)


def decoder_segments(x, wn1, wq, wk, wv, rope_cos, rope_sin, wo, wn2, wg,
                     wu, wd, num_heads, num_kv_heads, epsilon=1e-5):
    """The block through the per-segment kernels, at the block's cast
    points: the QKV kernel (its training variant where autograd needs
    it), RoPE, causal attention through
    ``F.scaled_dot_product_attention`` (flash on the card where it is
    eligible), the o-projection as ``torch.matmul`` (JAX computes it
    outside any kernel), the residual add in x's dtype, norm2 as the
    rmsnorm kernel with no residual (the fused form), the MLP kernel
    pair and the residual add.  Each piece is differentiable through its
    own custom VJP: the recompute of ``FusedDecoderBlock``'s backward on
    the card, and the card's route for shapes the block kernel does not
    take."""
    from paddle_tpu_torch.nn import functional as F
    b, s, d = x.shape
    dq = wq.shape[1]
    nh, nkvh = int(num_heads), int(num_kv_heads)
    hd = dq // nh
    q, k, v = F.fused_rmsnorm_qkv(x, wn1, wq, wk, wv, epsilon)
    q = F.apply_rotary_emb(q.reshape(b, s, nh, hd), rope_cos, rope_sin)
    k = F.apply_rotary_emb(k.reshape(b, s, nkvh, hd), rope_cos, rope_sin)
    o = F.scaled_dot_product_attention(q, k, v.reshape(b, s, nkvh, hd),
                                       is_causal=True)
    x2 = x + torch.matmul(o.reshape(b, s, dq), wo)
    xn2, _ = F.rms_norm_residual(x2, wn2, epsilon=epsilon)
    return x2 + F.fused_mlp(xn2, wg, wu, wd)


def fused_decoder_block(x, norm1_weight, wq, wk, wv, rope_cos, rope_sin, wo,
                        norm2_weight, wg, wu, wd, num_heads, num_kv_heads,
                        epsilon=1e-5):
    """One whole Llama decoder block, ``y [b, s, d]`` of x ``[b, s, d]``:
    rmsnorm, QKV, RoPE, causal attention, o-projection + residual,
    rmsnorm, SwiGLU MLP + residual (``fused_block.py:1110``).  Weights
    ``[in, out]``; rope_cos / rope_sin ``[max_pos, head_dim // 2]``
    tables, rows ``[0, s)`` used (the cache-free, offset-0 form).

    On the CPU the plain version.  On the card one launch of the block
    kernel where ``fused_decoder_eligible`` takes the shape and the
    tables have s rows, else the per-segment kernels
    (``decoder_segments``): the API is total, as JAX's is.  x and the
    weights share one dtype, contiguous and 16-byte aligned.  bf16 runs
    the Hopper design (the wgmma / TMA ring and flash forward), fp32 the
    first one; ``fused_decoder_block.launches_by_path`` counts each
    launch under the design that the C entry reports it took.  ``fused_decoder_block.routes`` counts the Llama
    layers routed to the block and to the segments (bumped by
    ``models/llama.py`` on every device)."""
    if x.ndim != 3:
        raise ValueError(f"fused_decoder_block expects [b, s, d], got shape "
                         f"{tuple(x.shape)}")
    args = (x, norm1_weight, wq, wk, wv, rope_cos, rope_sin, wo,
            norm2_weight, wg, wu, wd, num_heads, num_kv_heads, epsilon)
    if x.device.type == "cpu":
        return _build.plain(
            "fused_decoder_block",
            lambda: costs.decoder(x, wq, wk, wg, num_heads),
            decoder_reference, *args)
    what = "fused_decoder_block"
    b, s, d = x.shape
    dq, dkv, f = wq.shape[1], wk.shape[1], wg.shape[1]
    nh, nkvh = int(num_heads), int(num_kv_heads)
    if rope_cos.shape[0] < s or not fused_decoder_eligible(
            b, s, d, dq, dkv, dq // nh, f, x.dtype):
        return decoder_segments(*args)
    if norm1_weight.shape != (d,) or norm2_weight.shape != (d,) or \
            wq.shape != (d, dq) or wk.shape != (d, dkv) or \
            wv.shape != (d, dkv) or wo.shape != (dq, d) or \
            wg.shape != (d, f) or wu.shape != (d, f) or wd.shape != (f, d) \
            or dkv != nkvh * (dq // nh):
        raise ValueError(f"{what}: weight shapes do not agree with x "
                         f"{tuple(x.shape)}, {nh} heads and {nkvh} kv heads")
    _check_cuda(what, dict(x=x, norm1_weight=norm1_weight, wq=wq, wk=wk,
                           wv=wv, wo=wo, norm2_weight=norm2_weight, wg=wg,
                           wu=wu, wd=wd), x.dtype)
    cos = rope_cos[:s].to(device=x.device, dtype=torch.float32).contiguous()
    sin = rope_sin[:s].to(device=x.device, dtype=torch.float32).contiguous()
    T = b * s
    y = torch.empty_like(x)
    ws = [torch.empty((T, n), dtype=x.dtype, device=x.device)
          for n in _workspace_widths(d, dq, dkv, f)]
    lib = _build.library("fused_decoder")
    design = ctypes.c_int(-1)
    err = lib.ptt_fused_decoder(
        _build.DTYPE_CODES[x.dtype],
        *(t.data_ptr() for t in (x, norm1_weight, wq, wk, wv, cos, sin, wo,
                                 norm2_weight, wg, wu, wd, y, *ws)),
        b, s, d, dq, dkv, f, nh, nkvh, float(epsilon), _build.stream_of(x),
        ctypes.byref(design))
    _build.check(lib, err, what)
    _build.charge(what, costs.decoder, x, wq, wk, wg, nh)
    fused_decoder_block.launches += 1
    fused_decoder_block.launches_by_path[GEMM_PATHS[design.value]] += 1
    return y


fused_decoder_block.launches = 0
fused_decoder_block.launches_by_path = dict.fromkeys(GEMM_PATHS, 0)
fused_decoder_block.routes = {"decoder": 0, "segments": 0}


@torch.library.custom_op("ptt::fused_decoder_block", mutates_args=())
def decoder_op(x: T_, wn1: T_, wq: T_, wk: T_, wv: T_, rope_cos: T_,
               rope_sin: T_, wo: T_, wn2: T_, wg: T_, wu: T_, wd: T_,
               num_heads: int, num_kv_heads: int, epsilon: float) -> T_:
    """``fused_decoder_block``."""
    return fused_decoder_block(x, wn1, wq, wk, wv, rope_cos, rope_sin, wo,
                               wn2, wg, wu, wd, num_heads, num_kv_heads,
                               epsilon)


class FusedDecoderBlock(torch.autograd.Function):
    """``_decoder_fwd`` / ``_decoder_bwd`` (``fused_block.py:1086-1107``):
    block-boundary remat.  The forward is ``fused_decoder_block`` (one
    launch of the block kernel on the card) and saves only its inputs;
    the backward recomputes the block from them under autograd
    (``decoder_segments``' kernels on the card, ``decoder_reference`` on
    the CPU) and differentiates that.  The RoPE tables take no
    gradient."""

    @staticmethod
    def forward(ctx, x, wn1, wq, wk, wv, rope_cos, rope_sin, wo, wn2, wg,
                wu, wd, num_heads, num_kv_heads, epsilon):
        ctx.save_for_backward(x, wn1, wq, wk, wv, rope_cos, rope_sin, wo,
                              wn2, wg, wu, wd)
        ctx.config = (num_heads, num_kv_heads, epsilon)
        return decoder_op(x, wn1, wq, wk, wv, rope_cos, rope_sin, wo, wn2,
                          wg, wu, wd, num_heads, num_kv_heads, epsilon)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        tables = (5, 6)
        want = [i for i in range(len(saved))
                if ctx.needs_input_grad[i] and i not in tables]
        leaves = [t.detach().requires_grad_(i in want)
                  for i, t in enumerate(saved)]
        recompute = decoder_reference if dy.device.type == "cpu" \
            else decoder_segments
        with torch.enable_grad():
            y = recompute(*leaves, *ctx.config)
        grads = dict(zip(want, torch.autograd.grad(
            y, [leaves[i] for i in want], dy)))
        return tuple(grads.get(i) for i in range(len(saved))) + \
            (None, None, None)
