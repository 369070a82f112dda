"""Paged decode attention — wrappers of the CUDA kernels in
``csrc/paged_attention.cu`` and their plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``:
``paged_decode_attention`` replaces ``_decode_kernel`` (fp pools) and,
given ``k_scale``/``v_scale``, hands int8 pools to
``paged_decode_attention_int8``, which replaces ``_decode_kernel_quant``.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  Each wrapper counts its launches in its own
``launches`` attribute, so a run can show which of the two ran."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_int8",
           "paged_decode_reference"]

_NEG = -1e30


def paged_decode_reference(q, k_pool, v_pool, block_table, lengths,
                           scale=None, k_scale=None, v_scale=None):
    """Gather each row's blocks into logical order and attend over
    positions ``< lengths[b]``: fp32 scores and softmax, probabilities
    cast to q's dtype, fp32 accumulation of the product with V.  Int8
    pools (``k_scale``/``v_scale`` given) are dequantized first in the
    TPU kernel's order (``paged_attention.py:110-115``): ``float(int8) *
    scale`` rounded to q's dtype."""
    B, h, hd = q.shape
    _, bs, kvh, _ = k_pool.shape
    mb = block_table.shape[1]
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    bt = block_table.long()
    kb, vb = k_pool[bt], v_pool[bt]
    if k_scale is not None:
        kb = (kb.float() * k_scale[bt][..., None].float()).to(q.dtype)
        vb = (vb.float() * v_scale[bt][..., None].float()).to(q.dtype)
    kb = kb.reshape(B, mb * bs, kvh, hd)
    vb = vb.reshape(B, mb * bs, kvh, hd)
    rep = h // kvh
    kb = torch.repeat_interleave(kb, rep, dim=2).float()   # [B, L, h, hd]
    vb = torch.repeat_interleave(vb, rep, dim=2).float()
    scores = torch.einsum("bhd,blhd->bhl", q.float(), kb) * scale
    live = torch.arange(mb * bs, device=q.device)[None, None, :] < \
        lengths.to(q.device).long()[:, None, None]
    probs = torch.softmax(torch.where(live, scores, _NEG), dim=-1)
    probs = probs.to(q.dtype).float()
    return torch.einsum("bhl,blhd->bhd", probs, vb).to(q.dtype)


def _check(what, q, k_pool, v_pool, block_table, lengths, tensors):
    """The shapes, dtypes, devices and layout the kernels take; raises on
    anything else.  `tensors` maps each operand's name to (tensor,
    expected dtype)."""
    B, h, hd = q.shape
    nb, bs, kvh, hd2 = k_pool.shape
    if v_pool.shape != k_pool.shape or hd2 != hd or \
            block_table.ndim != 2 or block_table.shape[0] != B or \
            lengths.shape != (B,):
        raise ValueError(
            f"{what}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, lengths {tuple(lengths.shape)} "
            "do not agree")
    if h % kvh or h // kvh not in (1, 2, 4, 8) or \
            hd not in (32, 64, 128, 256):
        raise ValueError(f"{what}: heads {h} / kv_heads {kvh} must be 1, 2, "
                         f"4 or 8 and head_dim {hd} one of 32, 64, 128, 256")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {q.dtype} not supported (float32, "
                        "bfloat16)")
    for name, (t, dt) in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths,
                           scale=None, k_scale=None, v_scale=None):
    """Single-token attention over paged pools.

    q ``[B, heads, head_dim]`` (RoPE applied); k_pool/v_pool
    ``[num_blocks, block_size, kv_heads, head_dim]``; block_table
    ``[B, max_blocks]`` int32 (scratch block 0 past a row's allocation);
    lengths ``[B]`` int32: row b attends positions ``< lengths[b]``, its
    current token's K/V already written.  ``k_scale``/``v_scale``
    (``[num_blocks, block_size, kv_heads]`` fp32) mark int8 pools, which
    go to :func:`paged_decode_attention_int8`.  Returns ``[B, heads,
    head_dim]`` in q's dtype.  The kernels take heads / kv_heads in
    {1, 2, 4, 8} and head_dim in {32, 64, 128, 256}."""
    if k_scale is not None or v_scale is not None:
        return paged_decode_attention_int8(q, k_pool, v_pool, block_table,
                                           lengths, k_scale, v_scale, scale)
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, block_table,
                                      lengths, scale)
    what = "paged_decode_attention"
    _check(what, q, k_pool, v_pool, block_table, lengths, {
        "q": (q, q.dtype), "k_pool": (k_pool, q.dtype),
        "v_pool": (v_pool, q.dtype),
        "block_table": (block_table, torch.int32),
        "lengths": (lengths, torch.int32)})
    out = torch.empty_like(q)
    B, h, hd = q.shape
    if B:
        scale = scale if scale is not None else 1.0 / (hd ** 0.5)
        lib = _build.library("paged_attention")
        err = lib.ptt_paged_decode(
            _build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, h, k_pool.shape[2], hd, k_pool.shape[1],
            block_table.shape[1], float(scale), _build.stream_of(q))
        _build.check(lib, err, what)
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_int8(q, k_pool, v_pool, block_table, lengths,
                                k_scale, v_scale, scale=None):
    """:func:`paged_decode_attention` over int8 pools with their fp32
    ``[num_blocks, block_size, kv_heads]`` scales (one per token and kv
    head): every K/V element is dequantized at the load to q's dtype."""
    if k_scale is None or v_scale is None:
        raise ValueError("paged_decode_attention_int8: int8 pools need "
                         "both k_scale and v_scale")
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, block_table,
                                      lengths, scale, k_scale, v_scale)
    what = "paged_decode_attention_int8"
    nb, bs, kvh, _ = k_pool.shape
    if k_scale.shape != (nb, bs, kvh) or v_scale.shape != (nb, bs, kvh):
        raise ValueError(
            f"{what}: scales {tuple(k_scale.shape)}/{tuple(v_scale.shape)} "
            f"must be {(nb, bs, kvh)}")
    _check(what, q, k_pool, v_pool, block_table, lengths, {
        "q": (q, q.dtype), "k_pool": (k_pool, torch.int8),
        "v_pool": (v_pool, torch.int8),
        "k_scale": (k_scale, torch.float32),
        "v_scale": (v_scale, torch.float32),
        "block_table": (block_table, torch.int32),
        "lengths": (lengths, torch.int32)})
    out = torch.empty_like(q)
    B, h, hd = q.shape
    if B:
        scale = scale if scale is not None else 1.0 / (hd ** 0.5)
        lib = _build.library("paged_attention")
        err = lib.ptt_paged_decode_quant(
            _build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
            block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, h,
            kvh, hd, bs, block_table.shape[1], float(scale),
            _build.stream_of(q))
        _build.check(lib, err, what)
        paged_decode_attention_int8.launches += 1
    return out


paged_decode_attention_int8.launches = 0
