"""Paged decode attention — wrapper of the CUDA kernel in
``csrc/paged_attention.cu`` and its plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``
(``_decode_kernel``, fp pools; the int8 variant waits for quantized KV).
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  The wrapper counts its launches in
``paged_decode_attention.launches``."""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["paged_decode_attention", "paged_decode_reference"]

_NEG = -1e30


def paged_decode_reference(q, k_pool, v_pool, block_table, lengths,
                           scale=None):
    """Gather each row's blocks into logical order and attend over
    positions ``< lengths[b]``: fp32 scores and softmax, probabilities
    cast to q's dtype, fp32 accumulation of the product with V."""
    B, h, hd = q.shape
    _, bs, kvh, _ = k_pool.shape
    mb = block_table.shape[1]
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    bt = block_table.long()
    kb = k_pool[bt].reshape(B, mb * bs, kvh, hd)
    vb = v_pool[bt].reshape(B, mb * bs, kvh, hd)
    rep = h // kvh
    kb = torch.repeat_interleave(kb, rep, dim=2).float()   # [B, L, h, hd]
    vb = torch.repeat_interleave(vb, rep, dim=2).float()
    scores = torch.einsum("bhd,blhd->bhl", q.float(), kb) * scale
    live = torch.arange(mb * bs, device=q.device)[None, None, :] < \
        lengths.to(q.device).long()[:, None, None]
    probs = torch.softmax(torch.where(live, scores, _NEG), dim=-1)
    probs = probs.to(q.dtype).float()
    return torch.einsum("bhl,blhd->bhd", probs, vb).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths,
                           scale=None):
    """Single-token attention over paged pools.

    q ``[B, heads, head_dim]`` (RoPE applied); k_pool/v_pool
    ``[num_blocks, block_size, kv_heads, head_dim]``; block_table
    ``[B, max_blocks]`` int32 (scratch block 0 past a row's allocation);
    lengths ``[B]`` int32: row b attends positions ``< lengths[b]``, its
    current token's K/V already written.  Returns ``[B, heads,
    head_dim]`` in q's dtype.  The kernel takes heads / kv_heads in
    {1, 2, 4, 8} and head_dim in {32, 64, 128, 256}."""
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, block_table,
                                      lengths, scale)
    what = "paged_decode_attention"
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
    for name, t, dt in (("q", q, q.dtype), ("k_pool", k_pool, q.dtype),
                        ("v_pool", v_pool, q.dtype),
                        ("block_table", block_table, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if B:
        scale = scale if scale is not None else 1.0 / (hd ** 0.5)
        lib = _build.library("paged_attention")
        err = lib.ptt_paged_decode(
            _build.DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), B, h, kvh, hd, bs, block_table.shape[1],
            float(scale), _build.stream_of(q))
        _build.check(lib, err, what)
        paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
