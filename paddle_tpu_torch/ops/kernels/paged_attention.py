"""Paged decode attention — wrappers of the CUDA kernel in
``csrc/paged_attention.cu`` and their plain PyTorch version.

Counterpart of ``paddle_tpu/ops/pallas/paged_attention.py``:
``paged_decode_attention`` replaces ``_decode_kernel`` (fp pools) and,
given ``k_scale``/``v_scale``, hands int8 pools to
``paged_decode_attention_int8``, which replaces ``_decode_kernel_quant``.
A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises.  Each wrapper counts its launches in its own
``launches`` attribute, so a run can show which of the two ran, and in
``launches_by_path`` under the design the C entry reports: ``split``
(rows split across the sequence, the partials merged by the last split
of each row) or ``direct`` (the table fits one split, every row writes
its output at once).

The split count comes from the block table's width alone: the wrapper
sizes the workspace with the C entry's own count (``ptt_paged_splits``),
and :func:`paged_splits` is the tests' model of that rule; the lengths
stay on the device.  Where there is
more than one split a call takes a workspace, ``B * kv_heads * splits *
heads / kv_heads * (head_dim + 2)`` fp32 (1.1 MB at B = 8, 32 / 8 heads,
head_dim 128, 1024-token rows), allocated per call, and one int32 ticket
per (row, kv head), kept per device and zero between launches (the
kernel's merging block resets it), so two launches that share a device
must not run at once on two streams."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops.kernels import _build, costs

__all__ = ["paged_decode_attention", "paged_decode_attention_int8",
           "paged_decode_reference", "paged_splits", "PAGED_PATHS",
           "SPLIT_TOKENS", "record_path"]

# csrc/paged_attention.cu: the designs a launch takes (enum PagedDesign,
# in its order) and the tokens a split covers (kSplitTokens)
PAGED_PATHS = ("split", "direct")
SPLIT_TOKENS = 128

_NEG = -1e30


def paged_splits(max_blocks: int, block_size: int) -> int:
    """The tests' model of the splits of every row of a ``[B,
    max_blocks]`` block table over blocks of ``block_size`` tokens
    (``splits_of`` in the source, which the wrapper asks): a
    split covers ``SPLIT_TOKENS`` tokens rounded down to whole blocks, at
    least one block."""
    per = 1 if block_size >= SPLIT_TOKENS else SPLIT_TOKENS // block_size
    return -(-max_blocks // per)


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
        raise _build.dtype_error(what, q.dtype)
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


def _launch(wrapper, what, entry, q, pools, block_table, lengths, scale):
    """One launch of the C `entry` on checked operands: the pools (and
    int8 scales) in `pools`, the merge's workspace and tickets where the
    table takes more than one split; counts it on `wrapper` under the
    design the entry reports."""
    out = torch.empty_like(q)
    B, h, hd = q.shape
    if not B:
        return out
    _, bs, kvh, _ = pools[0].shape
    mb = block_table.shape[1]
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    lib = _build.library("paged_attention")
    ws = tickets = None
    splits = lib.ptt_paged_splits(mb, bs)
    if splits > 1:
        ws = torch.empty(B * h * splits * (hd + 2), dtype=torch.float32,
                         device=q.device)
        tickets = _build.tickets("paged_attention", q.device, B * kvh)
    design = ctypes.c_int(-1)
    err = getattr(lib, entry)(
        _build.DTYPE_CODES[q.dtype], q.data_ptr(),
        *(t.data_ptr() for t in pools), block_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), B, h, kvh, hd, bs,
        mb, float(scale), _build.stream_of(q), ctypes.byref(design))
    _build.check(lib, err, what)
    _build.charge(what, costs.paged, q, pools[0], block_table, lengths,
                  pools[2] if len(pools) > 2 else None)
    wrapper.launches += 1
    wrapper.launches_by_path[PAGED_PATHS[design.value]] += 1
    return out


def record_path(path: str):
    """One paged attention call in
    ``paddle_tpu_paged_attention_path_total{path}`` (the JAX package's
    series, ``paged_attention.py:73-82``): ``"pallas"`` where the CUDA
    decode kernel launched, ``"fallback"`` for the plain paths."""
    from paddle_tpu_torch.observability import default_registry
    default_registry().counter(
        "paddle_tpu_paged_attention_path_total",
        "paged-attention implementation chosen at trace time",
        labelnames=("path",)).labels(path=path).inc()


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
        return _build.plain(
            "paged_decode_attention",
            lambda: costs.paged(q, k_pool, block_table, lengths),
            paged_decode_reference, q, k_pool, v_pool, block_table, lengths,
            scale)
    what = "paged_decode_attention"
    _check(what, q, k_pool, v_pool, block_table, lengths, {
        "q": (q, q.dtype), "k_pool": (k_pool, q.dtype),
        "v_pool": (v_pool, q.dtype),
        "block_table": (block_table, torch.int32),
        "lengths": (lengths, torch.int32)})
    return _launch(paged_decode_attention, what, "ptt_paged_decode", q,
                   (k_pool, v_pool), block_table, lengths, scale)


paged_decode_attention.launches = 0
paged_decode_attention.launches_by_path = dict.fromkeys(PAGED_PATHS, 0)


def paged_decode_attention_int8(q, k_pool, v_pool, block_table, lengths,
                                k_scale, v_scale, scale=None):
    """:func:`paged_decode_attention` over int8 pools with their fp32
    ``[num_blocks, block_size, kv_heads]`` scales (one per token and kv
    head): every K/V element is dequantized at the load to q's dtype."""
    if k_scale is None or v_scale is None:
        raise ValueError("paged_decode_attention_int8: int8 pools need "
                         "both k_scale and v_scale")
    if q.device.type == "cpu":
        return _build.plain(
            "paged_decode_attention_int8",
            lambda: costs.paged(q, k_pool, block_table, lengths, k_scale),
            paged_decode_reference, q, k_pool, v_pool, block_table, lengths,
            scale, k_scale, v_scale)
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
    return _launch(paged_decode_attention_int8, what,
                   "ptt_paged_decode_quant", q,
                   (k_pool, v_pool, k_scale, v_scale), block_table, lengths,
                   scale)


paged_decode_attention_int8.launches = 0
paged_decode_attention_int8.launches_by_path = dict.fromkeys(PAGED_PATHS, 0)
