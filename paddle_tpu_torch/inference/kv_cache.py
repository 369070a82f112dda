"""Paged KV cache: block allocator, prefix reuse, paged attention
(``paddle_tpu/inference/kv_cache.py``).

* :class:`BlockAllocator`, :class:`SequenceBlocks`, :class:`PrefixCache`
  — host-side bookkeeping, copied from the JAX package: a refcounted
  free list over physical blocks (block 0 is the reserved scratch
  block), one sequence's logical->physical block list with
  copy-on-write, and a trie over full blocks of token ids so requests
  sharing a prompt prefix share its physical blocks.
* :class:`PagedKVPool` — per-layer ``[num_blocks, block_size, kv_heads,
  head_dim]`` k/v pools, in the model's dtype or (``quant="int8"``) as
  int8 with per-layer ``[num_blocks, block_size, kv_heads]`` fp32 scales.
* :func:`paged_cache_attention` — writes the step's k/v through the block
  table (quantized on the way into int8 pools), then attends: decode (one
  token, no mask) through the CUDA paged-decode kernel (its int8 variant
  over int8 pools), chunked prefill over the gathered (and, for int8
  pools, dequantized) table with the plain reference attention.

Torch tensors are mutable, so the pools are updated **in place**
(``index_put_``) where the JAX package returns new pools that its jitted
steps donate (``serving.py:1751-1757``)."""

from __future__ import annotations

import os
from collections import OrderedDict, deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from paddle_tpu_torch.generation import reject_scalar_mask
from paddle_tpu_torch.nn.functional.attention import \
    scaled_dot_product_attention
from paddle_tpu_torch.ops.kernels.paged_attention import \
    paged_decode_attention

__all__ = ["BlockAllocator", "SequenceBlocks", "PrefixCache",
           "PagedKVPool", "PagedCache", "paged_cache_attention",
           "quant_kv_mode", "paged_kv_enabled"]


def paged_kv_enabled(default: bool = False) -> bool:
    """The ``PADDLE_TPU_PAGED_KV`` knob.  Unset -> `default` (off: the
    slot-contiguous engine, as in the JAX package)."""
    raw = os.environ.get("PADDLE_TPU_PAGED_KV")
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def quant_kv_mode(explicit: Optional[str] = None) -> Optional[str]:
    """The KV-quant mode: an explicit value wins, else the
    ``PADDLE_TPU_QUANT_KV`` environment knob.  ``"int8"`` stores the
    paged pools as int8 with fp32 scales (at the same payload bytes, 2x
    the blocks of a bf16 pool, 4x of fp32); None keeps fp pools."""
    raw = explicit if explicit is not None \
        else os.environ.get("PADDLE_TPU_QUANT_KV")
    if raw is None:
        return None
    raw = str(raw).strip().lower()
    if raw in ("", "0", "off", "none", "false"):
        return None
    if raw != "int8":
        raise ValueError(
            f"PADDLE_TPU_QUANT_KV={raw!r}: only int8 is supported "
            "(or unset/0 for fp pools)")
    return raw


def _quantize_kv(x):
    """Symmetric int8 quantization of K/V rows along head_dim: one fp32
    scale per (token, kv head), ``max(|x|, 1e-8) / 127``, values rounded
    half to even and clipped to ±127 (``kv_cache.py:92-102``)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# -- host-side block bookkeeping ---------------------------------------------

class BlockAllocator:
    """Refcounted free list over ``num_blocks`` physical blocks.

    Block 0 is reserved as the **scratch block**: inactive batch rows and
    out-of-range writes are routed there by construction, so it is never
    handed out.  ``free()`` is a decref — the block returns to the free
    list only when the last holder lets go; freeing an unreferenced
    block raises."""

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(f"num_blocks {num_blocks} must exceed the "
                             f"{reserved} reserved scratch block(s)")
        self.num_blocks = num_blocks
        self.reserved = reserved
        self._free: deque = deque(range(reserved, num_blocks))
        self._ref = np.zeros((num_blocks,), np.int64)

    def alloc(self) -> Optional[int]:
        """One block with refcount 1, or None when exhausted (a normal
        serving condition: callers defer or evict)."""
        if not self._free:
            return None
        bid = self._free.popleft()
        self._ref[bid] = 1
        return bid

    def ref(self, bid: int):
        if self._ref[bid] <= 0:
            raise RuntimeError(f"ref of unallocated block {bid}")
        self._ref[bid] += 1

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def free(self, bid: int) -> bool:
        """Decref; True when the block actually returned to the free
        list.  Freeing a block with refcount 0 is a double free."""
        if bid < self.reserved:
            raise RuntimeError(f"free of reserved scratch block {bid}")
        if self._ref[bid] <= 0:
            raise RuntimeError(f"double free of block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
            return True
        return False

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.num_blocks - self.reserved - len(self._free)


class SequenceBlocks:
    """One sequence's logical block list over a shared allocator.  Writes
    go through :meth:`ensure_writable` first: a shared block is copied
    to a private one (copy-on-write) before the caller touches it."""

    def __init__(self, allocator: BlockAllocator, block_size: int):
        self._alloc = allocator
        self.block_size = block_size
        self.bids: List[int] = []

    @property
    def capacity(self) -> int:
        return len(self.bids) * self.block_size

    def adopt_shared(self, bids: Sequence[int]):
        """Append already-allocated blocks, taking a reference on each
        (a prefix-cache hit)."""
        for b in bids:
            self._alloc.ref(b)
            self.bids.append(b)

    def ensure_capacity(self, tokens: int) -> bool:
        """Grow to >= `tokens` capacity.  All-or-nothing: on exhaustion
        nothing is allocated and False returns."""
        need = -(-tokens // self.block_size) - len(self.bids)
        if need <= 0:
            return True
        if self._alloc.free_blocks < need:
            return False
        for _ in range(need):
            self.bids.append(self._alloc.alloc())
        return True

    def fork(self) -> "SequenceBlocks":
        """Share every block with a child (refcount bump, zero copies)."""
        child = SequenceBlocks(self._alloc, self.block_size)
        child.adopt_shared(self.bids)
        return child

    def ensure_writable(self, idx: int,
                        copier: Optional[Callable[[int, int], None]]
                        = None) -> Optional[Tuple[int, int]]:
        """Copy-on-write: if logical block `idx` is shared, allocate a
        private block, run `copier(src, dst)` and swap it in.  Returns
        (src, dst) when a copy happened, None when already private.
        Exhaustion raises: the caller has committed writes already."""
        bid = self.bids[idx]
        if self._alloc.refcount(bid) == 1:
            return None
        new = self._alloc.alloc()
        if new is None:
            raise RuntimeError(
                "allocator exhausted during copy-on-write — size the pool "
                "with COW headroom or evict before writing")
        if copier is not None:
            copier(bid, new)
        self.bids[idx] = new
        self._alloc.free(bid)
        return (bid, new)

    def release(self):
        """Drop every reference (retirement)."""
        for b in self.bids:
            self._alloc.free(b)
        self.bids.clear()


class _TrieNode:
    __slots__ = ("key", "bid", "children", "parent")

    def __init__(self, key, bid, parent):
        self.key = key          # tuple of this block's token ids
        self.bid = bid
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.parent: Optional["_TrieNode"] = parent


class PrefixCache:
    """Trie over full blocks of token ids -> physical block ids.  Two
    requests share a physical block iff their prompts agree on every
    token up to and including that block.  The cache owns one reference
    per registered block; :meth:`evict` releases LRU leaves that only
    the cache still holds."""

    def __init__(self, block_size: int, allocator: BlockAllocator):
        self.block_size = block_size
        self._alloc = allocator
        self._root = _TrieNode((), -1, None)
        # LRU over nodes: id(node) -> node, most recently used last
        self._lru: "OrderedDict[int, _TrieNode]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self):
        return len(self._lru)

    def _touch(self, node: _TrieNode):
        self._lru.move_to_end(id(node))

    def match(self, tokens: np.ndarray) -> List[int]:
        """Physical block ids covering the longest cached full-block
        prefix of `tokens` (possibly empty)."""
        bs = self.block_size
        node, bids = self._root, []
        for i in range(len(tokens) // bs):
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            bids.append(child.bid)
            self._touch(child)
            node = child
        if bids:
            self.hits += 1
        else:
            self.misses += 1
        return bids

    def register(self, tokens: np.ndarray, bids: Sequence[int],
                 limit_tokens: Optional[int] = None) -> int:
        """Insert every full block of `tokens` (up to `limit_tokens`);
        the cache takes its own reference on newly inserted blocks.
        Returns the number of newly registered blocks."""
        bs = self.block_size
        n = len(tokens) if limit_tokens is None else min(limit_tokens,
                                                        len(tokens))
        node, new = self._root, 0
        for i in range(n // bs):
            if i >= len(bids):
                break
            key = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(key, int(bids[i]), node)
                self._alloc.ref(child.bid)
                node.children[key] = child
                self._lru[id(child)] = child
                new += 1
            self._touch(child)
            node = child
        return new

    def evict(self, n_blocks: int = 1) -> int:
        """Release up to `n_blocks` LRU leaf blocks whose refcount is 1
        (cache-only).  Returns blocks actually freed."""
        freed = 0
        while freed < n_blocks:
            victim = None
            for node in self._lru.values():           # oldest first
                if not node.children and \
                        self._alloc.refcount(node.bid) == 1:
                    victim = node
                    break
            if victim is None:
                break
            self._alloc.free(victim.bid)
            victim.parent.children.pop(victim.key, None)
            del self._lru[id(victim)]
            self.evictions += 1
            freed += 1
        return freed


# -- device-side pools -------------------------------------------------------

class PagedKVPool:
    """Per-layer ``[num_blocks, block_size, kv_heads, head_dim]`` k/v
    pools on `device`.  One physical block id addresses the same slice in
    every layer.

    ``quant="int8"`` stores the pools as int8 plus per-layer
    ``kscales``/``vscales`` ``[num_blocks, block_size, kv_heads]`` fp32
    (one scale per token and kv head), block-shaped so they follow the
    same block ids through copy-on-write; `dtype` is then the compute
    dtype the pools dequantize into."""

    def __init__(self, num_layers: int, num_blocks: int, block_size: int,
                 kv_heads: int, head_dim: int, dtype, device,
                 quant: Optional[str] = None):
        if quant not in (None, "int8"):
            raise ValueError(f"PagedKVPool quant={quant!r}: only int8")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.quant = quant
        store = torch.int8 if quant else dtype
        shape = (num_blocks, block_size, kv_heads, head_dim)
        self.kpools = [torch.zeros(shape, dtype=store, device=device)
                       for _ in range(num_layers)]
        self.vpools = [torch.zeros(shape, dtype=store, device=device)
                       for _ in range(num_layers)]
        sshape = (num_blocks, block_size, kv_heads)
        n = num_layers if quant else 0
        self.kscales = [torch.zeros(sshape, dtype=torch.float32,
                                    device=device) for _ in range(n)]
        self.vscales = [torch.zeros(sshape, dtype=torch.float32,
                                    device=device) for _ in range(n)]
        self.cow_copies = 0

    def _all(self):
        return self.kpools + self.vpools + self.kscales + self.vscales

    @property
    def nbytes(self) -> int:
        """Device bytes of the pools and their scales."""
        return sum(p.numel() * p.element_size() for p in self._all())

    def caches(self, block_table) -> List["PagedCache"]:
        """Each layer's :class:`PagedCache` over `block_table`."""
        if not self.quant:
            return [PagedCache(k, v, block_table)
                    for k, v in zip(self.kpools, self.vpools)]
        return [PagedCache(k, v, block_table, ks, vs)
                for k, v, ks, vs in zip(self.kpools, self.vpools,
                                        self.kscales, self.vscales)]

    def copy_block(self, src: int, dst: int):
        """Copy-on-write body: duplicate block `src` into `dst` in every
        layer's k and v pool (and scales), in place."""
        for p in self._all():
            p[dst].copy_(p[src])
        self.cow_copies += 1

    def reset(self):
        for p in self._all():
            p.zero_()


# -- the paged attention path ------------------------------------------------

class PagedCache(NamedTuple):
    """One layer's paged KV view: the pools plus this batch's block table
    ``[B, max_blocks]`` int32 on the pools' device (logical block ->
    physical block id; unallocated entries point at scratch block 0).
    Int8 pools also carry their scales; fp pools leave them None."""
    k: torch.Tensor             # [num_blocks, block_size, kv_heads, hd]
    v: torch.Tensor
    block_table: torch.Tensor   # [B, max_blocks] int32
    k_scale: Optional[torch.Tensor] = None   # [num_blocks, bs, kvh] fp32
    v_scale: Optional[torch.Tensor] = None


def paged_cache_attention(q, k, v, cache: PagedCache, position_offset,
                          attn_mask=None):
    """Write the step's k/v through the block table (in place), then
    attend under the causal bound.

    q/k/v: ``[b, s, heads, head_dim]`` current-step projections, RoPE
    applied.  ``position_offset``: int, a 0-d integer tensor, or a
    ``[B]`` integer tensor of per-row offsets (continuous batching,
    chunked prefill, speculative verify); a tensor on the pools' device
    is used there as it is, never read on the host.  Returns
    ``(out, cache)``; the cache's pools now hold the step's k/v."""
    B, S = q.shape[0], q.shape[1]
    kp, vp, bt = cache.k, cache.v, cache.block_table
    dev = kp.device
    bs, mb = kp.shape[1], bt.shape[1]
    steps = torch.arange(S, device=dev)
    if torch.is_tensor(position_offset):
        # [B] or 0-d; on the pools' device the offsets are read there
        off = position_offset.to(device=dev, dtype=torch.long)
        qpos = (off.reshape(-1, 1) + steps[None]).expand(B, S)  # [B, S]
    else:
        qpos = (int(position_offset) + steps)[None].expand(B, S)
    # logical position -> (physical block, slot).  Positions past the
    # table go to the scratch block explicitly: clamping them into the
    # row's last block would overwrite live KV
    lb = qpos // bs
    bids = torch.gather(bt.long(), 1, lb.clamp(max=mb - 1))
    bids = torch.where(lb < mb, bids, 0)
    slot = qpos % bs
    ksc, vsc = cache.k_scale, cache.v_scale
    if ksc is not None:
        # int8 pools: the step's K/V are quantized on their way in, one
        # scale per (token, kv head) written beside them
        kq, ks_new = _quantize_kv(k)
        vq, vs_new = _quantize_kv(v)
        kp.index_put_((bids, slot), kq)
        vp.index_put_((bids, slot), vq)
        ksc.index_put_((bids, slot), ks_new)
        vsc.index_put_((bids, slot), vs_new)
    else:
        kp.index_put_((bids, slot), k.to(kp.dtype))
        vp.index_put_((bids, slot), v.to(vp.dtype))

    if attn_mask is None and S == 1:
        lengths = (qpos[:, 0] + 1).to(torch.int32)
        out = paged_decode_attention(q[:, 0], kp, vp, bt, lengths,
                                     k_scale=ksc, v_scale=vsc)
        return out[:, None], cache

    # gather the block table back into logical order: [B, mb*bs, kvh, hd]
    idx = bt.long()
    kb, vb = kp[idx], vp[idx]
    if ksc is not None:
        # int8 blocks widen through their scales into q's dtype
        kb = (kb.float() * ksc[idx][..., None]).to(q.dtype)
        vb = (vb.float() * vsc[idx][..., None]).to(q.dtype)
    kb = kb.reshape((B, mb * bs) + tuple(kp.shape[2:]))
    vb = vb.reshape((B, mb * bs) + tuple(vp.shape[2:]))
    kpos = torch.arange(mb * bs, device=dev)
    mask = kpos[None, None, None, :] <= qpos[:, None, :, None]  # [B,1,S,T]
    if attn_mask is not None:
        am = reject_scalar_mask(attn_mask)
        if am.dtype == torch.bool:
            mask = mask & am
        else:
            mask = torch.where(mask, am.float(), -1e30)
    out = scaled_dot_product_attention(q, kb, vb, attn_mask=mask,
                                       is_causal=False)
    return out, cache
