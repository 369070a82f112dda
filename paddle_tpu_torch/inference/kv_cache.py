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
* The cross-replica KV transfer: :meth:`PagedKVPool.export_blocks` /
  :meth:`~PagedKVPool.import_blocks` (every layer's k/v pools and scales
  gathered with ``index_select`` and scattered with ``index_copy_``,
  converting at the boundary between fp and int8 pools), and the
  handoff wire format, :func:`serialize_handoff` /
  :func:`deserialize_handoff`, byte-compatible with the JAX package's:
  a JSON head and raw little-endian buffers under its dtype names
  (bfloat16 moves as its 16-bit pattern; no ``ml_dtypes``, no pickle),
  so JAX and torch replicas exchange handoffs.  The JAX package pads
  each transfer to a power-of-two block count and compiles the gather
  and scatter for every such count up front (``warm_transfer``), to keep
  XLA compiles out of a handoff; here nothing compiles, so a transfer
  runs eagerly at its exact block count and needs no warm-up.

Torch tensors are mutable, so the pools are updated **in place**
(``index_put_``) where the JAX package returns new pools that its jitted
steps donate (``serving.py:1751-1757``)."""

from __future__ import annotations

import json
import os
import warnings
from collections import OrderedDict, deque
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from paddle_tpu_torch.generation import reject_scalar_mask
from paddle_tpu_torch.nn.functional.attention import \
    scaled_dot_product_attention
from paddle_tpu_torch.ops.kernels.paged_attention import (
    paged_decode_attention, record_path)

__all__ = ["BlockAllocator", "SequenceBlocks", "PrefixCache",
           "PagedKVPool", "PagedCache", "paged_cache_attention",
           "quant_kv_mode", "paged_kv_enabled", "serialize_handoff",
           "deserialize_handoff", "publish_handoff", "fetch_handoff"]


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
    the cache still holds.  ``on_evict(node)``, when set, runs just
    before a victim's block is freed (the KV tier demotes it)."""

    def __init__(self, block_size: int, allocator: BlockAllocator,
                 on_evict=None):
        self.block_size = block_size
        self._alloc = allocator
        self._root = _TrieNode((), -1, None)
        # LRU over nodes: id(node) -> node, most recently used last
        self._lru: "OrderedDict[int, _TrieNode]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.on_evict = on_evict

    def __len__(self):
        return len(self._lru)

    def _touch(self, node: _TrieNode):
        self._lru.move_to_end(id(node))

    @staticmethod
    def node_tokens(node: _TrieNode) -> List[int]:
        """The full token chain (root -> node) of a trie node: the key a
        demoted block is filed under in a lower tier."""
        chunks = []
        while node is not None and node.key:
            chunks.append(node.key)
            node = node.parent
        out: List[int] = []
        for key in reversed(chunks):
            out.extend(int(t) for t in key)
        return out

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
            if self.on_evict is not None:
                try:
                    self.on_evict(victim)
                except Exception:  # noqa: BLE001 — demotion is
                    # best-effort; eviction must free memory regardless
                    pass
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

    # -- cross-replica block transfer (prefill/decode disaggregation) --------
    def export_blocks(self, bids: Sequence[int]) -> dict:
        """Read physical blocks `bids` out of every layer's k/v pool (and
        scales): the payload of a KV handoff or a session park.  Layout
        ``{"block_size", "dtype", "k": [L x [n, bs, kvh, hd]], "v": ...}``
        plus ``"k_scale"`` / ``"v_scale"`` (``[n, bs, kvh]`` fp32 per
        layer) from int8 pools, in the order of `bids`; the tensors stay
        on the pools' device (:func:`serialize_handoff` brings them to
        the host).  A pure read."""
        idx = torch.as_tensor(list(bids), dtype=torch.long).to(
            self.kpools[0].device)
        payload = {"block_size": int(self.block_size),
                   "dtype": _DTYPE_NAMES[self.kpools[0].dtype],
                   "k": [p.index_select(0, idx) for p in self.kpools],
                   "v": [p.index_select(0, idx) for p in self.vpools]}
        if self.quant:
            payload["k_scale"] = [p.index_select(0, idx)
                                  for p in self.kscales]
            payload["v_scale"] = [p.index_select(0, idx)
                                  for p in self.vscales]
        return payload

    def import_blocks(self, payload: dict, dst_bids: Sequence[int],
                      src_start: int = 0):
        """Write exported blocks into this pool at physical ids
        `dst_bids`, starting at the payload's logical block `src_start`
        (a receiver whose prefix cache holds the leading blocks imports
        the tail only).  Raises on a geometry mismatch (block size, kv
        heads, head dim and layer count must agree across the fleet).

        Between precisions the boundary converts, as in the JAX package
        (``kv_cache.py:508-601``): an fp payload into int8 pools is
        quantized row by row (:func:`_quantize_kv`, the write path's
        rule), an int8 payload into fp pools is dequantized with its
        shipped scales; an int8 payload without scales is refused."""
        dst_bids = list(dst_bids)
        if not dst_bids:
            return
        L = len(self.kpools)
        if len(payload["k"]) != L or len(payload["v"]) != L:
            raise ValueError(
                f"handoff payload has {len(payload['k'])}/"
                f"{len(payload['v'])} k/v layers, pool has {L}")
        want = tuple(self.kpools[0].shape[1:])
        got = tuple(payload["k"][0].shape[1:])
        if got != want:
            raise ValueError(
                f"handoff block geometry {got} != pool {want} "
                "(block_size / kv_heads / head_dim must match)")
        if src_start + len(dst_bids) > payload["k"][0].shape[0]:
            raise ValueError(
                f"import of {len(dst_bids)} blocks from offset "
                f"{src_start} exceeds payload of "
                f"{payload['k'][0].shape[0]} blocks")
        src_quant = _tensor(payload["k"][0]).dtype == torch.int8
        if src_quant and ("k_scale" not in payload
                          or "v_scale" not in payload):
            raise ValueError(
                "quantized handoff payload carries no k_scale/v_scale "
                "— refusing to import scaleless int8 KV")
        dev = self.kpools[0].device
        sel = slice(src_start, src_start + len(dst_bids))
        idx = torch.as_tensor(dst_bids, dtype=torch.long).to(dev)

        def part(arrays):
            return [_tensor(a)[sel].to(dev) for a in arrays]

        kdata, vdata = part(payload["k"]), part(payload["v"])
        kscale = vscale = None
        if src_quant:
            kscale, vscale = part(payload["k_scale"]), \
                part(payload["v_scale"])
            if not self.quant:
                # dequantize at the boundary: fp pools receive fp values
                kdata = [d.float() * s.float()[..., None]
                         for d, s in zip(kdata, kscale)]
                vdata = [d.float() * s.float()[..., None]
                         for d, s in zip(vdata, vscale)]
        elif self.quant:
            # quantize at the boundary: the write path's rowwise rule
            kdata, kscale = zip(*(_quantize_kv(d.float()) for d in kdata))
            vdata, vscale = zip(*(_quantize_kv(d.float()) for d in vdata))
        pairs = list(zip(self.kpools + self.vpools,
                         list(kdata) + list(vdata)))
        if self.quant:
            sw = tuple(self.kscales[0].shape[1:])
            sg = tuple(kscale[0].shape[1:])
            if sg != sw:
                raise ValueError(
                    f"handoff scale geometry {sg} != pool {sw}")
            pairs += list(zip(self.kscales + self.vscales,
                              list(kscale) + list(vscale)))
        for pool, vals in pairs:
            pool.index_copy_(0, idx, vals.to(pool.dtype))


# -- handoff wire format -----------------------------------------------------

# the JAX package's dtype names on the wire (numpy's, and ml_dtypes'
# bfloat16 / float8_e4m3fn), for the tensors a payload may carry
_WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "float64": torch.float64,
                "int8": torch.int8, "uint8": torch.uint8,
                "int16": torch.int16, "int32": torch.int32,
                "int64": torch.int64, "bool": torch.bool,
                "float8_e4m3fn": torch.float8_e4m3fn}
_DTYPE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def _tensor(a) -> torch.Tensor:
    """A payload array as a tensor (numpy arrays wrap without a copy)."""
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))


def _wire(a):
    """(dtype name, shape, little-endian bytes) of a payload array; a
    0-d array goes as shape [1], as numpy's ``ascontiguousarray`` sends
    it in the JAX package."""
    if torch.is_tensor(a):
        t = a.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return _DTYPE_NAMES[t.dtype], list(t.shape) or [1], raw
    a = np.ascontiguousarray(a)
    return str(a.dtype), list(a.shape), a.tobytes()


def serialize_handoff(payload: dict) -> bytes:
    """Flatten a handoff payload (scalars, numpy arrays, tensors and the
    nested ``kv`` block export) into one length-prefixed blob, byte for
    byte the JAX package's wire format v2 (``kv_cache.py:625-666``): an
    8-byte big-endian head length, the JSON head (scalars, then each
    array's name, dtype name and shape; ``kv_layers``), then the raw
    buffers.  Int8 exports carry their ``kv.ks<i>`` / ``kv.vs<i>``
    scales and a ``kv_dtype`` scalar."""
    meta: dict = {"version": 2, "scalars": {}, "arrays": []}
    chunks: List[bytes] = []

    def add_array(name, a):
        dtype, shape, raw = _wire(a)
        meta["arrays"].append({"name": name, "dtype": dtype,
                               "shape": shape})
        chunks.append(raw)

    for key, val in payload.items():
        if key == "kv":
            meta["scalars"]["kv_block_size"] = int(val["block_size"])
            meta["kv_layers"] = len(val["k"])
            if "dtype" in val:
                meta["scalars"]["kv_dtype"] = str(val["dtype"])
            for i, a in enumerate(val["k"]):
                add_array(f"kv.k{i}", a)
            for i, a in enumerate(val["v"]):
                add_array(f"kv.v{i}", a)
            for i, a in enumerate(val.get("k_scale") or ()):
                add_array(f"kv.ks{i}", a)
            for i, a in enumerate(val.get("v_scale") or ()):
                add_array(f"kv.vs{i}", a)
        elif isinstance(val, np.ndarray) or torch.is_tensor(val):
            add_array(key, val)
        else:
            meta["scalars"][key] = val
    head = json.dumps(meta).encode()
    return len(head).to_bytes(8, "big") + head + b"".join(chunks)


def _read_array(mv, off: int, dtype: str, shape, as_tensor: bool):
    """One array of the blob: a tensor viewing the buffer (the KV
    blocks) or, for the other fields, a numpy array where numpy has the
    dtype."""
    dt = _WIRE_DTYPES[dtype]
    n = int(np.prod(shape, dtype=np.int64))
    nbytes = n * dt.itemsize
    if not as_tensor and dtype not in ("bfloat16", "float8_e4m3fn"):
        return np.frombuffer(mv[off:off + nbytes],
                             dtype=np.dtype(dtype)).reshape(shape), nbytes
    if n == 0:
        return torch.empty(shape, dtype=dt), nbytes
    with warnings.catch_warnings():
        # the blob is immutable bytes: the view is only ever read
        warnings.simplefilter("ignore", UserWarning)
        t = torch.frombuffer(mv, dtype=dt, count=n, offset=off)
    return t.reshape(shape), nbytes


def deserialize_handoff(data) -> dict:
    """Inverse of :func:`serialize_handoff`, also for the JAX package's
    blobs (v1 and v2).  Accepts any bytes-like object; the KV arrays come
    back as CPU tensors viewing the buffer, the other arrays as numpy
    arrays (tensors for the dtypes numpy lacks)."""
    mv = memoryview(data)
    hlen = int.from_bytes(mv[:8], "big")
    meta = json.loads(bytes(mv[8:8 + hlen]).decode())
    off = 8 + hlen
    arrays: Dict[str, object] = {}
    for ent in meta["arrays"]:
        arrays[ent["name"]], n = _read_array(
            mv, off, ent["dtype"], ent["shape"],
            ent["name"].startswith("kv."))
        off += n
    out: dict = {k: v for k, v in meta["scalars"].items()
                 if k not in ("kv_block_size", "kv_dtype")}
    for name, a in arrays.items():
        if not name.startswith("kv."):
            out[name] = a
    L = meta.get("kv_layers", 0)
    if L:
        out["kv"] = {
            "block_size": int(meta["scalars"]["kv_block_size"]),
            "k": [arrays[f"kv.k{i}"] for i in range(L)],
            "v": [arrays[f"kv.v{i}"] for i in range(L)],
        }
        if "kv_dtype" in meta["scalars"]:
            out["kv"]["dtype"] = meta["scalars"]["kv_dtype"]
        if "kv.ks0" in arrays:
            out["kv"]["k_scale"] = [arrays[f"kv.ks{i}"] for i in range(L)]
            out["kv"]["v_scale"] = [arrays[f"kv.vs{i}"] for i in range(L)]
    return out


def publish_handoff(store, key: str, payload: dict):
    """Ship a serialized handoff through a store of the TCPStore
    contract (the multi-process fleet's transport)."""
    store.set(key, serialize_handoff(payload))


def fetch_handoff(store, key: str) -> Optional[dict]:
    """A handoff published by :func:`publish_handoff`; None when the key
    is absent."""
    if not store.check(key):
        return None
    return deserialize_handoff(store.get(key, wait=False))


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
    applied.  ``position_offset``: int, a 0-d integer tensor, a ``[B]``
    integer tensor of per-row offsets (continuous batching, speculative
    verify), or a ``[B, s]`` integer tensor of every token's position
    (the fixed-width prefill chunk); a tensor on the pools' device is
    used there as it is, never read on the host.  Returns
    ``(out, cache)``; the cache's pools now hold the step's k/v."""
    B, S = q.shape[0], q.shape[1]
    kp, vp, bt = cache.k, cache.v, cache.block_table
    dev = kp.device
    bs, mb = kp.shape[1], bt.shape[1]
    steps = torch.arange(S, device=dev)
    if torch.is_tensor(position_offset) and position_offset.ndim == 2:
        qpos = position_offset.to(device=dev, dtype=torch.long)  # [B, S]
    elif torch.is_tensor(position_offset):
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
        # JAX's counter (kv_cache.py:806, :816): the CUDA kernel or not
        record_path("pallas" if q.device.type == "cuda" else "fallback")
        lengths = (qpos[:, 0] + 1).to(torch.int32)
        out = paged_decode_attention(q[:, 0], kp, vp, bt, lengths,
                                     k_scale=ksc, v_scale=vsc)
        return out[:, None], cache

    record_path("fallback")
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
