"""Continuous-batching serving engine over the paged KV cache
(``paddle_tpu/inference/serving.py``, its ``paged_kv=True`` path).

``add_request`` enqueues; ``step`` either admits a queued request into a
free slot (blocks reserved, prefix-cache hits shared), advances one
prefilling slot by one chunk, or decodes one token for every decoding
slot.  Chunked prefill alternates with decode so a long prompt cannot
stall in-flight requests.  Greedy by default; ``do_sample`` draws from a
``torch.Generator`` seeded with ``seed``.

The engine follows its model's device.  The JAX package compiles one
decode step and one prefill-chunk step and donates the pools to them;
here the model runs eagerly and the pools are updated in place.  Prefill
chunks are not padded to a fixed width (nothing is compiled per shape),
so no position past the prompt is ever written or rotated during
prefill.

Quantized serving: ``quant_weights="int8"|"fp8"`` (or the
``PADDLE_TPU_QUANT_WEIGHTS`` knob) converts the model's large Linears to
weight-only ``QuantedLinear`` in place at construction (refcounted;
``close()`` restores them), and ``quant_kv="int8"`` (or
``PADDLE_TPU_QUANT_KV``) stores the paged pools as int8 with fp32
scales, with ``itemsize`` times the blocks by default (2x in bf16, 4x in
fp32).

Not ported yet — each raises ``NotImplementedError``: the
slot-contiguous engine (``paged_kv=False``), speculative decoding,
``int8_weights`` (the parameter-dict path, which dequantizes every
weight each step and has no kernel), the KV tier (park/resume/handoff),
ahead-of-time warmup, program analysis, and the telemetry/forensics
hooks (ROADMAP.md, queue 1)."""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.generation import GenerationConfig, _sample
from paddle_tpu_torch.inference.kv_cache import (BlockAllocator,
                                                 PagedKVPool, PrefixCache,
                                                 SequenceBlocks,
                                                 quant_kv_mode)
from paddle_tpu_torch.quantization.serving import (quant_weights_mode,
                                                   quantize_for_serving,
                                                   restore_from_serving)

__all__ = ["ContinuousBatchingEngine", "RequestStatus", "QueueFullError"]

_ROADMAP = "not ported yet (ROADMAP.md, queue 1: the rest of the serving " \
    "engine)"


def _unported(name: str):
    """An engine method outside this slice: raises, never falls back."""
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{name}: {_ROADMAP}")
    method.__name__ = name
    method.__doc__ = f"``{name}`` is not ported yet; raises " \
        "NotImplementedError."
    return method


class QueueFullError(RuntimeError):
    """Serving admission queue is at capacity; the request was rejected
    instead of growing the queue without bound."""


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray              # [Lp] int32
    max_new_tokens: int
    out: List[int] = field(default_factory=list)
    enqueued_at: float = 0.0        # perf_counter at add_request
    deadline: Optional[float] = None
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    retired_at: float = 0.0
    prefix_reused: int = 0          # prompt tokens served from the cache


class RequestStatus(str):
    """Terminal status that IS the plain status string (``"ok"`` /
    ``"timeout"`` / ``"error"``) and carries the request's lifecycle
    timings (:data:`TIMING_KEYS`)."""

    def __new__(cls, status: str, timings: Optional[Dict[str, float]]
                = None):
        obj = super().__new__(cls, status)
        obj.timings = dict(timings or {})
        return obj


#: Keys of ``RequestStatus.timings``; every retirement carries all of
#: them (0.0 for a phase never reached).
TIMING_KEYS = (
    "enqueued", "admitted", "first_token", "retired",
    "queue_s", "ttft_s", "prefill_s", "decode_s", "total_s",
    "generated", "prefix_tokens_reused",
)


def _request_timings(req: _Request) -> Dict[str, float]:
    t = {"enqueued": req.enqueued_at, "admitted": req.admitted_at,
         "first_token": req.first_token_at, "retired": req.retired_at}
    if req.admitted_at and req.enqueued_at:
        t["queue_s"] = req.admitted_at - req.enqueued_at
    if req.first_token_at and req.enqueued_at:
        t["ttft_s"] = req.first_token_at - req.enqueued_at
    if req.first_token_at and req.admitted_at:
        t["prefill_s"] = req.first_token_at - req.admitted_at
    if req.retired_at and req.first_token_at:
        t["decode_s"] = req.retired_at - req.first_token_at
    if req.retired_at and req.enqueued_at:
        t["total_s"] = req.retired_at - req.enqueued_at
    t["generated"] = float(len(req.out))
    t["prefix_tokens_reused"] = float(req.prefix_reused)
    for key in TIMING_KEYS:
        t.setdefault(key, 0.0)
    return t


class ContinuousBatchingEngine:
    """Decode over ``slots`` concurrent sequences with slot reuse, over
    the paged KV cache.  The arguments are the JAX engine's; those of
    features outside this slice raise ``NotImplementedError`` when set
    to anything but their default.  ``paged_kv`` defaults to True (the
    only engine ported)."""

    def __init__(self, model, slots: int = 8, max_len: int = 1024,
                 prefill_buckets: Sequence[int] = (32, 64, 128, 256),
                 eos_token_id: Optional[int] = None,
                 int8_weights: bool = False,
                 steps_per_sync: int = 1,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                 analyze: Optional[str] = None,
                 max_queue: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 max_consecutive_errors: int = 3,
                 paged_kv: bool = True,
                 kv_block_size: int = 16,
                 num_kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 spec_decode: int = 0,
                 role: str = "mixed",
                 quant_weights: Optional[str] = None,
                 quant_kv: Optional[str] = None,
                 kv_tier=None,
                 auto_park_s: Optional[float] = None):
        # the JAX engine's checks of the quantization knobs
        # (serving.py:395-398, 440-444), before anything else
        kv_quant = quant_kv_mode(quant_kv)
        quant_mode = quant_weights_mode(quant_weights)
        if kv_quant and not paged_kv:
            raise ValueError(
                "PADDLE_TPU_QUANT_KV / quant_kv= requires the paged KV "
                "engine (paged_kv=True)")
        if quant_mode and int8_weights:
            raise ValueError(
                "int8_weights (the legacy param-dict path) and "
                "quant_weights= are mutually exclusive")
        unported = {
            "paged_kv=False (the slot-contiguous engine)": not paged_kv,
            "spec_decode": bool(spec_decode),
            "int8_weights": bool(int8_weights),
            "kv_tier / auto_park_s": kv_tier is not None
            or auto_park_s is not None,
            "analyze": analyze is not None,
            f"role={role!r} (fleet roles)": role != "mixed",
        }
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"{what}: {_ROADMAP}")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.buckets = sorted(prefill_buckets)
        self.eos = eos_token_id
        # decode steps per host interaction; sequences finishing
        # mid-chunk over-generate < K tokens, truncated on the host
        self.steps_per_sync = max(1, int(steps_per_sync))
        self._gen_cfg = GenerationConfig(do_sample=do_sample,
                                         temperature=temperature,
                                         top_k=top_k, top_p=top_p)
        self.quant_mode = quant_mode
        self.kv_quant = kv_quant
        params = list(model.parameters())
        self._device = params[0].device
        self._dtype = next((p.dtype for p in params
                            if p.is_floating_point()), params[0].dtype)
        self._gen = torch.Generator(device=self._device)
        self._gen.manual_seed(int(seed))
        table = getattr(model.config, "max_position_embeddings", None)
        if table is not None and max_len > table:
            raise ValueError(
                f"max_len {max_len} exceeds the model's RoPE table "
                f"(max_position_embeddings={table})")
        if self.buckets[-1] >= max_len:
            raise ValueError(
                f"largest prefill bucket {self.buckets[-1]} must be < "
                f"max_len {max_len}")

        cfgm = model.config
        self._block_size = int(kv_block_size)
        if self._block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got "
                             f"{kv_block_size}")
        self._max_blocks = -(-max_len // self._block_size)
        # default pool: every slot can hold a worst-case sequence, plus
        # the reserved scratch block.  Int8 pools hold itemsize times the
        # blocks at the same payload bytes (serving.py:485-490)
        ratio = self._dtype.itemsize if kv_quant else 1
        self._num_blocks = int(num_kv_blocks) if num_kv_blocks \
            else 1 + ratio * slots * self._max_blocks
        self._allocator = BlockAllocator(self._num_blocks)
        self._prefix = PrefixCache(self._block_size, self._allocator) \
            if prefix_cache else None
        self._pool = PagedKVPool(
            cfgm.num_hidden_layers, self._num_blocks, self._block_size,
            cfgm.num_key_value_heads, cfgm.head_dim, self._dtype,
            self._device, quant=kv_quant)
        # per-slot block-table rows; 0 = reserved scratch block
        self._bt = np.zeros((slots, self._max_blocks), np.int32)
        self._seq: List[Optional[SequenceBlocks]] = [None] * slots
        self._prefilling: Dict[int, int] = {}   # slot -> next prompt pos
        self._chunk = int(prefill_chunk) if prefill_chunk \
            else min(self.buckets[-1], max_len - 1)
        if not 1 <= self._chunk < max_len:
            raise ValueError(f"prefill_chunk must be in [1, max_len), got "
                             f"{prefill_chunk}")
        self._interleave_decode = False
        # plain counters (the JAX engine keeps these in its metrics
        # registry): decode_seconds is host wall time of the decode
        # steps, each ending in a device sync, so it also absorbs device
        # work still queued from a preceding prefill chunk
        self.stats = {"prefill_chunks": 0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_seconds": 0.0}

        self._pos = np.zeros((slots,), np.int32)       # next write row
        self._active: List[Optional[_Request]] = [None] * slots
        self._budget = np.zeros((slots,), np.int32)    # tokens remaining
        self._last_tok = np.zeros((slots,), np.int32)
        self._queue: deque = deque()
        self._done: deque = deque()
        self._next_rid = 0
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._max_queue = max_queue
        self._default_timeout = request_timeout_s
        self._status: Dict[int, RequestStatus] = {}
        self._error_streak = 0
        self._max_consecutive_errors = max(1, int(max_consecutive_errors))

        # weight-only quantized serving, once every argument has passed:
        # the model's large Linears become QuantedLinear in place
        # (refcounted; close() restores them)
        self._quant_converted = False
        if quant_mode:
            quantize_for_serving(model, quant_mode)
            self._quant_converted = True
        # serving runs the model in eval mode; close() hands it back
        self._was_training = getattr(model, "training", False)
        if self._was_training:
            model.eval()

    # -- the model call ------------------------------------------------------
    def _forward(self, ids, bt: np.ndarray, pos: np.ndarray):
        """One forward over the pools: `ids` ``[B, S]`` (numpy or a device
        tensor), block-table rows `bt` ``[B, max_blocks]`` and per-row
        start positions `pos` ``[B]`` (host arrays: the RoPE bound is
        checked there without a device sync).  Returns fp32 logits
        ``[B, S, vocab]``; the pools hold the step's K/V afterwards."""
        dev = self._device
        with torch.inference_mode():
            ids_t = torch.as_tensor(ids).to(dev, torch.long)
            bt_t = torch.from_numpy(np.ascontiguousarray(bt, np.int32)) \
                .to(dev)
            pos_t = torch.from_numpy(np.ascontiguousarray(pos, np.int32))
            logits, _ = self.model(ids_t, None, self._pool.caches(bt_t),
                                   pos_t)
            return logits.float()

    # -- public API ----------------------------------------------------------
    def add_request(self, prompt_ids, max_new_tokens: int = 64,
                    timeout_s: Optional[float] = None, *,
                    prefill_only: bool = False,
                    handoff: Optional[Dict] = None,
                    router_enqueued_at: Optional[float] = None,
                    span_parent=None) -> int:
        """Enqueue a prompt; returns its request id.  `timeout_s` (or the
        engine's ``request_timeout_s``) is a wall-clock deadline from now:
        a request still queued or decoding past it retires with status
        "timeout".  Raises :class:`QueueFullError` when the bounded queue
        is full, ``ValueError`` on an empty prompt or one the pool could
        never hold."""
        if prefill_only or handoff is not None:
            raise NotImplementedError(
                f"prefill/decode handoff: {_ROADMAP}")
        if router_enqueued_at is not None or span_parent is not None:
            raise NotImplementedError(f"router and tracing hooks: "
                                      f"{_ROADMAP}")
        p = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(p) == 0:
            # the JAX engine accepts an empty prompt and then samples
            # from a pad row (ROADMAP.md, faults)
            raise ValueError("empty prompt: a request needs at least one "
                             "prompt token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1 (the prefill "
                             f"already emits one token); got "
                             f"{max_new_tokens}")
        if self._max_queue is not None and \
                len(self._queue) >= self._max_queue:
            raise QueueFullError(
                f"admission queue at capacity ({self._max_queue}); "
                "retry with backoff or scale out")
        # row max_len-1 stays unreachable; decode over-writes up to the
        # next steps_per_sync boundary, so budget in whole chunks
        K = self.steps_per_sync
        span = -(-max_new_tokens // K) * K
        if len(p) + span > self.max_len - 1:
            raise ValueError(
                f"prompt {len(p)} + max_new {max_new_tokens} (rounded to "
                f"{span} by steps_per_sync={K}) exceeds max_len-1 = "
                f"{self.max_len - 1} (last row is reserved)")
        # a request the EMPTY pool couldn't hold would starve forever
        worst = -(-(len(p) + span) // self._block_size)
        if worst > self._num_blocks - 1:
            raise ValueError(
                f"prompt {len(p)} + generation span {span} needs {worst} "
                f"KV blocks but the pool holds {self._num_blocks - 1}; "
                "raise num_kv_blocks")
        rid = self._next_rid
        self._next_rid += 1
        timeout = timeout_s if timeout_s is not None \
            else self._default_timeout
        now = time.perf_counter()
        self._queue.append(_Request(
            rid, p, max_new_tokens, enqueued_at=now,
            deadline=(now + timeout) if timeout is not None else None))
        return rid

    def finished(self):
        """Yield completed ``(rid, prompt, tokens)`` triples."""
        while self._done:
            yield self._done.popleft()

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(r is not None for r in self._active)

    def request_status(self, rid: int) -> Optional[RequestStatus]:
        """Terminal status of a finished request ("ok", "timeout",
        "error"), None while queued or running."""
        return self._status.get(rid)

    # -- scheduling ----------------------------------------------------------
    def _admit_paged(self, slot: int, req: _Request) -> bool:
        """Reserve blocks for `slot` (prefix-cache hits arrive as shared
        references — those tokens never prefill again) and mark it
        prefilling.  False on allocator exhaustion: the request stays
        queued."""
        bs = self._block_size
        Lp = len(req.prompt)
        K = self.steps_per_sync
        total = Lp + -(-req.max_new_tokens // K) * K
        reuse_bids: List[int] = []
        if self._prefix is not None:
            matched = self._prefix.match(req.prompt)
            # only full blocks strictly before the last prompt token are
            # adopted: the last token always runs (its logits give the
            # first generated token) and lands in a private block
            reuse_bids = matched[:(Lp - 1) // bs]
        need = -(-total // bs) - len(reuse_bids)
        if self._allocator.free_blocks < need and self._prefix is not None:
            self._prefix.evict(need - self._allocator.free_blocks)
        if self._allocator.free_blocks < need:
            return False
        seq = SequenceBlocks(self._allocator, bs)
        seq.adopt_shared(reuse_bids)
        seq.ensure_capacity(total)
        self._seq[slot] = seq
        self._bt[slot, :] = 0
        self._bt[slot, :len(seq.bids)] = seq.bids
        reused = len(reuse_bids) * bs
        req.prefix_reused = reused
        req.admitted_at = time.perf_counter()
        self._active[slot] = req
        self._prefilling[slot] = reused
        return True

    def _prefill_chunk_step(self, slot: int):
        """Advance `slot`'s prefill by one chunk of up to ``prefill_chunk``
        prompt tokens.  The final chunk gives the request's first token
        and registers the prompt's full blocks in the prefix trie."""
        req = self._active[slot]
        start = self._prefilling[slot]
        Lp = len(req.prompt)
        n = min(self._chunk, Lp - start)
        final = start + n == Lp
        logits = self._forward(req.prompt[None, start:start + n],
                               self._bt[slot:slot + 1],
                               np.array([start], np.int32))
        self._prefilling[slot] = start + n
        self.stats["prefill_chunks"] += 1
        if not final:
            return
        first = int(_sample(logits[:, -1], self._gen_cfg, self._gen)[0])
        del self._prefilling[slot]
        if self._prefix is not None:
            # generated tokens are per-request: register the prompt only
            self._prefix.register(req.prompt, self._seq[slot].bids,
                                  limit_tokens=Lp)
        req.first_token_at = time.perf_counter()
        req.out.append(first)
        self._pos[slot] = Lp
        self._budget[slot] = req.max_new_tokens - 1
        self._last_tok[slot] = first
        if (self.eos is not None and first == self.eos) \
                or self._budget[slot] <= 0:
            self._retire(slot)

    def _ensure_writable_span(self, slots_: List[int], span: int):
        """Copy-on-write guard before a step that writes `span` positions
        from each slot's write head: a still-shared block in the span is
        copied to a private one and the block table repointed.  Steady
        state is a no-op (decode blocks are private from admission)."""
        bs = self._block_size
        for i in slots_:
            seq = self._seq[i]
            first = int(self._pos[i]) // bs
            last = min((int(self._pos[i]) + span - 1) // bs,
                       len(seq.bids) - 1)
            for idx in range(first, last + 1):
                if seq.ensure_writable(idx,
                                       self._pool.copy_block) is not None:
                    self._bt[i, idx] = seq.bids[idx]

    def _decode_step_paged(self, decoding: List[int]):
        """``steps_per_sync`` decode steps over every decoding slot, as a
        Python loop; tokens stay on the device until the last step."""
        t0 = time.perf_counter()
        active = np.zeros((self.slots,), bool)
        active[decoding] = True
        K = self.steps_per_sync
        self._ensure_writable_span(decoding, K)
        # rows not decoding (free or mid-prefill) get position 0 and a
        # zeroed table row: their write lands in the scratch block
        pos = np.where(active, self._pos, 0).astype(np.int32)
        bt = np.where(active[:, None], self._bt, 0)
        active_t = torch.from_numpy(active).to(self._device)
        toks = torch.from_numpy(self._last_tok.copy()).to(self._device)
        seq = []
        for _ in range(K):
            logits = self._forward(toks[:, None], bt, pos)
            with torch.inference_mode():
                nxt = _sample(logits[:, -1], self._gen_cfg, self._gen)
                toks = torch.where(active_t, nxt.to(toks.dtype), toks)
            seq.append(toks)
            pos = np.where(active, pos + 1, pos).astype(np.int32)
        out = torch.stack(seq, dim=1).cpu().numpy()    # [B, K]
        self.stats["decode_steps"] += K
        self.stats["decode_seconds"] += time.perf_counter() - t0
        for i in decoding:
            req = self._active[i]
            for j in range(K):
                t = int(out[i, j])
                req.out.append(t)
                self.stats["decode_tokens"] += 1
                self._pos[i] += 1
                self._budget[i] -= 1
                self._last_tok[i] = t
                if (self.eos is not None and t == self.eos) \
                        or self._budget[i] <= 0:
                    self._retire(i)
                    break

    def _step_inner_paged(self) -> bool:
        free = [i for i, r in enumerate(self._active) if r is None]
        if free and self._queue:
            if self._admit_paged(free[0], self._queue[0]):
                self._queue.popleft()
                return True
            # allocator dry: the request stays queued until running
            # slots retire or cached prefixes are evicted
        if all(r is None for r in self._active):
            return bool(self._queue)
        decoding = [i for i, r in enumerate(self._active)
                    if r is not None and i not in self._prefilling]
        # chunked prefill alternates with decode so a long prompt can't
        # stall in-flight requests, and idle decode can't starve TTFT
        do_chunk = bool(self._prefilling) and (
            not decoding or self._interleave_decode)
        self._interleave_decode = not self._interleave_decode
        if do_chunk:
            self._prefill_chunk_step(min(self._prefilling))
            return True
        if decoding:
            self._decode_step_paged(decoding)
        return True

    def _retire(self, slot: int, status: str = "ok"):
        req = self._active[slot]
        self._active[slot] = None
        self._prefilling.pop(slot, None)
        seq = self._seq[slot]
        if seq is not None:
            seq.release()   # shared prefix blocks stay in the trie
        self._seq[slot] = None
        self._bt[slot, :] = 0
        self._finish(req, status)

    def _finish(self, req: _Request, status: str = "ok"):
        req.retired_at = time.perf_counter()
        self._status[req.rid] = RequestStatus(
            status, timings=_request_timings(req))
        while len(self._status) > 8192:   # bounded
            self._status.pop(next(iter(self._status)))
        self._done.append((req.rid, req.prompt, list(req.out)))

    def _expire(self):
        """Retire every request whose deadline has passed, queued or
        running."""
        now = time.perf_counter()
        for slot, req in enumerate(self._active):
            if req is not None and req.deadline is not None \
                    and now > req.deadline:
                self._retire(slot, status="timeout")
        if self._queue:
            keep = deque()
            for req in self._queue:
                if req.deadline is not None and now > req.deadline:
                    self._finish(req, status="timeout")
                else:
                    keep.append(req)
            self._queue = keep

    def _recover(self, exc: Exception):
        """Engine-step failure: every in-flight request retires with
        status "error", the pools and block bookkeeping start over, the
        queue is kept.  ``max_consecutive_errors`` failures in a row
        re-raise (the fault is persistent)."""
        self._error_streak += 1
        for slot, req in enumerate(self._active):
            if req is not None:
                self._retire(slot, status="error")
        self._allocator = BlockAllocator(self._num_blocks)
        if self._prefix is not None:
            self._prefix = PrefixCache(self._block_size, self._allocator)
        self._pool.reset()
        self._bt[:] = 0
        self._seq = [None] * self.slots
        self._prefilling.clear()
        self._pos[:] = 0
        self._budget[:] = 0
        self._last_tok[:] = 0
        if self._error_streak >= self._max_consecutive_errors:
            raise exc

    def step(self) -> bool:
        """One scheduling step; False when nothing is left.  A failing
        step fails the in-flight batch without killing the engine."""
        self._expire()
        try:
            out = self._step_inner_paged()
        except Exception as e:  # noqa: BLE001 — containment boundary
            self._recover(e)
            return bool(self._queue) or \
                any(r is not None for r in self._active)
        self._error_streak = 0
        return out

    def run(self):
        """Drain queue and slots; returns ``{rid: (prompt, tokens)}``."""
        while self.pending:
            self.step()
        return {rid: (p, out) for rid, p, out in self.finished()}

    def close(self):
        """Hand the model back: train mode restored if the engine flipped
        it, and this engine's weight-quantization reference dropped (the
        original Linears return when the last engine holding the
        conversion closes)."""
        if self._quant_converted:
            restore_from_serving(self.model)
            self._quant_converted = False
        if self._was_training:
            self.model.train()
            self._was_training = False

    # outside this slice (ROADMAP.md queue 1)
    aot_warmup = _unported("aot_warmup")
    analyze = _unported("analyze")
    park = _unported("park")
    resume = _unported("resume")
    export_handoff = _unported("export_handoff")
    discard_handoff = _unported("discard_handoff")
    checkpoint_sessions = _unported("checkpoint_sessions")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
