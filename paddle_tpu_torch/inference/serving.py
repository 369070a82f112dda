"""Continuous-batching serving engine (``paddle_tpu/inference/
serving.py``): the slot-contiguous engine (``paged_kv=False``, the
default unless ``PADDLE_TPU_PAGED_KV`` is set, as in the JAX package)
and the paged KV engine (``paged_kv=True``), with n-gram speculative
decoding on the paged one.

``add_request`` enqueues; ``step`` admits a queued request into a free
slot or decodes ``steps_per_sync`` tokens for every decoding slot.  The
slot engine prefills a whole prompt at admission, padded to its bucket
at offset 0 into a ``[1, max_len]`` static cache that is then inserted
into the slot's rows.  The paged engine reserves blocks (prefix-cache
hits shared), then advances one prefilling slot by one chunk a step,
alternating with decode so a long prompt cannot stall in-flight
requests.  Greedy by default; ``do_sample`` draws from a
``torch.Generator`` seeded with ``seed``.

The engine follows its model's device.  The JAX package compiles its
programs and donates the caches to them; here the caches are updated in
place, and the model runs eagerly until :meth:`aot_warmup`, which binds
each decode program (the paged decode of ``steps_per_sync`` steps, the
speculative verify, the slot engine's decode, its prefill for every
bucket and its insert) to static buffers: on CUDA one captured CUDA
graph each, replayed, on the CPU the same body on the same buffers.
Positions stay on the device inside a decode (the engine checks the
RoPE bound on the host before it).  Paged prefill chunks run eagerly
and are not padded to a fixed width, so no position past the prompt is
ever written or rotated during prefill.

Quantized serving: ``quant_weights="int8"|"fp8"`` (or the
``PADDLE_TPU_QUANT_WEIGHTS`` knob) converts the model's large Linears to
weight-only ``QuantedLinear`` in place at construction (refcounted;
``close()`` drops the graphs, then restores them), and
``quant_kv="int8"`` (or ``PADDLE_TPU_QUANT_KV``) stores the paged pools
as int8 with fp32 scales, with ``itemsize`` times the blocks by default
(2x in bf16, 4x in fp32).

Not ported yet — each raises ``NotImplementedError``: ``int8_weights``
(the parameter-dict path, which dequantizes every weight each step and
has no kernel), the KV tier (park/resume/handoff, session checkpoints),
fleet roles, program analysis, the router and tracing hooks of
``add_request``, and the persistent compile cache behind
``aot_warmup(cache_only=True)`` (ROADMAP.md, queue 1)."""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.generation import (GenerationConfig, _empty_caches,
                                         _sample)
from paddle_tpu_torch.inference.kv_cache import (BlockAllocator,
                                                 PagedKVPool, PrefixCache,
                                                 SequenceBlocks,
                                                 paged_kv_enabled,
                                                 quant_kv_mode)
from paddle_tpu_torch.jit.static_graph import StaticGraph
from paddle_tpu_torch.quantization.serving import (quant_weights_mode,
                                                   quantize_for_serving,
                                                   restore_from_serving)

__all__ = ["ContinuousBatchingEngine", "RequestStatus", "QueueFullError"]

_ROADMAP = "not ported yet (ROADMAP.md, queue 1, item 1: the rest of the " \
    "serving engine)"


def _unported(name: str):
    """An engine method outside this slice: raises, never falls back."""
    def method(self, *args, **kwargs):
        raise NotImplementedError(f"{name}: {_ROADMAP}")
    method.__name__ = name
    method.__doc__ = f"``{name}`` is not ported yet; raises " \
        "NotImplementedError."
    return method


def _ngram_propose(history: np.ndarray, k: int, max_n: int = 3):
    """Draft up to `k` tokens by matching the tail n-gram of the
    request's own history (prompt + generated) against its most recent
    earlier occurrence ("prompt lookup" decoding; a copy of
    ``serving.py:159-176``).  Returns int32 drafts (possibly fewer than
    k) or None."""
    L = len(history)
    for n in range(min(max_n, L - 1), 0, -1):
        pat = history[L - n:]
        for i in range(L - n - 1, -1, -1):
            if np.array_equal(history[i:i + n], pat):
                cont = history[i + n:i + n + k]
                if len(cont):
                    return np.asarray(cont, np.int32)
    return None


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
    spec_proposed: int = 0          # speculative drafts proposed
    spec_accepted: int = 0          # speculative drafts accepted


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
    "generated", "prefix_tokens_reused", "speculative_accept_rate",
    "spec_proposed", "spec_accepted",
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
    t["speculative_accept_rate"] = (
        req.spec_accepted / req.spec_proposed if req.spec_proposed
        else 0.0)
    t["spec_proposed"] = float(req.spec_proposed)
    t["spec_accepted"] = float(req.spec_accepted)
    for key in TIMING_KEYS:
        t.setdefault(key, 0.0)
    return t


class ContinuousBatchingEngine:
    """Decode over ``slots`` concurrent sequences with slot reuse.  The
    arguments are the JAX engine's; those of features outside the port
    so far raise ``NotImplementedError`` when set to anything but their
    default.  ``paged_kv=None`` reads ``PADDLE_TPU_PAGED_KV`` (unset:
    the slot-contiguous engine)."""

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
                 paged_kv: Optional[bool] = None,
                 kv_block_size: int = 16,
                 num_kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 spec_decode: int = 0,
                 spec_ngram: int = 3,
                 role: str = "mixed",
                 quant_weights: Optional[str] = None,
                 quant_kv: Optional[str] = None,
                 kv_tier=None,
                 auto_park_s: Optional[float] = None):
        # the JAX engine's checks of the knobs (serving.py:386-444),
        # before anything else
        self.paged = paged_kv_enabled() if paged_kv is None \
            else bool(paged_kv)
        kv_quant = quant_kv_mode(quant_kv)
        quant_mode = quant_weights_mode(quant_weights)
        if kv_quant and not self.paged:
            raise ValueError(
                "PADDLE_TPU_QUANT_KV / quant_kv= requires the paged KV "
                "engine (PADDLE_TPU_PAGED_KV=1 or paged_kv=True)")
        self.spec_tokens = max(0, int(spec_decode))
        self._spec_ngram = max(1, int(spec_ngram))
        if self.spec_tokens:
            if not self.paged:
                raise ValueError(
                    "spec_decode requires the paged KV engine "
                    "(paged_kv=True or PADDLE_TPU_PAGED_KV=1)")
            if do_sample:
                raise ValueError(
                    "n-gram speculative decoding is greedy-only "
                    "(accepted tokens must equal step-by-step argmax); "
                    "do_sample=True is incompatible")
        if quant_mode and int8_weights:
            raise ValueError(
                "int8_weights (the legacy param-dict path) and "
                "quant_weights= are mutually exclusive")
        unported = {
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
        self._table = getattr(model.config, "max_position_embeddings", None)
        if self._table is not None and max_len > self._table:
            raise ValueError(
                f"max_len {max_len} exceeds the model's RoPE table "
                f"(max_position_embeddings={self._table})")
        if self.buckets[-1] >= max_len:
            raise ValueError(
                f"largest prefill bucket {self.buckets[-1]} must be < "
                f"max_len {max_len}")

        cfgm = model.config
        if not self.paged:
            # [slots, max_len] caches, and the [1, max_len] one a prefill
            # writes before the insert copies it into its slot
            self._caches = _empty_caches(model, slots, max_len,
                                         self._dtype, self._device)
            self._caches1 = _empty_caches(model, 1, max_len, self._dtype,
                                          self._device)
        else:
            self._block_size = int(kv_block_size)
            if self._block_size < 1:
                raise ValueError(f"kv_block_size must be >= 1, got "
                                 f"{kv_block_size}")
            self._max_blocks = -(-max_len // self._block_size)
            # default pool: every slot can hold a worst-case sequence,
            # plus the reserved scratch block.  Int8 pools hold itemsize
            # times the blocks at the same payload bytes
            # (serving.py:485-490)
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
            self._prefilling: Dict[int, int] = {}   # slot -> next pos
            self._chunk = int(prefill_chunk) if prefill_chunk \
                else min(self.buckets[-1], max_len - 1)
            if not 1 <= self._chunk < max_len:
                raise ValueError(f"prefill_chunk must be in [1, max_len), "
                                 f"got {prefill_chunk}")
            self._interleave_decode = False
        # plain counters (the JAX engine keeps these in its metrics
        # registry): decode_seconds is host wall time of the decode
        # steps, each ending in a device sync, so it also absorbs device
        # work still queued from a preceding prefill
        self.stats = {"prefill_chunks": 0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_seconds": 0.0,
                      "spec_verifies": 0, "spec_rows": 0,
                      "spec_proposed": 0, "spec_accepted": 0}
        # aot_warmup's programs by JAX target name; once warmed, a
        # program that was not captured raises instead of running eagerly
        self._graphs: Dict[str, StaticGraph] = {}
        self._warmed = False

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

    # -- the model programs ----------------------------------------------------
    def _forward(self, ids, bt: np.ndarray, pos: np.ndarray):
        """One eager forward over the pools (a paged prefill chunk): `ids`
        ``[B, S]``, block-table rows `bt` ``[B, max_blocks]`` and per-row
        start positions `pos` ``[B]`` (host arrays, uploaded once).
        Returns fp32 logits ``[B, S, vocab]``; the pools hold the
        chunk's K/V afterwards."""
        dev = self._device
        with torch.inference_mode():
            ids_t = torch.as_tensor(ids).to(dev, torch.long)
            bt_t = torch.from_numpy(np.ascontiguousarray(bt, np.int32)) \
                .to(dev)
            pos_t = torch.from_numpy(np.ascontiguousarray(pos, np.int32)) \
                .to(dev)
            logits, _ = self.model(ids_t, None, self._pool.caches(bt_t),
                                   pos_t)
            return logits.float()

    def _decode_steps(self, caches, toks, pos, active):
        """``steps_per_sync`` decode steps on the device, as
        ``decode_paged`` scans them (``serving.py:739-765``): inactive
        rows keep their token and position.  Returns ``[B, K]``."""
        seq = []
        for _ in range(self.steps_per_sync):
            logits, _ = self.model(toks[:, None], None, caches, pos)
            nxt = _sample(logits[:, -1].float(), self._gen_cfg, self._gen)
            toks = torch.where(active, nxt, toks)
            pos = torch.where(active, pos + 1, pos)
            seq.append(toks)
        return torch.stack(seq, dim=1)

    def _decode_paged_body(self, bt, toks, pos, active):
        return self._decode_steps(self._pool.caches(bt), toks, pos, active)

    def _verify_body(self, bt, toks, pos):
        """Speculative verify (``serving.py:772-778``): one forward over
        ``[last, d1..dk]`` a row, the argmax at every position."""
        logits, _ = self.model(toks, None, self._pool.caches(bt), pos)
        return torch.argmax(logits.float(), dim=-1)

    def _decode_slot_body(self, toks, pos, active):
        return self._decode_steps(self._caches, toks, pos, active)

    def _prefill_slot_body(self, ids, true_len):
        """A bucket-padded prompt at offset 0 into the zeroed
        ``[1, max_len]`` caches; the first token sampled at
        ``true_len - 1`` (``serving.py:651-658``).  Returns ``[1]``."""
        for c in self._caches1:
            c.k.zero_()
            c.v.zero_()
        logits, _ = self.model(ids, None, self._caches1, 0)
        last = logits[0].index_select(0, (true_len - 1).reshape(1))
        return _sample(last.float(), self._gen_cfg, self._gen)

    def _insert_body(self, slot):
        """The prefilled ``[1, max_len]`` caches into row `slot` (a
        ``[1]`` tensor) of the slot caches (``serving.py:660-669``)."""
        for big, one in zip(self._caches, self._caches1):
            big.k.index_copy_(0, slot, one.k)
            big.v.index_copy_(0, slot, one.v)

    def _run(self, target: str, body, **arrays):
        """Run program `target`: through its static graph after
        :meth:`aot_warmup` (a program it did not capture raises), else
        eagerly on freshly uploaded host arrays."""
        with torch.inference_mode():
            g = self._graphs.get(target)
            if g is not None:
                return g(**arrays)
            if self._warmed:
                raise RuntimeError(
                    f"{target} was not captured by aot_warmup (captured: "
                    f"{sorted(self._graphs)})")
            return body(**{k: torch.as_tensor(v).to(self._device)
                           for k, v in arrays.items()})

    def _check_rope(self, rows: List[int], span: int):
        """The RoPE bound of a decode whose positions stay on the device:
        every decoding row writes `span` positions from its head."""
        if self._table is not None and rows:
            hi = int(self._pos[rows].max()) + span
            if hi > self._table:
                raise ValueError(
                    f"RoPE table overflow: position {hi - 1} past the "
                    f"table of {self._table} (max_position_embeddings)")

    def aot_warmup(self, buckets: Optional[Sequence[int]] = None,
                   cache_only: bool = False):
        """Bind the decode programs to static buffers up front, under the
        JAX engine's targets: ``serving.decode`` (both engines; the
        paged one at ``B = slots``, ``steps_per_sync`` steps),
        ``serving.spec_verify`` (with ``spec_decode``), and for the slot
        engine ``serving.insert`` and ``serving.prefill[b]`` for every
        bucket b (or those in `buckets`).  On CUDA each is one captured
        CUDA graph; a capture that fails raises.  From then on the engine
        copies each step's host state into the buffers and replays the
        program; a program that was not captured raises.  Paged prefill
        chunks stay eager.  Returns ``{target: {"seconds", "graph",
        "launches"}}``: the warm-up and capture's seconds, whether a
        graph was captured and the kernel launches one replay makes."""
        if cache_only:
            raise NotImplementedError(
                "aot_warmup(cache_only=True): the persistent compile "
                "cache is not ported yet (ROADMAP.md, queue 1, item 9)")
        self._drop_graphs()
        B, dev = self.slots, self._device
        gen = self._gen if self._gen_cfg.do_sample else None
        rng = self._gen.get_state()
        stats = {}

        def zeros(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        def warm(target, body, inputs, warmup=1):
            g = StaticGraph(body, inputs, f"aot_warmup {target}",
                            generator=gen, warmup=warmup)
            self._graphs[target] = g
            stats[target] = {"seconds": g.seconds,
                             "graph": g.graph is not None,
                             "launches": dict(g.launches)}

        try:
            with torch.inference_mode():
                i64, i32 = torch.long, torch.int32
                if self.paged:
                    # the warm-up's rows are all inactive: every write
                    # lands in the scratch block
                    mb = self._max_blocks
                    warm("serving.decode", self._decode_paged_body,
                         {"bt": zeros((B, mb), i32),
                          "toks": zeros((B,), i64),
                          "pos": zeros((B,), i32),
                          "active": zeros((B,), torch.bool)})
                    if self.spec_tokens:
                        S = self.spec_tokens + 1
                        warm("serving.spec_verify", self._verify_body,
                             {"bt": zeros((B, mb), i32),
                              "toks": zeros((B, S), i64),
                              "pos": zeros((B,), i32)})
                else:
                    # inactive rows write the reserved row max_len - 1
                    warm("serving.decode", self._decode_slot_body,
                         {"toks": zeros((B,), i64),
                          "pos": zeros((B,), i32, self.max_len - 1),
                          "active": zeros((B,), torch.bool)})
                    # plain copies: no warm-up, which would overwrite a
                    # live slot
                    warm("serving.insert", self._insert_body,
                         {"slot": zeros((1,), i64)}, warmup=0)
                    for b in (buckets or self.buckets):
                        warm(f"serving.prefill[{b}]", self._prefill_slot_body,
                             {"ids": zeros((1, b), i64),
                              "true_len": zeros((), i64, b)})
        except BaseException:
            self._drop_graphs()
            if gen is not None:
                # a failed capture leaves a registered generator in
                # capture mode: the engine continues on a fresh one
                self._gen = torch.Generator(device=dev)
                self._gen.set_state(rng)
            raise
        self._warmed = True
        return stats

    def _drop_graphs(self):
        for g in self._graphs.values():
            g.close()
        self._graphs = {}
        self._warmed = False

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
        is full, ``ValueError`` on an empty prompt or one the engine
        could never hold."""
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
        # next steps_per_sync boundary, so budget in whole chunks; a
        # verify writes up to spec_decode draft rows past the head
        span = self._span(max_new_tokens)
        if self.spec_tokens:
            if len(p) + span > self.max_len - 1:
                raise ValueError(
                    f"prompt {len(p)} + max_new {max_new_tokens} + "
                    f"spec_decode={self.spec_tokens} draft headroom "
                    f"exceeds max_len-1 = {self.max_len - 1}")
        elif len(p) + span > self.max_len - 1:
            K = self.steps_per_sync
            raise ValueError(
                f"prompt {len(p)} + max_new {max_new_tokens} (rounded to "
                f"{span} by steps_per_sync={K}) exceeds max_len-1 = "
                f"{self.max_len - 1} (last row is reserved)")
        if not self.paged and len(p) > self.buckets[-1]:
            # the paged engine has no bucket bound: chunked prefill walks
            # any prompt that fits the block budget below
            raise ValueError(f"prompt {len(p)} exceeds largest prefill "
                             f"bucket {self.buckets[-1]}")
        if self.paged:
            # a request the EMPTY pool couldn't hold would starve forever
            worst = -(-(len(p) + span) // self._block_size)
            if worst > self._num_blocks - 1:
                raise ValueError(
                    f"prompt {len(p)} + generation span {span} needs "
                    f"{worst} KV blocks but the pool holds "
                    f"{self._num_blocks - 1}; raise num_kv_blocks")
        rid = self._next_rid
        self._next_rid += 1
        timeout = timeout_s if timeout_s is not None \
            else self._default_timeout
        now = time.perf_counter()
        self._queue.append(_Request(
            rid, p, max_new_tokens, enqueued_at=now,
            deadline=(now + timeout) if timeout is not None else None))
        return rid

    def _span(self, max_new_tokens: int) -> int:
        """Positions a request may write past its prompt."""
        if self.spec_tokens:
            return max_new_tokens + self.spec_tokens
        K = self.steps_per_sync
        return -(-max_new_tokens // K) * K

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

    # -- the slot-contiguous engine ------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(n)

    def _admit(self, slot: int, req: _Request):
        """Prefill `req` padded to its bucket and insert it into `slot`
        (``serving.py:1102-1155``); decode later writes over the pad
        rows.  The request holds its slot from the start, so a prefill
        that raises retires it with status "error" (the JAX engine
        loses it: it is out of the queue and in no slot)."""
        Lp = len(req.prompt)
        Lb = self._bucket(Lp)
        req.admitted_at = time.perf_counter()
        self._active[slot] = req
        ids = np.zeros((1, Lb), np.int64)
        ids[0, :Lp] = req.prompt
        first = self._run(f"serving.prefill[{Lb}]", self._prefill_slot_body,
                          ids=ids, true_len=np.array(Lp, np.int64))
        self._run("serving.insert", self._insert_body,
                  slot=np.array([slot], np.int64))
        first = int(first[0])
        self.stats["prefill_chunks"] += 1
        req.first_token_at = time.perf_counter()
        req.out.append(first)
        self._pos[slot] = Lp
        self._budget[slot] = req.max_new_tokens - 1
        self._last_tok[slot] = first
        if (self.eos is not None and first == self.eos) \
                or self._budget[slot] <= 0:
            self._retire(slot)

    def _step_inner(self) -> bool:
        free = [i for i, r in enumerate(self._active) if r is None]
        if free and self._queue:
            self._admit(free[0], self._queue.popleft())
            return True
        if all(r is None for r in self._active):
            return bool(self._queue)
        t0 = time.perf_counter()
        rows = [i for i, r in enumerate(self._active) if r is not None]
        active = np.zeros((self.slots,), bool)
        active[rows] = True
        # inactive slots decode at the last row with a discarded output:
        # no active sequence can reach row max_len-1
        pos = np.where(active, self._pos, self.max_len - 1).astype(np.int32)
        self._check_rope(rows, self.steps_per_sync)
        toks = self._run("serving.decode", self._decode_slot_body,
                         toks=self._last_tok.astype(np.int64), pos=pos,
                         active=active).cpu().numpy()            # [B, K]
        self._account_decode(t0, rows, toks)
        return True

    def _account_decode(self, t0: float, rows: List[int], toks):
        """Hand each decoding row its K tokens, up to EOS or its budget."""
        K = toks.shape[1]
        self.stats["decode_steps"] += K
        self.stats["decode_seconds"] += time.perf_counter() - t0
        for i in rows:
            req = self._active[i]
            for j in range(K):
                t = int(toks[i, j])
                req.out.append(t)
                self.stats["decode_tokens"] += 1
                self._pos[i] += 1
                self._budget[i] -= 1
                self._last_tok[i] = t
                if (self.eos is not None and t == self.eos) \
                        or self._budget[i] <= 0:
                    # mid-chunk finish: the rest of the chunk's rows are
                    # unreachable for any successor
                    self._retire(i)
                    break

    # -- the paged engine ----------------------------------------------------
    def _admit_paged(self, slot: int, req: _Request) -> bool:
        """Reserve blocks for `slot` (prefix-cache hits arrive as shared
        references — those tokens never prefill again) and mark it
        prefilling.  False on allocator exhaustion: the request stays
        queued."""
        bs = self._block_size
        Lp = len(req.prompt)
        total = Lp + self._span(req.max_new_tokens)
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
        with torch.inference_mode():
            first = int(_sample(logits[:, -1], self._gen_cfg,
                                self._gen)[0])
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

    def _paged_rows(self, decoding: List[int], span: int):
        """The decode's host state: the active mask, and positions and
        block-table rows with the rows not decoding (free or mid-prefill)
        at position 0 over a zeroed row, so their writes land in the
        scratch block."""
        active = np.zeros((self.slots,), bool)
        active[decoding] = True
        self._ensure_writable_span(decoding, span)
        self._check_rope(decoding, span)
        pos = np.where(active, self._pos, 0).astype(np.int32)
        bt = np.where(active[:, None], self._bt, 0).astype(np.int32)
        return active, pos, bt

    def _decode_step_paged(self, decoding: List[int]):
        """``steps_per_sync`` decode steps over every decoding slot, one
        program; tokens come back in one host read."""
        t0 = time.perf_counter()
        active, pos, bt = self._paged_rows(decoding, self.steps_per_sync)
        toks = self._run("serving.decode", self._decode_paged_body, bt=bt,
                         toks=self._last_tok.astype(np.int64), pos=pos,
                         active=active).cpu().numpy()            # [B, K]
        self._account_decode(t0, decoding, toks)

    def _spec_decode_step(self, decoding: List[int]):
        """n-gram speculative decode (``serving.py:1785-1862``): draft
        from each request's own history, verify every row's ``[last,
        d1..dk]`` in one forward, accept the longest draft prefix that
        matches the argmax chain plus one bonus token: greedy-equivalent
        by construction."""
        t0 = time.perf_counter()
        k = self.spec_tokens
        S = k + 1
        toks = np.zeros((self.slots, S), np.int64)
        proposed = np.zeros((self.slots,), np.int64)
        for i in decoding:
            req = self._active[i]
            toks[i, 0] = self._last_tok[i]
            hist = np.concatenate([req.prompt,
                                   np.asarray(req.out, np.int32)])
            draft = _ngram_propose(hist, k, self._spec_ngram)
            if draft is not None:
                n = len(draft)
                toks[i, 1:1 + n] = draft
                toks[i, 1 + n:] = draft[-1]   # static-shape pad; unused
                proposed[i] = n
        _, pos, bt = self._paged_rows(decoding, S)
        greedy = self._run("serving.spec_verify", self._verify_body, bt=bt,
                           toks=toks, pos=pos).cpu().numpy()     # [B, S]
        self.stats["decode_steps"] += 1
        self.stats["spec_verifies"] += 1
        self.stats["spec_rows"] += len(decoding)
        self.stats["decode_seconds"] += time.perf_counter() - t0
        for i in decoding:
            req = self._active[i]
            n = int(proposed[i])
            a = 0
            while a < n and greedy[i, a] == toks[i, a + 1]:
                a += 1
            # a accepted drafts + the bonus token the verify computed at
            # the last validated position (rejected rows' KV is stale
            # but masked: the write head rolls back over it)
            emitted = [int(t) for t in toks[i, 1:1 + a]] + \
                [int(greedy[i, a])]
            req.spec_proposed += n
            req.spec_accepted += a
            self.stats["spec_proposed"] += n
            self.stats["spec_accepted"] += a
            for t in emitted:
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
        if not decoding:
            return True
        if self.spec_tokens:
            self._spec_decode_step(decoding)
        else:
            self._decode_step_paged(decoding)
        return True

    # -- retirement and faults -----------------------------------------------
    def _retire(self, slot: int, status: str = "ok"):
        req = self._active[slot]
        self._active[slot] = None
        if self.paged:
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
        status "error", the caches and block bookkeeping start over (the
        caches zeroed in place, so captured programs stay valid), the
        queue is kept.  ``max_consecutive_errors`` failures in a row
        re-raise (the fault is persistent)."""
        self._error_streak += 1
        for slot, req in enumerate(self._active):
            if req is not None:
                self._retire(slot, status="error")
        with torch.inference_mode():
            if self.paged:
                self._allocator = BlockAllocator(self._num_blocks)
                if self._prefix is not None:
                    self._prefix = PrefixCache(self._block_size,
                                               self._allocator)
                self._pool.reset()
                self._bt[:] = 0
                self._seq = [None] * self.slots
                self._prefilling.clear()
            else:
                for c in self._caches + self._caches1:
                    c.k.zero_()
                    c.v.zero_()
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
            out = self._step_inner_paged() if self.paged \
                else self._step_inner()
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
        """Hand the model back: the captured programs and their buffers
        dropped first (a graph over converted weights must not outlive
        them), then this engine's weight-quantization reference (the
        original Linears return when the last engine holding the
        conversion closes) and train mode if the engine flipped it."""
        self._drop_graphs()
        if self._quant_converted:
            restore_from_serving(self.model)
            self._quant_converted = False
        if self._was_training:
            self.model.train()
            self._was_training = False

    # outside the port so far (ROADMAP.md queue 1, item 1)
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
