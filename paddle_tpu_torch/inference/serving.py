"""Continuous-batching serving engine (``paddle_tpu/inference/
serving.py``): the slot-contiguous engine (``paged_kv=False``, the
default unless ``PADDLE_TPU_PAGED_KV`` is set, as in the JAX package)
and the paged KV engine (``paged_kv=True``), with n-gram speculative
decoding, fleet roles, the prefill/decode handoff and the KV tier on the
paged one.

``add_request`` enqueues; ``step`` admits a queued request into a free
slot or decodes ``steps_per_sync`` tokens for every decoding slot.  The
slot engine prefills a whole prompt at admission, padded to its bucket
at offset 0 into a ``[1, max_len]`` static cache that is then inserted
into the slot's rows.  The paged engine reserves blocks (prefix-cache
hits shared), then advances one prefilling slot by one chunk a step,
alternating with decode so a long prompt cannot stall in-flight
requests.  Every chunk is one program of fixed width ``prefill_chunk``,
as in the JAX package (``serving.py:722-737``): ids ``[1, C]`` (the
final chunk padded), the slot's block-table row, a ``[1]`` start and the
index of the last real token as a 0-d tensor; the token sampled there is
the request's first.  The pad tokens' K/V land past the prompt, in the
slot's own blocks or the scratch block, never in a block the prefix
trie shares (it holds full prompt blocks only); their RoPE positions
are clamped into the table on the device, and the real positions are
checked on the host.  Greedy by default; ``do_sample`` draws from a
``torch.Generator`` seeded with ``seed``.

The engine follows its model's device.  The JAX package compiles its
programs and donates the caches to them; here the caches are updated in
place, and the model runs eagerly until :meth:`aot_warmup`, which binds
each program (the paged decode of ``steps_per_sync`` steps, the prefill
chunk, the speculative verify, the slot engine's decode, its prefill for
every bucket and its insert) to static buffers: on CUDA one captured
CUDA graph each, replayed, on the CPU the same body on the same buffers.
From then on a program that was not captured raises.  Positions stay on
the device inside a program.

Quantized serving: ``quant_weights="int8"|"fp8"`` (or the
``PADDLE_TPU_QUANT_WEIGHTS`` knob) converts the model's large Linears to
weight-only ``QuantedLinear`` in place at construction (refcounted;
``close()`` drops the graphs, then restores them), and
``quant_kv="int8"`` (or ``PADDLE_TPU_QUANT_KV``) stores the paged pools
as int8 with fp32 scales, with ``itemsize`` times the blocks by default
(2x in bf16, 4x in fp32).

The fleet (the JAX engine's, ``serving.py:61-157, 1157-1643``):
``role=`` marks a replica's tier; ``add_request(prefill_only=True)``
retires a request after its first token with the prompt's KV parked for
:meth:`export_handoff`, and ``add_request(handoff=payload)`` admits one
by importing those blocks (skipping those its own prefix trie holds) and
decoding from ``pos = Lp``; ``kv_tier=`` (a :class:`~paddle_tpu_torch.
inference.kv_tier.KVTierManager`) lets :meth:`park` spill a decoding
session and :meth:`resume` promote it back (or recompute it after a tier
miss), demotes evicted prefix blocks and promotes them at admission;
``auto_park_s`` parks the most patient session when the queue is
slot-starved.  Every step writes the serving metrics, the SLO verdicts,
trace spans and the forensics decisions, and hosts the fault points
``serving.engine_step`` and ``serving.kv_alloc``.

``int8_weights=True`` (``serving.py:178-203``) gives every Linear and
Embedding with at least ``1 << 16`` weight elements the JAX engine's
int8 codes and ``[1, out]`` fp32 scales, bit for bit, in place and
refcounted like ``quant_weights`` (the two exclude each other): the
projections and the lm_head run the quant-matmul kernel (split-K at up
to 16 rows, wgmma past), so decode reads the int8 bytes, and the fused
QKV / MLP kernels are bypassed; the embedding gathers int8 rows.  JAX
rounds the dequantized weight to the model dtype before its product;
the kernel takes the scale on the fp32 sum (ROADMAP.md, queue 3).

The persistent compile cache (``compile_cache.py``): with
``PADDLE_TPU_COMPILE_CACHE=1`` every program of :meth:`aot_warmup` goes
through ``compile_static_cached`` (a hit captures without the counted
warm-up); ``aot_warmup(cache_only=True)`` captures the hits only, and a
program that misses keeps running eagerly (JAX leaves it to ``jit``).
``_recover`` re-warms that way when the cache is on, and never fails the
recovery for it.

Not ported yet — raises ``NotImplementedError``: program analysis
(ROADMAP.md, queue 1, item 10)."""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

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
from paddle_tpu_torch.observability import (DEFAULT_BUCKETS,
                                            default_registry,
                                            flight_recorder)
from paddle_tpu_torch.observability.forensics import (emit_decision,
                                                      observe_retirement)
from paddle_tpu_torch.observability.goodput import slo_targets
from paddle_tpu_torch.observability.tracing import tracer
from paddle_tpu_torch.quantization.serving import (quant_weights_mode,
                                                   quantize_for_serving,
                                                   quantize_int8_weights,
                                                   restore_from_serving)
from paddle_tpu_torch.robustness.faults import (QueueFullError,
                                                fault_fires, fault_point)

__all__ = ["ContinuousBatchingEngine", "RequestStatus", "QueueFullError"]

# decode-token latency lives in the sub-ms..s decade; TTFT keeps the
# wide default upper range
_TOKEN_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                  0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)


def _serving_metrics():
    """Process-wide serving instruments (``serving.py:61-113``)."""
    reg = default_registry()
    return {
        "requests": reg.counter("paddle_tpu_serving_requests_total",
                                "requests enqueued"),
        "admissions": reg.counter("paddle_tpu_serving_admissions_total",
                                  "requests admitted into a slot"),
        "retirements": reg.counter(
            "paddle_tpu_serving_retirements_total",
            "requests retired (eos or budget exhausted)"),
        "tokens": reg.counter("paddle_tpu_serving_tokens_total",
                              "tokens generated (prefill first token + "
                              "decode)"),
        "bucket": reg.counter(
            "paddle_tpu_serving_prefill_bucket_total",
            "prefill admissions per bucket; fit=exact means the prompt "
            "needed no padding", labelnames=("bucket", "fit")),
        "pad_tokens": reg.counter(
            "paddle_tpu_serving_prefill_pad_tokens_total",
            "prompt positions wasted on bucket padding"),
        "ttft": reg.histogram(
            "paddle_tpu_serving_ttft_seconds",
            "time from enqueue to first generated token",
            buckets=DEFAULT_BUCKETS),
        "decode": reg.histogram(
            "paddle_tpu_serving_decode_token_seconds",
            "per-token decode latency (chunk wall time / tokens in "
            "chunk)", buckets=_TOKEN_BUCKETS),
        "steps": reg.counter("paddle_tpu_serving_decode_steps_total",
                             "compiled decode dispatches"),
        "timeouts": reg.counter(
            "paddle_tpu_serving_timeouts_total",
            "requests retired with status=timeout (deadline expired "
            "while queued or decoding)"),
        "rejections": reg.counter(
            "paddle_tpu_serving_rejections_total",
            "requests rejected at admission", labelnames=("reason",)),
        "engine_errors": reg.counter(
            "paddle_tpu_serving_engine_errors_total",
            "engine-step exceptions recovered by failing the in-flight "
            "batch (the engine itself survives)"),
        # one hit/miss verdict per retirement against the TTFT/TPOT
        # targets; observability.goodput folds these into the
        # paddle_tpu_slo_attainment{kind} gauge
        "slo": reg.counter(
            "paddle_tpu_serving_slo_total",
            "retired requests judged against the serving latency "
            "targets", labelnames=("kind", "result")),
    }


def _paged_metrics():
    """Paged-KV instruments (``serving.py:116-156``), registered only by
    the paged engine."""
    reg = default_registry()
    return {
        "prefix_lookups": reg.counter(
            "paddle_tpu_serving_prefix_cache_total",
            "prefix-cache lookups at admission",
            labelnames=("result",)),
        "prefix_tokens": reg.counter(
            "paddle_tpu_serving_prefix_tokens_reused_total",
            "prompt tokens whose prefill was skipped because their "
            "blocks were already in the prefix cache"),
        "evictions": reg.counter(
            "paddle_tpu_serving_kv_evictions_total",
            "prefix-cache blocks evicted under allocator pressure"),
        "cow": reg.counter(
            "paddle_tpu_serving_kv_cow_copies_total",
            "copy-on-write block copies (a shared block was written)"),
        "alloc_failures": reg.counter(
            "paddle_tpu_serving_kv_alloc_failures_total",
            "admissions deferred because the block pool was exhausted "
            "(load shed back into the bounded queue)"),
        "chunks": reg.counter(
            "paddle_tpu_serving_prefill_chunks_total",
            "chunked-prefill dispatches"),
        "spec": reg.counter(
            "paddle_tpu_serving_spec_tokens_total",
            "speculative-decoding draft tokens",
            labelnames=("kind",)),
        "parks": reg.counter(
            "paddle_tpu_serving_session_parks_total",
            "sessions demoted out of HBM (slot freed, KV spilled to "
            "the tier manager)", labelnames=("kind",)),
        "resumes": reg.counter(
            "paddle_tpu_serving_session_resumes_total",
            "parked-session resumes by path: 'promote' re-imported the "
            "tier payload, 'recompute' re-prefilled after a tier miss",
            labelnames=("path",)),
    }


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


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray              # [Lp] int32
    max_new_tokens: int
    out: List[int] = field(default_factory=list)
    enqueued_at: float = 0.0        # perf_counter at add_request
    deadline: Optional[float] = None
    span: Any = None                # root trace span (admission->retire)
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    retired_at: float = 0.0
    prefix_reused: int = 0          # prompt tokens served from the cache
    spec_proposed: int = 0          # speculative drafts proposed
    spec_accepted: int = 0          # speculative drafts accepted
    # fleet routing: "full" is a normal request; "prefill_only" retires
    # after its first token with the prompt KV parked for export;
    # "resume" skips prefill, importing that KV
    mode: str = "full"
    handoff: Optional[dict] = None  # resume payload (blocks + first tok)
    router_t0: Optional[float] = None  # router enqueue (end-to-end TTFT)
    route_s: float = 0.0            # router queue -> slot admission
    handoff_s: float = 0.0          # prefill->decode block transfer
    # session survivability (KV tier): park/resume stamps
    parked_at: float = 0.0          # perf_counter at park (0 = not parked)
    parked_s: float = 0.0           # cumulative wall time spent parked
    resume_at: float = 0.0          # perf_counter at resume() call
    resume_s: float = 0.0           # cumulative resume->decoding latency
    auto_parked: bool = False       # parked by the scheduler, not caller
    # recompute fallback: the client-visible prompt and token budget
    # before the prompt was extended with generated tokens
    orig_prompt: Optional[np.ndarray] = None
    orig_max_new: int = 0


class RequestStatus(str):
    """Terminal status that IS the plain status string (``"ok"`` /
    ``"timeout"`` / ``"error"`` / ``"prefilled"``) and carries the
    request's lifecycle timings (:data:`TIMING_KEYS`) and trace id."""

    def __new__(cls, status: str, timings: Optional[Dict[str, float]]
                = None, trace_id: Optional[str] = None):
        obj = super().__new__(cls, status)
        obj.timings = dict(timings or {})
        obj.trace_id = trace_id
        return obj


#: Keys of ``RequestStatus.timings``; every retirement carries all of
#: them (0.0 for a phase never reached).
TIMING_KEYS = (
    "enqueued", "admitted", "first_token", "retired",
    "queue_s", "ttft_s", "prefill_s", "decode_s", "total_s",
    "generated", "prefix_tokens_reused", "speculative_accept_rate",
    "route_s", "handoff_s", "parked_s", "resume_s",
    "spec_proposed", "spec_accepted",
)

#: Re-emit a starving request's "defer" decision every this many
#: deferred admission attempts (``serving.py:276-281``).
DEFER_EMIT_EVERY = 256


def _request_timings(req: _Request) -> Dict[str, float]:
    """Lifecycle stamps plus the derived durations
    (``serving.py:284-331``)."""
    t = {"enqueued": req.enqueued_at, "admitted": req.admitted_at,
         "first_token": req.first_token_at, "retired": req.retired_at}
    if req.admitted_at and req.enqueued_at:
        t["queue_s"] = req.admitted_at - req.enqueued_at
    # routed requests measure TTFT from the router's enqueue stamp
    origin = req.router_t0 or req.enqueued_at
    if req.first_token_at and origin and req.first_token_at >= origin:
        t["ttft_s"] = req.first_token_at - origin
    if req.first_token_at and req.admitted_at \
            and req.first_token_at >= req.admitted_at:
        # absent for "resume" requests: their first token was sampled
        # on the prefill replica
        t["prefill_s"] = req.first_token_at - req.admitted_at
    if req.retired_at and req.first_token_at:
        # parked wall time is not decode time
        t["decode_s"] = max(
            0.0, req.retired_at - req.first_token_at - req.parked_s)
    if req.retired_at and req.enqueued_at:
        t["total_s"] = req.retired_at - req.enqueued_at
    t["generated"] = float(len(req.out))
    t["prefix_tokens_reused"] = float(req.prefix_reused)
    t["speculative_accept_rate"] = (
        req.spec_accepted / req.spec_proposed if req.spec_proposed
        else 0.0)
    t["route_s"] = float(req.route_s)
    t["handoff_s"] = float(req.handoff_s)
    t["parked_s"] = float(req.parked_s)
    t["resume_s"] = float(req.resume_s)
    t["spec_proposed"] = float(req.spec_proposed)
    t["spec_accepted"] = float(req.spec_accepted)
    for key in TIMING_KEYS:
        t.setdefault(key, 0.0)
    return t


class ContinuousBatchingEngine:
    """Decode over ``slots`` concurrent sequences with slot reuse.  The
    arguments are the JAX engine's; ``analyze`` raises
    ``NotImplementedError`` when set.  ``paged_kv=None`` reads
    ``PADDLE_TPU_PAGED_KV`` (unset: the slot-contiguous engine)."""

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
        # the JAX engine's checks of the knobs (serving.py:386-444,
        # 509-520, 594-596), before anything else
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
        if (kv_tier is not None or auto_park_s is not None) \
                and not self.paged:
            raise ValueError(
                "kv_tier / auto_park_s require the paged KV engine "
                "(paged_kv=True or PADDLE_TPU_PAGED_KV=1)")
        if auto_park_s is not None and kv_tier is None:
            raise ValueError("auto_park_s requires kv_tier=")
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"role must be mixed|prefill|decode, got "
                             f"{role!r}")
        if analyze is not None:
            raise NotImplementedError(
                "analyze: not ported yet (ROADMAP.md, queue 1, item 10: "
                "program analysis)")
        self.model = model
        self.slots = slots
        self.max_len = max_len
        self.buckets = sorted(prefill_buckets)
        self.eos = eos_token_id
        self.role = role
        # decode steps per host interaction; sequences finishing
        # mid-chunk over-generate < K tokens, truncated on the host
        self.steps_per_sync = max(1, int(steps_per_sync))
        self._gen_cfg = GenerationConfig(do_sample=do_sample,
                                         temperature=temperature,
                                         top_k=top_k, top_p=top_p)
        self.quant_mode = quant_mode
        self.int8 = bool(int8_weights)
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
        self._kv_tier = kv_tier
        self._auto_park_s = auto_park_s
        # rid -> (request, tier key): sessions this engine parked and
        # still owns the resume of
        self._parked: Dict[int, tuple] = {}
        # rid -> (request, SequenceBlocks, first token): prefill-only
        # requests' prompt blocks, until export_handoff / discard_handoff
        self._handoff_ready: Dict[int, tuple] = {}
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
            if self._kv_tier is not None and self._prefix is not None:
                # demote-before-free: cold prefix blocks spill to the
                # tier; admission promotes them back
                self._prefix.on_evict = self._demote_prefix_node
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
            self._blocks_used_peak = 0
        # plain counters beside the registry's: decode_seconds is host
        # wall time of the decode steps, each ending in a device sync,
        # so it also absorbs device work still queued from a preceding
        # prefill chunk
        self.stats = {"prefill_chunks": 0, "decode_steps": 0,
                      "decode_tokens": 0, "decode_seconds": 0.0,
                      "spec_verifies": 0, "spec_rows": 0,
                      "spec_proposed": 0, "spec_accepted": 0}
        # aot_warmup's programs by JAX target name; once warmed, a
        # program that was not captured raises instead of running eagerly
        self._graphs: Dict[str, StaticGraph] = {}
        self._eager: set = set()     # cache_only misses: run eagerly
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

        # telemetry: counters and histograms are process-wide; the
        # occupancy gauges are read at scrape time
        self._metrics = _serving_metrics()
        if self.paged:
            self._metrics.update(_paged_metrics())
        self._slo_targets = slo_targets()
        self._recorder = flight_recorder()
        self._tracer = tracer()
        self._emit_decision = emit_decision
        # rid -> deferred admission attempts in this wait
        self._defer_attempts: Dict[int, int] = {}
        reg = default_registry()
        reg.gauge("paddle_tpu_serving_queue_depth",
                  "requests waiting for a slot").set_function(
            lambda q=self._queue: len(q))
        reg.gauge("paddle_tpu_serving_active_slots",
                  "slots currently decoding").set_function(
            lambda a=self._active: sum(r is not None for r in a))
        reg.gauge("paddle_tpu_serving_slots",
                  "slot pool size").set(slots)
        reg.gauge("paddle_tpu_serving_replica_role",
                  "serving role this engine plays in a disaggregated "
                  "fleet (value 1 marks the active role)",
                  labelnames=("role",)).labels(role=role).set(1.0)
        if self.paged:
            # read through the engine: _recover rebuilds the allocator
            reg.gauge("paddle_tpu_serving_kv_blocks_free",
                      "paged KV blocks on the free list").set_function(
                lambda e=self: e._allocator.free_blocks)
            reg.gauge("paddle_tpu_serving_kv_blocks_used",
                      "paged KV blocks held by sequences or the prefix "
                      "cache").set_function(
                lambda e=self: e._allocator.used_blocks)
            reg.gauge("paddle_tpu_serving_prefix_cache_blocks",
                      "blocks registered in the prefix trie"
                      ).set_function(
                lambda e=self: len(e._prefix)
                if e._prefix is not None else 0)
            reg.gauge("paddle_tpu_serving_kv_pool_bytes",
                      "device bytes held by the paged KV pools "
                      "(K/V payload + quant scale arrays)"
                      ).set_function(lambda e=self: e._pool.nbytes)
            reg.gauge("paddle_tpu_serving_sessions_parked",
                      "sessions demoted to the KV tier and awaiting "
                      "resume on this engine").set_function(
                lambda e=self: len(e._parked))

        # weight-only quantized serving, once every argument has passed:
        # the model's large Linears (with int8_weights its embeddings
        # too) are converted in place (refcounted; close() restores them)
        self._quant_converted = False
        if quant_mode:
            quantize_for_serving(model, quant_mode)
            self._quant_converted = True
        elif self.int8:
            quantize_int8_weights(model)
            self._quant_converted = True
        # serving runs the model in eval mode; close() hands it back
        self._was_training = getattr(model, "training", False)
        if self._was_training:
            model.eval()

    # -- the model programs ----------------------------------------------------
    def _prefill_chunk_body(self, ids, bt, start, last_idx):
        """One fixed-width paged prefill chunk (``serving.py:728-737``):
        ids ``[1, C]`` at positions ``start .. start + C - 1`` through
        block-table row `bt` ``[1, max_blocks]``; the token sampled at
        `last_idx` (0-d).  Every position is the chunk's own (a
        ``[1, C]`` tensor): RoPE clamps those past its table, the pools
        take the pad rows at their real positions (past the block
        table: the scratch block).  Returns ``[1]``."""
        pos = start.long()[:, None] + torch.arange(ids.shape[1],
                                                   device=ids.device)
        logits, _ = self.model(ids, None, self._pool.caches(bt), pos)
        last = logits[0].index_select(0, last_idx.reshape(1))
        return _sample(last.float(), self._gen_cfg, self._gen)

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
            if self._warmed and target not in self._eager:
                raise RuntimeError(
                    f"{target} was not captured by aot_warmup (captured: "
                    f"{sorted(self._graphs)})")
            return body(**{k: torch.as_tensor(v).to(self._device)
                           for k, v in arrays.items()})

    def _check_rope(self, rows: List[int], span: int):
        """The RoPE bound of a decode whose positions stay on the device:
        every decoding row writes `span` positions from its head."""
        if self._table is not None and rows:
            self._check_position(int(self._pos[rows].max()) + span)

    def _check_position(self, hi: int):
        """Real positions below `hi` must lie in the RoPE table."""
        if self._table is not None and hi > self._table:
            raise ValueError(
                f"RoPE table overflow: position {hi - 1} past the "
                f"table of {self._table} (max_position_embeddings)")

    def aot_warmup(self, buckets: Optional[Sequence[int]] = None,
                   cache_only: bool = False):
        """Bind the engine's programs to static buffers up front, under
        the JAX engine's targets: ``serving.decode`` (both engines; the
        paged one at ``B = slots``, ``steps_per_sync`` steps), for the
        paged engine ``serving.prefill_chunk`` (every chunk of every
        prompt) and ``serving.spec_verify`` (with ``spec_decode``), and
        for the slot engine ``serving.insert`` and ``serving.prefill[b]``
        for every bucket b (or those in `buckets`).  On CUDA each is one
        captured CUDA graph; a capture that fails raises.  From then on
        the engine copies each step's host state into the buffers and
        replays the program; a program that was not captured raises.
        Returns ``{target: {"seconds", "graph", "launches"}}``: the
        warm-up and capture's seconds, whether a graph was captured and
        the kernel launches one replay makes.  Each program is captured
        under the JAX package's compile spans and records its
        ``CompileInfo`` under its target, moving
        ``paddle_tpu_compile_total{target}`` and the FLOPs / bytes /
        peak gauges (``device_profiler.compile_static``: the first
        warm-up counted by the cost model; ``serving.insert``, which has
        no warm-up, is not counted).

        With the persistent compile cache on, each program is looked up
        first (``compile_cache.compile_static_cached``): a hit captures
        without the counted warm-up and without moving the compile
        counter (``"cached": True`` in its stats), a miss compiles and
        stores its recipe.  ``cache_only=True`` captures the hits only: a
        program that misses is marked eager (``"eager": True``) and runs
        eagerly from then on; with the cache off every program is."""
        from paddle_tpu_torch.compile_cache import compile_static_cached
        self._drop_graphs()
        B, dev = self.slots, self._device
        gen = self._gen if self._gen_cfg.do_sample else None
        rng = self._gen.get_state()
        stats = {}

        def zeros(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        extra = self._cache_extra()

        def warm(target, body, inputs, warmup=1):
            t0 = time.perf_counter()
            g, info, hit = compile_static_cached(
                body, inputs, target, generator=gen, warmup=warmup,
                extra=extra, cache_only=cache_only,
                what=f"aot_warmup {target}")
            if g is None:           # a cache_only miss: runs eagerly
                self._eager.add(target)
                stats[target] = {"seconds": time.perf_counter() - t0,
                                 "graph": False, "launches": {},
                                 "cached": False, "eager": True}
                return
            self._graphs[target] = g
            stats[target] = {"seconds": info.total_s,
                             "graph": g.graph is not None,
                             "launches": dict(g.launches), "cached": hit}

        try:
            with torch.inference_mode():
                i64, i32 = torch.long, torch.int32
                if self.paged:
                    # the warm-ups' rows are all inactive or over a
                    # zeroed table row: every write lands in the scratch
                    # block
                    mb = self._max_blocks
                    warm("serving.decode", self._decode_paged_body,
                         {"bt": zeros((B, mb), i32),
                          "toks": zeros((B,), i64),
                          "pos": zeros((B,), i32),
                          "active": zeros((B,), torch.bool)})
                    warm("serving.prefill_chunk", self._prefill_chunk_body,
                         {"ids": zeros((1, self._chunk), i64),
                          "bt": zeros((1, mb), i32),
                          "start": zeros((1,), i32),
                          "last_idx": zeros((), i64)})
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
        self._eager = set()
        self._warmed = False

    def _cache_extra(self) -> str:
        """Compile-cache key discriminators the inputs' signature cannot
        see (``serving.py:804-817``): sampling config, steps a sync, the
        engine's modes and the model config."""
        from paddle_tpu_torch import compile_cache
        gc = self._gen_cfg
        return (f"model={compile_cache.model_config_tag(self.model)}"
                f"|gc={gc.do_sample}:{gc.temperature}:{gc.top_k}"
                f":{gc.top_p}|K={self.steps_per_sync}"
                f"|int8={int(self.int8)}|paged={int(self.paged)}"
                f"|spec={self.spec_tokens}"
                f"|qw={self.quant_mode or '-'}"
                f"|qkv={self.kv_quant or '-'}")

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
        could never hold.

        Fleet hooks (the paged engine): ``prefill_only=True`` retires the
        request after its first token with status ``"prefilled"`` and
        parks the prompt's KV for :meth:`export_handoff`;
        ``handoff=payload`` admits a request by importing those blocks,
        skipping prefill.  ``router_enqueued_at`` anchors TTFT at the
        router's clock and ``span_parent`` nests the request's span under
        the router's."""
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
        if prefill_only and handoff is not None:
            raise ValueError("prefill_only and handoff are the two ends "
                             "of one transfer; a request can't be both")
        if (prefill_only or handoff is not None) and not self.paged:
            raise ValueError(
                "prefill/decode disaggregation needs the paged KV "
                "engine (paged_kv=True or PADDLE_TPU_PAGED_KV=1)")
        if handoff is not None and \
                int(handoff.get("block_size", self._block_size)) \
                != self._block_size:
            raise ValueError(
                f"handoff block_size {handoff.get('block_size')} != "
                f"engine kv_block_size {self._block_size}")
        if self._max_queue is not None and \
                len(self._queue) >= self._max_queue:
            self._metrics["rejections"].labels(reason="queue_full").inc()
            self._recorder.record("serving.reject", reason="queue_full",
                                  queue_depth=len(self._queue))
            raise QueueFullError(
                f"admission queue at capacity ({self._max_queue}); "
                "retry with backoff or scale out")
        # row max_len-1 stays unreachable; decode over-writes up to the
        # next steps_per_sync boundary, so budget in whole chunks; a
        # verify writes up to spec_decode draft rows past the head
        span = 0 if prefill_only else self._span(max_new_tokens)
        if prefill_only:
            # prefill writes rows 0..Lp-1 only; the decode replica
            # writes the first token
            if len(p) > self.max_len - 1:
                raise ValueError(
                    f"prompt {len(p)} exceeds max_len-1 = "
                    f"{self.max_len - 1} (last row is reserved)")
        elif self.spec_tokens:
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
        req = _Request(
            rid, p, max_new_tokens, enqueued_at=now,
            deadline=(now + timeout) if timeout is not None else None,
            mode=("prefill_only" if prefill_only
                  else "resume" if handoff is not None else "full"),
            handoff=handoff, router_t0=router_enqueued_at)
        # the request's root span, open until retirement; a routed
        # request parents under the router's span
        if span_parent is not None:
            req.span = self._tracer.start_span(
                "serving.request", parent=span_parent, rid=rid,
                prompt_len=len(p), max_new_tokens=max_new_tokens,
                mode=req.mode)
        else:
            req.span = self._tracer.start_span(
                "serving.request", rid=rid, prompt_len=len(p),
                max_new_tokens=max_new_tokens)
        self._queue.append(req)
        self._metrics["requests"].inc()
        ev = dict(rid=rid, prompt_len=len(p),
                  max_new_tokens=max_new_tokens,
                  queue_depth=len(self._queue))
        if req.span.trace_id is not None:
            ev["trace_id"] = req.span.trace_id
        self._recorder.record("serving.enqueue", **ev)
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
        # auto-parked sessions count (the scheduler owes them a resume);
        # caller-parked ones wait for the caller's resume()
        return len(self._queue) + sum(r is not None for r in self._active) \
            + sum(1 for req, _k in self._parked.values()
                  if req.auto_parked)

    def request_status(self, rid: int) -> Optional[RequestStatus]:
        """Terminal status of a finished request ("ok", "timeout",
        "error", "prefilled"), None while queued or running; its
        ``.timings`` carry the lifecycle stamps and ``.trace_id`` joins
        it to the exported trace."""
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
        if req.router_t0 is not None and not req.parked_s:
            req.route_s = req.admitted_at - req.router_t0
        self._active[slot] = req
        ids = np.zeros((1, Lb), np.int64)
        ids[0, :Lp] = req.prompt
        with self._tracer.span("serving.prefill", parent=req.span,
                               rid=req.rid, bucket=Lb, prompt_len=Lp):
            first = self._run(f"serving.prefill[{Lb}]",
                              self._prefill_slot_body, ids=ids,
                              true_len=np.array(Lp, np.int64))
            self._run("serving.insert", self._insert_body,
                      slot=np.array([slot], np.int64))
            first = int(first[0])
        self.stats["prefill_chunks"] += 1
        req.first_token_at = time.perf_counter()
        req.out.append(first)
        m = self._metrics
        m["admissions"].inc()
        m["tokens"].inc()                       # the prefill's first token
        m["bucket"].labels(bucket=str(Lb),
                           fit="exact" if Lp == Lb else "padded").inc()
        if Lb > Lp:
            m["pad_tokens"].inc(Lb - Lp)
        origin = req.router_t0 or req.enqueued_at
        if origin:
            m["ttft"].observe(time.perf_counter() - origin)
        self._recorder.record("serving.admit", rid=req.rid, slot=slot,
                              prompt_len=Lp, bucket=Lb)
        self._pos[slot] = Lp
        self._budget[slot] = req.max_new_tokens - 1
        self._last_tok[slot] = first
        if (self.eos is not None and first == self.eos) \
                or self._budget[slot] <= 0:
            self._retire(slot)

    def _step_inner(self) -> bool:
        fault_point("serving.engine_step",
                    active=sum(r is not None for r in self._active),
                    queued=len(self._queue))
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
        with self._recorder.instrumented("serving.decode"):
            toks = self._run("serving.decode", self._decode_slot_body,
                             toks=self._last_tok.astype(np.int64), pos=pos,
                             active=active).cpu().numpy()        # [B, K]
        self._account_decode(t0, rows, toks)
        return True

    def _account_decode(self, t0: float, rows: List[int], toks):
        """Hand each decoding row its K tokens, up to EOS or its budget,
        with the decode step's span on each request and its metrics."""
        K = toks.shape[1]
        dt = time.perf_counter() - t0
        self.stats["decode_steps"] += K
        self.stats["decode_seconds"] += dt
        for i in rows:
            self._tracer.add_span("serving.decode_step", t0, t0 + dt,
                                  parent=self._active[i].span,
                                  rid=self._active[i].rid, tokens=K)
        emitted = 0
        for i in rows:
            req = self._active[i]
            for j in range(K):
                t = int(toks[i, j])
                req.out.append(t)
                emitted += 1
                self._pos[i] += 1
                self._budget[i] -= 1
                self._last_tok[i] = t
                if (self.eos is not None and t == self.eos) \
                        or self._budget[i] <= 0:
                    # mid-chunk finish: the rest of the chunk's rows are
                    # unreachable for any successor
                    self._retire(i)
                    break
        self.stats["decode_tokens"] += emitted
        m = self._metrics
        m["steps"].inc()
        if emitted:
            m["tokens"].inc(emitted)
            m["decode"].observe(dt / K)

    # -- the paged engine: admission -------------------------------------------
    def _defer(self, req: _Request, need: int, exhausted: bool,
               **fields) -> bool:
        """Allocator dry (or the ``serving.kv_alloc`` fault fired): the
        request stays queued; the defer decision is re-emitted every
        :data:`DEFER_EMIT_EVERY` attempts."""
        self._metrics["alloc_failures"].inc()
        self._recorder.record(
            "serving.kv_alloc_exhausted", rid=req.rid, need=need,
            free=self._allocator.free_blocks, injected=bool(exhausted))
        n = self._defer_attempts.get(req.rid, 0) + 1
        self._defer_attempts[req.rid] = n
        if n % DEFER_EMIT_EVERY == 1:
            self._emit_decision(
                "admit", rid=req.rid, chosen="defer",
                reason="kv_alloc_exhausted", **fields, need=need,
                free=self._allocator.free_blocks,
                injected=bool(exhausted), attempts=n)
        return False

    def _reserve(self, slot: int, req: _Request, need: int):
        """Evict cached prefix blocks under pressure.  Returns (whether
        `need` blocks are free and no fault fired, whether the
        ``serving.kv_alloc`` fault fired)."""
        exhausted = fault_fires("serving.kv_alloc", slot=slot,
                                rid=req.rid, need=need)
        if not exhausted and self._allocator.free_blocks < need and \
                self._prefix is not None:
            self._metrics["evictions"].inc(
                self._prefix.evict(need - self._allocator.free_blocks))
        return not exhausted and self._allocator.free_blocks >= need, \
            exhausted

    def _admit_paged(self, slot: int, req: _Request) -> bool:
        """Reserve blocks for `slot` (prefix-cache hits arrive as shared
        references — those tokens never prefill again; with a KV tier,
        demoted blocks of the chain are promoted first) and mark it
        prefilling.  False on allocator exhaustion: the request stays
        queued."""
        if req.handoff is not None:
            return self._admit_resume(slot, req)
        bs = self._block_size
        Lp = len(req.prompt)
        gen_span = 0 if req.mode == "prefill_only" \
            else self._span(req.max_new_tokens)
        total = Lp + gen_span
        reuse_bids: List[int] = []
        m = self._metrics
        if self._prefix is not None:
            matched = self._prefix.match(req.prompt)
            if self._kv_tier is not None:
                matched = self._promote_prefix_tail(req.prompt, matched)
            # only full blocks strictly before the last prompt token are
            # adopted: the last token always runs (its logits give the
            # first generated token) and lands in a private block
            reuse_bids = matched[:(Lp - 1) // bs]
            m["prefix_lookups"].labels(
                result="hit" if reuse_bids else "miss").inc()
        need = -(-total // bs) - len(reuse_bids)
        ok, exhausted = self._reserve(slot, req, need)
        if not ok:
            return self._defer(req, need, exhausted)
        seq = SequenceBlocks(self._allocator, bs)
        seq.adopt_shared(reuse_bids)
        seq.ensure_capacity(total)
        self._seq[slot] = seq
        self._bt[slot, :] = 0
        self._bt[slot, :len(seq.bids)] = seq.bids
        reused = len(reuse_bids) * bs
        req.prefix_reused = reused
        # a recompute-resumed session keeps its first admission stamp
        req.admitted_at = req.admitted_at or time.perf_counter()
        if req.router_t0 is not None and not req.parked_s:
            req.route_s = req.admitted_at - req.router_t0
        if reused:
            m["prefix_tokens"].inc(reused)
        m["admissions"].inc()
        self._active[slot] = req
        self._prefilling[slot] = reused
        self._blocks_used_peak = max(self._blocks_used_peak,
                                     self._allocator.used_blocks)
        self._recorder.record("serving.admit", rid=req.rid, slot=slot,
                              prompt_len=Lp, prefix_reused=reused,
                              blocks=len(seq.bids))
        self._defer_attempts.pop(req.rid, None)
        self._emit_decision("admit", rid=req.rid, chosen="slot",
                            slot=slot, prefix_reused=reused,
                            blocks=len(seq.bids))
        return True

    def _admit_resume(self, slot: int, req: _Request) -> bool:
        """Admit a handed-off request or session (``serving.py:1248-
        1373``): blocks for the whole span, the payload's KV imported
        past the leading blocks this engine's prefix trie holds, decode
        entered at ``pos = Lp`` (or the session's position).  False on
        allocator exhaustion, as :meth:`_admit_paged`."""
        h = req.handoff
        bs = self._block_size
        Lp = len(req.prompt)
        # session payloads (park/resume, migration) carry the whole
        # decode state; the remaining budget is what they haven't emitted
        session = bool(h.get("session"))
        if session:
            out_prev = [int(t) for t in
                        np.asarray(h["tokens_out"]).reshape(-1)]
            covered = int(h["pos"])
            remaining = req.max_new_tokens - len(out_prev)
        else:
            out_prev = [int(h["first_token"])]
            covered = Lp
            remaining = req.max_new_tokens - 1
        # the span of a fresh admission with the emitted prefix paid
        if self.spec_tokens:
            gen_span = max(0, remaining) + 1 + self.spec_tokens
        else:
            K = self.steps_per_sync
            gen_span = -(-max(1, remaining + 1) // K) * K
        total = covered + gen_span
        m = self._metrics
        reuse_bids: List[int] = []
        if self._prefix is not None:
            matched = self._prefix.match(req.prompt)
            reuse_bids = matched[:(Lp - 1) // bs]
            m["prefix_lookups"].labels(
                result="hit" if reuse_bids else "miss").inc()
        need = -(-total // bs) - len(reuse_bids)
        ok, exhausted = self._reserve(slot, req, need)
        if not ok:
            return self._defer(req, need, exhausted, resume=True)
        seq = SequenceBlocks(self._allocator, bs)
        seq.adopt_shared(reuse_bids)
        seq.ensure_capacity(total)
        nprompt = -(-covered // bs)  # blocks the payload covers
        t0 = time.perf_counter()
        if nprompt > len(reuse_bids):
            with torch.inference_mode():
                self._pool.import_blocks(
                    h["kv"], seq.bids[len(reuse_bids):nprompt],
                    src_start=len(reuse_bids))
        req.handoff_s = float(h.get("transfer_s", 0.0)) \
            + (time.perf_counter() - t0)
        req.route_s = req.route_s or float(h.get("route_s", 0.0))
        self._seq[slot] = seq
        self._bt[slot, :] = 0
        self._bt[slot, :len(seq.bids)] = seq.bids
        reused = len(reuse_bids) * bs
        req.prefix_reused = reused
        if reused:
            m["prefix_tokens"].inc(reused)
        if self._prefix is not None:
            # imported prompt blocks are as shareable as prefilled ones
            self._prefix.register(req.prompt, seq.bids, limit_tokens=Lp)
        now = time.perf_counter()
        req.admitted_at = req.admitted_at or now
        m["admissions"].inc()
        # the first token was sampled and counted on the originating
        # replica or session: only its stamp carries over
        if not req.first_token_at:
            req.first_token_at = float(h.get("first_token_at") or now)
        req.out = list(out_prev)
        if req.resume_at:
            req.resume_s += now - req.resume_at
            req.resume_at = 0.0
        if session:
            m["resumes"].labels(path="promote").inc()
            last = int(h["last_token"])
        else:
            last = out_prev[-1]
        self._active[slot] = req
        self._pos[slot] = covered
        self._budget[slot] = remaining
        self._last_tok[slot] = last
        self._blocks_used_peak = max(self._blocks_used_peak,
                                     self._allocator.used_blocks)
        self._recorder.record("serving.admit", rid=req.rid, slot=slot,
                              prompt_len=Lp, resume=True,
                              session=session, pos=covered,
                              prefix_reused=reused,
                              handoff_s=round(req.handoff_s, 6),
                              blocks=len(seq.bids))
        self._defer_attempts.pop(req.rid, None)
        self._emit_decision("admit", rid=req.rid, chosen="slot",
                            slot=slot, resume=True, session=session,
                            pos=covered,
                            handoff_s=round(req.handoff_s, 6))
        if (self.eos is not None and last == self.eos) \
                or self._budget[slot] <= 0:
            self._retire(slot)
        return True

    def export_handoff(self, rid: int) -> Dict:
        """Package a ``"prefilled"`` request's prompt KV for transfer:
        the exported blocks (tensors on the pools' device), the sampled
        first token and the stamps the decode replica's timings need.
        Releases the parked blocks (the prefix trie keeps its own
        references on the prompt's full blocks).  The payload feeds
        ``add_request(handoff=...)`` directly, or
        :func:`~paddle_tpu_torch.inference.kv_cache.serialize_handoff`
        for a byte transport."""
        req, seq, first = self._handoff_ready.pop(rid)
        bs = self._block_size
        Lp = len(req.prompt)
        with torch.inference_mode():
            kv = self._pool.export_blocks(seq.bids[:-(-Lp // bs)])
        payload = {
            "prompt": np.asarray(req.prompt, np.int32),
            "tokens": int(Lp),
            "first_token": int(first),
            "block_size": int(bs),
            "first_token_at": float(req.first_token_at),
            "route_s": float(req.route_s),
            "kv": kv,
        }
        seq.release()
        return payload

    def discard_handoff(self, rid: int):
        """Drop a parked handoff (transfer failed, replica drained);
        tolerates an already-exported or unknown rid."""
        ent = self._handoff_ready.pop(rid, None)
        if ent is not None:
            ent[1].release()

    # -- session tiering -------------------------------------------------------
    def _session_payload(self, slot: int, req: _Request) -> Dict:
        """A decoding slot as a resumable session: KV rows 0..pos-1 plus
        the host-side decode state.  A pure read."""
        bs = self._block_size
        pos = int(self._pos[slot])
        with torch.inference_mode():
            kv = self._pool.export_blocks(self._seq[slot].bids[:-(-pos
                                                                  // bs)])
        return {
            "session": True,
            "prompt": np.asarray(req.prompt, np.int32),
            "tokens_out": np.asarray(req.out, np.int32),
            "pos": int(pos),
            "last_token": int(self._last_tok[slot]),
            "block_size": int(bs),
            "first_token_at": float(req.first_token_at),
            "route_s": float(req.route_s),
            "kv": kv,
        }

    def park(self, rid: int, key: Optional[str] = None,
             detach: bool = False, _auto: bool = False) -> Optional[str]:
        """Demote a decoding session out of the card's memory: its KV
        spills to the tier manager, its slot and blocks free, and
        :meth:`resume` later promotes it back; the greedy chain continues
        from the parked position.  Returns the tier key, or None when
        the rid is not parkable (unknown, queued or mid-prefill).
        ``detach=True`` hands the resume to the caller (the router)."""
        if not self.paged or self._kv_tier is None:
            raise ValueError("park() requires the paged engine with a "
                             "kv_tier= manager attached")
        slot = next((i for i, r in enumerate(self._active)
                     if r is not None and r.rid == rid), None)
        if slot is None or slot in self._prefilling:
            return None
        req = self._active[slot]
        key = key or f"rid{rid}"
        # spill before the free: an injected kv_tier.spill fault drops
        # the payload and resume falls back to recompute
        self._kv_tier.spill(key, self._session_payload(slot, req),
                            kind="session")
        seq = self._seq[slot]
        self._active[slot] = None
        self._seq[slot] = None
        self._bt[slot, :] = 0
        seq.release()
        req.parked_at = time.perf_counter()
        req.auto_parked = _auto
        self._metrics["parks"].labels(
            kind="auto" if _auto else "manual").inc()
        self._recorder.record("serving.park", rid=rid, slot=slot,
                              key=key, auto=_auto,
                              tokens_out=len(req.out))
        if not _auto:
            # _maybe_auto_park emits the auto-park decision itself
            self._emit_decision("park", rid=rid, chosen="park",
                                auto=False, key=key,
                                tokens_out=len(req.out))
        if not detach:
            self._parked[rid] = (req, key)
        return key

    def resume(self, rid: int) -> int:
        """Re-enqueue a parked session.  A tier hit rides the resume
        admission's import (a promotion, like a handoff); a tier miss
        falls back to recompute: the prompt is extended with the tokens
        already emitted and prefilled again, and greedy decoding
        regenerates the same chain."""
        ent = self._parked.pop(rid, None)
        if ent is None:
            raise KeyError(f"rid {rid} is not parked on this engine")
        req, key = ent
        now = time.perf_counter()
        if req.parked_at:
            req.parked_s += now - req.parked_at
            req.parked_at = 0.0
        req.resume_at = now
        payload = self._kv_tier.fetch(key) \
            if self._kv_tier is not None else None
        self._kv_tier.discard(key)
        if payload is not None and payload.get("kv") is not None:
            req.handoff = payload
            req.mode = "resume"
        else:
            self._prepare_recompute(req)
        self._queue.append(req)
        path = "promote" if req.handoff is not None else "recompute"
        self._recorder.record("serving.resume", rid=rid, key=key,
                              path=path)
        self._emit_decision("resume", rid=rid, chosen=path, path=path,
                            key=key, parked_s=round(req.parked_s, 6))
        return rid

    def _prepare_recompute(self, req: _Request):
        """Tier-miss fallback: fold the emitted tokens but the last into
        the prompt; the prefill's sampled token is then that last token
        again, and the output stream is unchanged."""
        base = req.orig_prompt if req.orig_prompt is not None \
            else req.prompt
        if not req.orig_max_new:
            req.orig_max_new = req.max_new_tokens
        req.orig_prompt = base
        g = len(req.out)   # >= 1: parked sessions are post-first-token
        req.prompt = np.concatenate(
            [base, np.asarray(req.out[:-1], np.int32)]).astype(np.int32)
        req.out = req.out[:g - 1]
        req.max_new_tokens = req.orig_max_new - (g - 1)
        req.handoff = None
        req.mode = "full"
        self._metrics["resumes"].labels(path="recompute").inc()

    def checkpoint_sessions(self, key_of=None) -> int:
        """Spill every decoding session's KV and state to the tier
        without disturbing it (the router fetches these for survivors of
        a replica death).  ``key_of(rid)`` maps engine rids to
        fleet-wide keys; None skips a session.  Returns sessions
        shipped."""
        if not self.paged or self._kv_tier is None:
            return 0
        shipped = 0
        for slot, req in enumerate(self._active):
            if req is None or slot in self._prefilling or not req.out:
                continue
            key = key_of(req.rid) if key_of is not None else \
                f"rid{req.rid}"
            if key is None:
                continue
            if self._kv_tier.spill(key, self._session_payload(slot, req),
                                   kind="session"):
                shipped += 1
        return shipped

    def parked_rids(self):
        """Rids of sessions this engine parked and still owns."""
        return list(self._parked.keys())

    def _maybe_auto_park(self):
        """Deadline-aware auto-park (``serving.py:1556-1593``): with every
        slot busy and work queued, the decoding session with the most
        deadline headroom (>= auto_park_s; no deadline is infinitely
        patient) yields its slot; with slots free and the queue empty,
        the oldest auto-parked session comes back."""
        free = any(r is None for r in self._active)
        if free and not self._queue and self._parked:
            for rid, (req, _key) in list(self._parked.items()):
                if req.auto_parked:
                    self.resume(rid)
                    return
            return
        if not self._queue or free:
            return
        now = time.perf_counter()
        best, best_h = None, float(self._auto_park_s)
        cands = []
        for i, r in enumerate(self._active):
            if r is None or i in self._prefilling or not r.out:
                continue
            h = (r.deadline - now) if r.deadline is not None \
                else float("inf")
            cands.append({"rid": r.rid,
                          "headroom_s": round(h, 4)
                          if h != float("inf") else None})
            if h >= best_h:
                best, best_h = r.rid, h
        if best is not None:
            self._emit_decision(
                "park", rid=best, auto=True,
                chosen={"rid": best,
                        "headroom_s": round(best_h, 4)
                        if best_h != float("inf") else None},
                alternatives=[c for c in cands if c["rid"] != best],
                queue_depth=len(self._queue))
            self.park(best, _auto=True)

    def _demote_prefix_node(self, node):
        """``PrefixCache.on_evict``: spill the victim block to the tier
        under its chain key before the allocator frees it."""
        from paddle_tpu_torch.inference.kv_tier import prefix_block_key
        with torch.inference_mode():
            kv = self._pool.export_blocks([node.bid])
        payload = {"prefix": True, "block_size": int(self._block_size),
                   "kv": kv}
        self._kv_tier.spill(prefix_block_key(self._prefix.node_tokens(node)),
                            payload, kind="prefix")

    def _promote_prefix_tail(self, prompt, matched: List[int]
                             ) -> List[int]:
        """Extend a prefix-cache match with blocks promoted from the
        tier, block by block past the in-memory match: each hit is
        imported into a fresh block and handed to the trie."""
        from paddle_tpu_torch.inference.kv_tier import prefix_block_key
        bs = self._block_size
        nfull = (len(prompt) - 1) // bs  # blocks usable for reuse
        bids = list(matched)
        while len(bids) < nfull:
            upto = (len(bids) + 1) * bs
            payload = self._kv_tier.fetch(prefix_block_key(prompt[:upto]))
            if payload is None or payload.get("kv") is None:
                break
            bid = self._allocator.alloc()
            if bid is None:
                break
            try:
                with torch.inference_mode():
                    self._pool.import_blocks(payload["kv"], [bid])
            except Exception:  # noqa: BLE001 — geometry/dtype mismatch
                self._allocator.free(bid)
                break
            new = self._prefix.register(
                np.asarray(prompt[:upto], np.int32), bids + [bid],
                limit_tokens=upto)
            # the trie holds its own reference on a new block; drop ours
            self._allocator.free(bid)
            if not new:
                break
            bids.append(bid)
        return bids

    # -- the paged engine: prefill and decode ------------------------------------
    def _prefill_chunk_step(self, slot: int):
        """Advance `slot`'s prefill by one fixed-width chunk.  The final
        chunk gives the request's first token and registers the
        prompt's full blocks in the prefix trie; a prefill-only request
        then parks its blocks for :meth:`export_handoff`."""
        req = self._active[slot]
        start = self._prefilling[slot]
        Lp = len(req.prompt)
        C = self._chunk
        n = min(C, Lp - start)
        ids = np.zeros((1, C), np.int64)
        ids[0, :n] = req.prompt[start:start + n]
        final = start + n == Lp
        self._check_position(start + n)
        with self._tracer.span("serving.prefill", parent=req.span,
                               rid=req.rid, chunk_start=start, tokens=n):
            first = self._run(
                "serving.prefill_chunk", self._prefill_chunk_body, ids=ids,
                bt=self._bt[slot:slot + 1],
                start=np.array([start], np.int32),
                last_idx=np.array(Lp - 1 - start if final else 0,
                                  np.int64))
            if final:
                first = int(first[0])
        self._prefilling[slot] = start + n
        self.stats["prefill_chunks"] += 1
        m = self._metrics
        m["chunks"].inc()
        if C > n:
            m["pad_tokens"].inc(C - n)
        if not final:
            return
        del self._prefilling[slot]
        if self._prefix is not None:
            # generated tokens are per-request: register the prompt only
            self._prefix.register(req.prompt, self._seq[slot].bids,
                                  limit_tokens=Lp)
        now = time.perf_counter()
        if not req.first_token_at:
            # a recompute-resumed session keeps its first stamp
            req.first_token_at = now
            origin = req.router_t0 or req.enqueued_at
            if origin:
                m["ttft"].observe(now - origin)
        if req.resume_at:
            req.resume_s += now - req.resume_at
            req.resume_at = 0.0
        req.out.append(first)
        m["tokens"].inc()
        if req.mode == "prefill_only":
            # the slot frees now; the blocks stay referenced until
            # export_handoff / discard_handoff
            seq = self._seq[slot]
            self._seq[slot] = None
            self._handoff_ready[req.rid] = (req, seq, first)
            self._retire(slot, status="prefilled")
            return
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
                    self._metrics["cow"].inc()
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
        with self._recorder.instrumented("serving.decode"):
            toks = self._run("serving.decode", self._decode_paged_body,
                             bt=bt, toks=self._last_tok.astype(np.int64),
                             pos=pos, active=active).cpu().numpy()  # [B, K]
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
        with self._recorder.instrumented("serving.decode"):
            greedy = self._run("serving.spec_verify", self._verify_body,
                               bt=bt, toks=toks,
                               pos=pos).cpu().numpy()            # [B, S]
        dt = time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["spec_verifies"] += 1
        self.stats["spec_rows"] += len(decoding)
        self.stats["decode_seconds"] += dt
        m = self._metrics
        emitted_total = 0
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
            if n:
                m["spec"].labels(kind="proposed").inc(n)
                if a:
                    m["spec"].labels(kind="accepted").inc(a)
            self._tracer.add_span("serving.decode_step", t0, t0 + dt,
                                  parent=req.span, rid=req.rid,
                                  tokens=len(emitted), drafts=n,
                                  accepted=a)
            for t in emitted:
                req.out.append(t)
                emitted_total += 1
                self.stats["decode_tokens"] += 1
                self._pos[i] += 1
                self._budget[i] -= 1
                self._last_tok[i] = t
                if (self.eos is not None and t == self.eos) \
                        or self._budget[i] <= 0:
                    self._retire(i)
                    break
        m["steps"].inc()
        if emitted_total:
            m["tokens"].inc(emitted_total)
            m["decode"].observe(dt * len(decoding) / emitted_total)

    def _step_inner_paged(self) -> bool:
        fault_point("serving.engine_step",
                    active=sum(r is not None for r in self._active),
                    queued=len(self._queue))
        if self._auto_park_s is not None:
            self._maybe_auto_park()
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
        self._finish(req, slot=slot, status=status)

    def _finish(self, req: _Request, slot: Optional[int] = None,
                status: str = "ok"):
        req.retired_at = time.perf_counter()
        trace_id = req.span.trace_id if req.span is not None else None
        timings = _request_timings(req)
        self._status[req.rid] = RequestStatus(status, timings=timings,
                                              trace_id=trace_id)
        while len(self._status) > 8192:   # bounded
            self._status.pop(next(iter(self._status)))
        # a recompute-resumed session's client-visible prompt is the
        # original one
        prompt = req.orig_prompt if req.orig_prompt is not None \
            else req.prompt
        self._done.append((req.rid, prompt, list(req.out)))
        self._metrics["retirements"].inc()
        self._count_slo(req)
        ev = dict(rid=req.rid, slot=slot, generated=len(req.out),
                  status=status)
        if trace_id is not None:
            ev["trace_id"] = trace_id
        self._recorder.record("serving.retire", **ev)
        # the retirement decision carries the canonical timings; a routed
        # request's fleet-level retirement is the router's
        self._emit_decision(
            "retire", rid=req.rid, chosen=status, status=status,
            source="engine", routed=req.router_t0 is not None,
            generated=len(req.out), timings=timings)
        if req.router_t0 is None:
            observe_retirement(timings, targets=self._slo_targets)
        if req.span is not None:
            req.span.set_attribute("status", status)
            req.span.set_attribute("generated", len(req.out))
            req.span.end(end_time=req.retired_at)

    def _count_slo(self, req: _Request):
        """SLO verdicts from the request's own stamps
        (``serving.py:1957-1980``): TTFT for every retirement (one that
        never produced a token missed), TPOT from two output tokens."""
        ttft_target = self._slo_targets.get("ttft", 0.0)
        # a handed-off request's TTFT was judged on the prefill replica
        if ttft_target > 0 and req.mode != "resume":
            origin = req.router_t0 or req.enqueued_at
            ttft = (req.first_token_at - origin
                    if req.first_token_at and origin else None)
            hit = ttft is not None and ttft <= ttft_target
            self._metrics["slo"].labels(
                kind="ttft", result="hit" if hit else "miss").inc()
        tpot_target = self._slo_targets.get("tpot", 0.0)
        if tpot_target > 0 and len(req.out) > 1 and \
                req.first_token_at and req.retired_at:
            tpot = (req.retired_at - req.first_token_at) \
                / (len(req.out) - 1)
            self._metrics["slo"].labels(
                kind="tpot",
                result="hit" if tpot <= tpot_target else "miss").inc()

    def _expire(self):
        """Retire every request whose deadline has passed: queued,
        running or parked (a parked one's payload is dropped)."""
        now = time.perf_counter()
        for slot, req in enumerate(self._active):
            if req is not None and req.deadline is not None \
                    and now > req.deadline:
                self._metrics["timeouts"].inc()
                self._recorder.record("serving.timeout", rid=req.rid,
                                      slot=slot, generated=len(req.out))
                self._emit_decision("expire", rid=req.rid,
                                    chosen="timeout", where="slot")
                self._retire(slot, status="timeout")
        if self._queue:
            keep = deque()
            for req in self._queue:
                if req.deadline is not None and now > req.deadline:
                    self._metrics["timeouts"].inc()
                    self._recorder.record("serving.timeout", rid=req.rid,
                                          slot=None, generated=0)
                    self._emit_decision("expire", rid=req.rid,
                                        chosen="timeout", where="queue")
                    self._finish(req, status="timeout")
                else:
                    keep.append(req)
            # the same deque: the queue-depth gauge reads it
            self._queue.clear()
            self._queue.extend(keep)
        for rid, (req, key) in list(self._parked.items()):
            if req.deadline is not None and now > req.deadline:
                del self._parked[rid]
                if req.parked_at:
                    req.parked_s += now - req.parked_at
                    req.parked_at = 0.0
                if self._kv_tier is not None:
                    self._kv_tier.discard(key)
                self._metrics["timeouts"].inc()
                self._recorder.record("serving.timeout", rid=rid,
                                      slot=None, parked=True,
                                      generated=len(req.out))
                self._emit_decision("expire", rid=rid,
                                    chosen="timeout", where="parked")
                self._finish(req, status="timeout")

    def _recover(self, exc: Exception):
        """Engine-step failure: every in-flight request retires with
        status "error", the caches and block bookkeeping start over (the
        caches zeroed in place, so captured programs stay valid), parked
        handoffs are dropped with the pool they referenced, the queue is
        kept.  ``max_consecutive_errors`` failures in a row re-raise
        (the fault is persistent)."""
        self._error_streak += 1
        self._metrics["engine_errors"].inc()
        self._recorder.record("serving.engine_error",
                              error=type(exc).__name__,
                              message=str(exc)[:200],
                              streak=self._error_streak)
        for slot, req in enumerate(self._active):
            if req is not None:
                self._retire(slot, status="error")
        with torch.inference_mode():
            if self.paged:
                self._allocator = BlockAllocator(self._num_blocks)
                if self._prefix is not None:
                    self._prefix = PrefixCache(self._block_size,
                                               self._allocator)
                    if self._kv_tier is not None:
                        self._prefix.on_evict = self._demote_prefix_node
                self._pool.reset()
                self._bt[:] = 0
                self._seq = [None] * self.slots
                self._prefilling.clear()
                self._handoff_ready.clear()
            else:
                for c in self._caches + self._caches1:
                    c.k.zero_()
                    c.v.zero_()
        self._pos[:] = 0
        self._budget[:] = 0
        self._last_tok[:] = 0
        # the restart-after-fault cold start (serving.py:2086-2100): with
        # the persistent cache on, programs come back from it (cache_only:
        # a miss stays eager, nothing is compiled here); never allowed to
        # fail the recovery
        try:
            from paddle_tpu_torch import compile_cache
            if compile_cache.enabled():
                self.aot_warmup(cache_only=True)
        except Exception:
            pass
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

    def analyze(self, strict: bool = False, passes=None, options=None):
        """Program analysis: not ported yet; raises."""
        raise NotImplementedError(
            "analyze: not ported yet (ROADMAP.md, queue 1, item 10: "
            "program analysis)")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
