"""Mixture-of-Experts, the single-program part
(``paddle_tpu/distributed/moe.py``): GShard top-k gating with capacity
and the load-balance loss, the stacked expert FFN, and ``MoELayer`` with
the ``"einsum"`` and ``"index"`` dispatch modes.

Three choices differ from the JAX package on purpose (``ROADMAP.md``
§3):

* queue positions are counted in int32.  The JAX package takes them as
  a cumsum in the probabilities' dtype, which in bf16 stops counting
  exactly past 256 assignments to one expert, so distinct tokens can
  share a capacity slot; here they never do;
* top-k selects with a stable descending sort, so among equal
  probabilities the lower expert index comes first, as ``lax.top_k``
  orders ties (``torch.topk`` promises no order);
* the expert FFN always goes through ``grouped_expert_ffn``, the grouped
  CUDA kernel on the card and its plain version on the CPU, where the
  JAX package takes its Pallas kernel only behind
  ``PADDLE_TPU_GROUPED_MOE``.

The einsum mode builds ``combine`` and ``dispatch`` ``[T, E, C]`` by one
scatter each from the index form: the values of the JAX package's one-hot
einsums, without a ``[T, k, E, C]`` intermediate.  Per-expert counts stay
on the device, so routing costs no host sync.

Waiting (``ROADMAP.md``, queue 1): the ``"ragged"``, ``"all_to_all"`` and
``"all_to_all_index"`` dispatch modes and ``dropless=True`` (item 8) raise ``NotImplementedError`` naming their
item.  The ``moe.expert_imbalance`` fault point biases every token's
logits towards expert 0, as in the JAX package.

After an eager routed forward the router metrics are recorded as in the
JAX package (``moe.py:263-323``): the dropped-token and capacity-overflow
counters, the aux-loss gauge and, in the einsum mode, the per-expert
load and imbalance gauges.  They read the device values on the host, so
they are skipped inside ``TrainStep`` (:func:`router_metrics_paused`) and
while a CUDA graph captures, as JAX skips them under a trace; the
grouped kernel counts in ``paddle_tpu_grouped_moe_path_total`` where it
launches."""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.robustness.faults import fault_fires
from paddle_tpu_torch.nn.layer import Layer
from paddle_tpu_torch.ops.kernels.grouped_matmul import (GroupedExpertFFN,
                                                         record_path)

__all__ = ["top_k_gating", "top_k_gating_indices", "moe_forward_index",
           "NaiveGate", "SwitchGate", "GShardGate", "ExpertFFN", "MoELayer",
           "router_metrics_paused"]

_QUEUE1 = "ROADMAP.md, queue 1, item 8"


def _unported(what: str, where: str = _QUEUE1) -> NotImplementedError:
    return NotImplementedError(f"MoE {what} is not ported yet ({where})")


_PAUSE = threading.local()


@contextlib.contextmanager
def router_metrics_paused():
    """No router metrics inside: the training step's bodies (eager or
    captured) must not read the device on the host each step."""
    depth = getattr(_PAUSE, "depth", 0)
    _PAUSE.depth = depth + 1
    try:
        yield
    finally:
        _PAUSE.depth = depth


def _router_metrics():
    """The routing instruments on the process-wide registry
    (``moe.py:263-289``)."""
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    return {
        "dropped": reg.counter(
            "paddle_tpu_moe_dropped_tokens_total",
            "token-choice assignments dropped by the capacity bound"),
        "overflow": reg.counter(
            "paddle_tpu_moe_capacity_overflow_total",
            "routed forwards in which at least one assignment was "
            "dropped (capacity pressure events)"),
        "aux": reg.gauge(
            "paddle_tpu_moe_aux_loss",
            "GShard load-balance auxiliary loss of the last routed "
            "forward"),
        "load": reg.gauge(
            "paddle_tpu_moe_expert_load",
            "kept token-choice assignments per expert in the last "
            "routed forward", labelnames=("expert",)),
        "imbalance": reg.gauge(
            "paddle_tpu_moe_expert_imbalance",
            "max/mean per-expert load of the last routed forward "
            "(1.0 = perfectly balanced)"),
    }


def _record_router_metrics(aux, dropped_frac, total_assignments,
                           load=None):
    """The counters and gauges of one routed forward (``moe.py:292-
    323``); skipped while paused or while a CUDA graph captures."""
    if getattr(_PAUSE, "depth", 0) or (
            torch.cuda.is_available() and
            torch.cuda.is_current_stream_capturing()):
        return
    m = _router_metrics()
    m["aux"].set(float(aux.detach()))
    df = float(dropped_frac.detach())
    if df > 0:
        m["dropped"].inc(df * total_assignments)
        m["overflow"].inc()
    if load is not None:
        arr = load.detach().double().cpu().numpy()
        for e, val in enumerate(arr):
            m["load"].labels(expert=e).set(float(val))
        mean = arr.mean()
        m["imbalance"].set(float(arr.max() / mean) if mean > 0 else 1.0)


def _gshard_aux(probs, topi, E: int, k: int):
    """GShard load-balance loss: E * sum_e(mean_prob_e * frac_tokens_e / k)
    (``moe.py:68-75``), in the probabilities' dtype."""
    chosen = torch.zeros_like(probs).scatter_(1, topi, 1.0)   # [T, E]
    me = probs.mean(dim=0)
    ce = (chosen > 0).to(probs.dtype).mean(dim=0) / k
    return (me * ce).sum() * E


def _top_k(probs, k: int):
    """``lax.top_k``: the k largest per row, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def top_k_gating_indices(gate_logits, k: int, capacity: int):
    """Index-form GShard gating (``moe.py:78-117``).

    Positions come from one cumsum over the k-major flattening (every
    first choice in token order, then every second choice, ...), counted
    in int32; an over-capacity assignment keeps its position number.

    Returns ``topi`` [T, k] int64 expert ids, ``slot`` [T, k] int32
    queue positions (>= capacity where dropped), ``w`` [T, k] combine
    weights normalised over the kept choices, ``keep`` [T, k] bool, and
    the load-balance loss."""
    tokens, E = gate_logits.shape
    probs = torch.softmax(gate_logits, dim=-1)
    k = min(k, E)
    topv, topi = _top_k(probs, k)                                # [T, k]
    # expert-major one-hot [E, k*T] over the k-major flattening, so the
    # queue count is a scan along the contiguous axis
    order = topi.t().reshape(1, -1)
    onehot = torch.zeros((E, k * tokens), dtype=torch.int32,
                         device=probs.device).scatter_(0, order, 1)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    slot = torch.gather(pos, 0, order).reshape(k, tokens).t()    # [T, k]
    keep = slot < capacity
    w = topv * keep.to(probs.dtype)
    denom = w.sum(dim=1, keepdim=True)
    w = torch.where(denom > 0, w / torch.clamp(denom, min=1e-9), w)
    return topi, slot.contiguous(), w, keep, _gshard_aux(probs, topi, E, k)


def _expert_counts(topi, keep, E: int):
    """Kept assignments per expert: the front-packed slot prefix of each
    expert's buffer (``moe.py:145``, ``:689``), int32 on the device."""
    counts = torch.zeros((E,), dtype=torch.int32, device=topi.device)
    return counts.index_add_(0, topi.reshape(-1),
                             keep.reshape(-1).to(torch.int32))


def _dense_masks(topi, slot, w, keep, E: int, capacity: int):
    """``combine`` [T, E, C] (w's dtype) and ``dispatch`` [T, E, C]
    (bool) of ``top_k_gating`` (``moe.py:58-64``), each by one scatter:
    combine takes w at (t, topi, clip(slot)), dispatch marks the kept
    (t, topi, slot).  A token's k experts are distinct, so no two of its
    choices meet in one cell; a dropped choice adds its zero weight at
    slot C-1, as the one-hot einsum does."""
    T, k = topi.shape
    t = torch.arange(T, device=topi.device)[:, None].expand(T, k)
    cs = torch.clamp(slot, 0, capacity - 1).long()
    combine = torch.zeros((T, E, capacity), dtype=w.dtype, device=w.device)
    combine = combine.index_put((t, topi, cs), w, accumulate=True)
    dispatch = torch.zeros((T, E, capacity), dtype=torch.bool,
                           device=w.device)
    dispatch.index_put_((t, topi, cs), keep)
    return combine, dispatch


def top_k_gating(gate_logits, k: int, capacity: int):
    """GShard top-k gating with capacity (``moe.py:37-65``): ``combine``
    [T, E, C], ``dispatch`` [T, E, C] bool and the load-balance loss.
    The JAX package's logit jitter (``jitter_key``), which no caller
    passes, is not ported."""
    E = gate_logits.shape[1]
    topi, slot, w, keep, aux = top_k_gating_indices(gate_logits, k,
                                                    capacity)
    combine, dispatch = _dense_masks(topi, slot, w, keep, E, capacity)
    return combine, dispatch, aux


def moe_forward_index(x2d, logits, experts_fn, *, E: int, top_k: int,
                      capacity: int):
    """Gather/scatter dispatch (``moe.py:120-153``): ``[E, C]`` token
    indices by one scatter, expert inputs gathered from the token axis,
    outputs combined by a ``[T, k, d]`` gather; no ``[T, E, C]`` tensor.
    Dropped assignments write to a spare row E that is cut off (the JAX
    scatter's ``mode="drop"``); pad slots read token 0 and carry zero
    combine weight.  ``experts_fn(buf, counts)`` maps [E, C, d] to
    [E, C, d].  Returns (out [T, d], aux, dropped fraction)."""
    T, d = x2d.shape
    topi, slot, w, keep, aux = top_k_gating_indices(logits, top_k, capacity)
    safe_e = torch.where(keep, topi, E)
    safe_s = torch.where(keep, slot, 0).long()
    tok_ids = torch.arange(T, device=x2d.device)[:, None].expand_as(topi)
    tok_for = torch.zeros((E + 1, capacity), dtype=torch.long,
                          device=x2d.device)
    tok_for.index_put_((safe_e, safe_s), tok_ids)
    expert_in = x2d[tok_for[:E]]                                 # [E, C, d]
    expert_out = experts_fn(expert_in, _expert_counts(topi, keep, E))
    picked = expert_out[topi, torch.clamp(slot, 0, capacity - 1).long()]
    out = torch.einsum("tkd,tk->td", picked, w.to(x2d.dtype))
    dropped = 1.0 - keep.float().mean()
    return out, aux, dropped


class NaiveGate(Layer):
    """Linear router, top-k, no noise (``moe.py:189-203``)."""

    def __init__(self, d_model: int, num_experts: int, top_k: int = 2,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.num_experts = num_experts
        self.top_k = top_k
        self.gate = self.create_parameter([d_model, num_experts])

    def logits(self, x2d):
        return x2d @ self.gate


class SwitchGate(NaiveGate):
    """top-1 (Switch Transformer)."""

    def __init__(self, d_model, num_experts, jitter_eps: float = 0.01,
                 dtype="float32", device=None):
        super().__init__(d_model, num_experts, top_k=1, dtype=dtype,
                         device=device)
        self.jitter_eps = jitter_eps


class GShardGate(NaiveGate):
    """top-2 with capacity."""

    def __init__(self, d_model, num_experts, capacity_factor: float = 1.25,
                 dtype="float32", device=None):
        super().__init__(d_model, num_experts, top_k=2, dtype=dtype,
                         device=device)
        self.capacity_factor = capacity_factor


class ExpertFFN(Layer):
    """Stacked expert FFNs: ``w1`` [E, d, h], ``w2`` [E, h, d], ``b1``
    [E, h], ``b2`` [E, d] (``moe.py:222-253``).  The activation is the
    exact gelu, the one the grouped kernel computes."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation: Callable = None, ep_axis: str = "ep",
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.num_experts = num_experts
        self.activation = activation or F.gelu
        self.w1 = self.create_parameter([num_experts, d_model, d_hidden])
        self.w2 = self.create_parameter([num_experts, d_hidden, d_model])
        self.b1 = self.create_parameter([num_experts, d_hidden],
                                        is_bias=True)
        self.b2 = self.create_parameter([num_experts, d_model],
                                        is_bias=True)

    def forward(self, expert_inputs, counts=None):
        """[E, C, d] -> [E, C, d]; rows at and past ``counts`` (an [E]
        valid-slot prefix, or None for all rows) come back zero."""
        return _expert_ffn(expert_inputs, self.w1, self.b1, self.w2, self.b2,
                           self.activation, counts=counts)


def _expert_ffn(x, w1, b1, w2, b2, act, counts=None):
    """[G, C, d] -> [G, C, d] through the grouped expert FFN
    (``moe.py:326-343``), differentiable in x and the weights."""
    if x.device.type == "cuda":
        record_path("grouped")
    return GroupedExpertFFN.apply(x, w1, b1, w2, b2, counts, act)


class MoELayer(Layer):
    """Routed expert layer (``moe.py:527-705``): forward [B, S, d] ->
    [B, S, d].  After each call ``aux_loss`` holds the load-balance loss
    and ``router_stats`` the dropped fraction (``"dropped_frac"``) and
    the kept assignments per expert (``"load"``, [E] int32), all on the
    device."""

    def __init__(self, d_model: int, num_experts: int,
                 d_hidden: Optional[int] = None, gate: str = "gshard",
                 top_k: Optional[int] = None,
                 capacity_factor: float = 1.25,
                 experts: Optional[Layer] = None, ep_axis: str = "ep",
                 dispatch_mode: str = "einsum", dropless: bool = False,
                 mesh=None, dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        if dispatch_mode not in ("einsum", "all_to_all", "index", "ragged",
                                 "all_to_all_index"):
            raise ValueError(f"unknown dispatch_mode {dispatch_mode}")
        if dispatch_mode not in ("einsum", "index"):
            raise _unported(f"dispatch_mode={dispatch_mode!r}")
        if dropless:
            raise _unported("dropless=True")
        self.d_model = d_model
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        self.dispatch_mode = dispatch_mode
        self.dropless = dropless
        self.mesh = mesh
        kw = dict(dtype=dtype, device=device)
        if gate == "gshard":
            self.gate = GShardGate(d_model, num_experts, capacity_factor,
                                   **kw)
        elif gate == "switch":
            self.gate = SwitchGate(d_model, num_experts, **kw)
        elif gate == "naive":
            self.gate = NaiveGate(d_model, num_experts, top_k=top_k or 2,
                                  **kw)
        else:
            raise ValueError(f"unknown gate {gate}")
        if top_k is not None:
            self.gate.top_k = top_k
        self.experts = experts or ExpertFFN(
            num_experts, d_model, d_hidden or 4 * d_model, ep_axis=ep_axis,
            **kw)
        self.aux_loss = None
        self.router_stats = None

    def forward(self, x):
        B, S, d = x.shape
        T = B * S
        E = self.num_experts
        k = self.gate.top_k
        x2d = x.reshape(T, d)
        capacity = max(1, int(self.capacity_factor * k * T / E))
        logits = self.gate.logits(x2d)
        if fault_fires("moe.expert_imbalance", experts=E):
            # the hot-expert drill (moe.py:627-633): every token prefers
            # expert 0; the imbalance gauge and the aux loss show the skew
            hot = torch.zeros(E, dtype=logits.dtype, device=logits.device)
            hot[0] = 10.0
            logits = logits + hot
        stacked = isinstance(self.experts, ExpertFFN)
        if self.dispatch_mode == "index":
            if not stacked:
                raise ValueError("index dispatch requires the stacked "
                                 "ExpertFFN experts")
            load = []

            def experts_fn(buf, counts):
                load.append(counts)
                return self.experts(buf, counts=counts)

            out, aux, dropped = moe_forward_index(
                x2d, logits, experts_fn, E=E, top_k=k, capacity=capacity)
            self.aux_loss = aux
            self.router_stats = {"dropped_frac": dropped, "load": load[0]}
            _record_router_metrics(aux, dropped, T * k)
            return out.reshape(B, S, d)
        topi, slot, w, keep, aux = top_k_gating_indices(logits, k, capacity)
        combine, dispatch = _dense_masks(topi, slot, w, keep, E, capacity)
        counts = _expert_counts(topi, keep, E)
        self.aux_loss = aux
        self.router_stats = {
            "dropped_frac": 1.0 - keep.float().sum() / (T * k),
            "load": counts}
        _record_router_metrics(aux, self.router_stats["dropped_frac"],
                               T * k, load=counts)
        # dispatch [T, E, C] x [T, d] -> [E, C, d]; combine back to [T, d]
        expert_in = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x2d)
        expert_out = self.experts(expert_in, counts=counts) if stacked \
            else self.experts(expert_in)
        out = torch.einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
        return out.reshape(B, S, d)
