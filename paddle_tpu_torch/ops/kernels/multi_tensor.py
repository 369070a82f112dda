"""The multi-tensor kernels — wrappers of ``csrc/multi_tensor.cu`` and
their plain PyTorch versions.

No Pallas kernel stands behind these: the JAX package jits the whole
step (and the SDC sentinel's digest), and XLA fuses the per-leaf
gradient norm, the update rule and the per-leaf bit sums.  The port's
counterpart is one launch over every tensor:

* ``multi_tensor_norm(tensors)``: the global L2 norm, a 0-d fp32 tensor,
  from an fp32 sum of squares (each tensor's sum, then the tensors in
  order; the kernel's result is the same bits on every launch).
* ``multi_tensor_adam(...)``: the Adam / AdamW update of every
  parameter, with its moments and optional fp32 master, reading lr, the
  update count, the clip scale and the step guard's keep flag from
  0-d device tensors (a captured CUDA graph reads them at replay time).
* ``multi_tensor_digest(tensors)``: the uint32 sum of each tensor's
  element bits (1-, 2- or 4-byte elements, zero-extended) and their FNV
  fold in tensor order, ``robustness/recovery.py``'s ``params_digest``;
  integer arithmetic, so the kernel equals ``digest_reference`` bit for
  bit.  The plain version sums in chunks of ``DIGEST_CHUNK`` elements,
  so its int64 temporaries stay bounded.

A tensor on the CPU takes the plain version: ``adam_reference`` is the
per-parameter rule, in the reference's op order in fp32
(``optimizers.py:111-122``, ``:144-155``) with the bias corrections in
fp32 from the count.  A CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches (``.launches``).

The kernels take a device table of the tensors (pointers, element
counts, first chunk, dtypes).  A table is kept per set of tensors and
reused while their addresses repeat.  Inside a CUDA graph's capture the
tables are carved from one buffer that :func:`capture_tables` allocates
first in the capture and keeps for the whole of it, and are filled after
the capture by :func:`finish_capture`, before the graph's first replay:
the graph never copies from the host, and no other tensor of the graph
shares the tables' memory (a table allocated later in the capture could
reuse a block that an earlier kernel of the graph writes on every
replay)."""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.ops.kernels import _build, costs

__all__ = ["multi_tensor_norm", "multi_tensor_adam", "multi_tensor_digest",
           "norm_reference", "adam_reference", "adam_rule",
           "bias_correction", "digest_reference", "finish_capture",
           "FNV_BASIS", "FNV_PRIME"]

_KEPT = 8                 # tables kept for eager calls, least recent out
_tables: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_pending: List[tuple] = []
_arena: List[list] = []   # [buffer, bytes taken] while a capture carves


def bias_correction(beta: float, step, device) -> torch.Tensor:
    """``1 - beta ** step`` in fp32 (the fp32 beta to the power of the
    fp32 count), as the reference's traced step computes it."""
    b = torch.full((), beta, dtype=torch.float32, device=device)
    t = step.float() if torch.is_tensor(step) else \
        torch.full((), float(step), dtype=torch.float32, device=device)
    return 1 - torch.pow(b, t.to(device))


def adam_rule(w, g, m, v, lr, bc1, bc2, beta1, beta2, eps, wd):
    """One Adam step on fp32 tensors, the reference's operations in its
    order, each rounded to fp32: ``m = b1 m + (1 - b1) g``, ``v = b2 v +
    (1 - b2) g^2``, ``upd = (m / bc1) / (sqrt(v / bc2) + eps)``; with a
    decoupled decay `wd` (AdamW, not None) ``upd + wd w``; returns
    ``(w - lr upd, m, v)``."""
    m = m * beta1 + g * (1 - beta1)
    v = v * beta2 + g.square() * (1 - beta2)
    upd = (m / bc1) / ((v / bc2).sqrt() + eps)
    if wd is not None:
        upd = upd + w * wd
    return w - upd * lr, m, v


def adam_reference(p, g, m, v, master, *, lr, step, beta1, beta2, epsilon,
                   weight_decay, decoupled, multi_precision, scale=None,
                   keep=None):
    """The plain version for one parameter, updated in place: the clip
    scale (``(g * scale)`` cast back to g's dtype), the fp32 cast under
    ``multi_precision``, Adam's L2 decay in the work tensor's dtype (the
    master, else the parameter), the rule, and the keep flag: with
    ``keep`` False nothing changes."""
    work = master if master is not None else p
    if scale is not None:
        g = (g.float() * scale).to(g.dtype)
    if multi_precision:
        g = g.float()
    if not decoupled and weight_decay:
        g = g + work * weight_decay
    bc1 = bias_correction(beta1, step, p.device)
    bc2 = bias_correction(beta2, step, p.device)
    w, mn, vn = adam_rule(work.float(), g.float(), m, v, lr, bc1, bc2, beta1,
                          beta2, epsilon, weight_decay if decoupled else None)
    news = [(m, mn), (v, vn), (p, w)]
    if master is not None:
        news.append((master, w))
    for dst, new in news:
        if keep is not None:
            new = torch.where(keep, new.to(dst.dtype), dst)
        dst.copy_(new)


def norm_reference(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the fp32 sums of squares, summed in tensor order."""
    dev = tensors[0].device if tensors else torch.device("cpu")
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for t in tensors:
        total = total + torch.sum(t.float().square())
    return torch.sqrt(total)


# elements a chunk (csrc/multi_tensor.cu CHUNK; a card test holds the two
# equal)
CHUNK = 1 << 16


def _chunk0(numels):
    """Each tensor's first chunk index and the total number of chunks."""
    counts = [(n + CHUNK - 1) // CHUNK for n in numels]
    starts = np.cumsum([0] + counts)
    return starts[:-1], int(starts[-1])


def _table(kind: str, rows: np.ndarray, device) -> torch.Tensor:
    """The device copy of `rows` (int64), kept and reused for the same
    contents; inside a capture, allocated there and filled by
    :func:`finish_capture`."""
    key = (kind, str(device), rows.tobytes())
    host = torch.from_numpy(rows)
    if torch.cuda.is_current_stream_capturing():
        if not _arena:
            raise RuntimeError(
                f"multi_tensor: a {kind} table inside a CUDA graph's "
                "capture needs capture_tables() entered first in it")
        buf, taken = _arena[-1]
        start = -(-taken // 64) * 64
        if start + rows.nbytes > buf.numel():
            raise RuntimeError(
                f"multi_tensor: the capture's tables need more than the "
                f"{buf.numel()} bytes capture_tables() allocated")
        _arena[-1][1] = start + rows.nbytes
        dev = buf[start:start + rows.nbytes].view(torch.int64).view(
            rows.shape)
        _pending.append((dev, host))
        return dev
    dev = _tables.get(key)
    if dev is not None:
        _tables.move_to_end(key)
        return dev
    dev = torch.empty(rows.shape, dtype=torch.int64, device=device)
    dev.copy_(host.pin_memory(), non_blocking=True)
    _tables[key] = dev
    while len(_tables) > _KEPT:
        _tables.popitem(last=False)
    return dev


@contextlib.contextmanager
def capture_tables(device, nbytes: int):
    """Enter first inside a CUDA graph's capture: the buffer of `nbytes`
    that the capture's tables are carved from (a table needs 32 bytes a
    tensor for the norm, 64 for the update, each table 64-byte
    aligned)."""
    _arena.append([torch.empty(nbytes, dtype=torch.uint8, device=device),
                   0])
    try:
        yield _arena[-1][0]
    finally:
        _arena.pop()


def finish_capture() -> List[torch.Tensor]:
    """Fill the tables allocated during a capture (call it after the
    capture, before the first replay) and return them: the caller keeps
    them alive as long as the graph."""
    done = []
    while _pending:
        dev, host = _pending.pop(0)
        dev.copy_(host)
        done.append(dev)
    return done


def _check(what, named, device):
    for name, t in named:
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _dt(t, what, name):
    code = _build.DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: {name} is {t.dtype} (float32 or bfloat16 "
                        "only)")
    return code


def multi_tensor_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of `tensors` (float32 or bfloat16, one device),
    a 0-d fp32 tensor on their device."""
    tensors = list(tensors)
    if not tensors or tensors[0].device.type == "cpu":
        return _build.plain("multi_tensor_norm",
                            lambda: costs.mt_norm(tensors), norm_reference,
                            tensors)
    what = "multi_tensor_norm"
    dev = tensors[0].device
    _check(what, [(f"tensors[{i}]", t) for i, t in enumerate(tensors)], dev)
    numels = [t.numel() for t in tensors]
    chunk0, nchunks = _chunk0(numels)
    rows = np.zeros((len(tensors), 4), dtype=np.int64)
    for i, t in enumerate(tensors):
        rows[i] = (t.data_ptr(), numels[i], chunk0[i],
                   _dt(t, what, f"tensors[{i}]"))
    out = torch.empty((), dtype=torch.float32, device=dev)
    if nchunks == 0:
        return out.zero_()
    lib = _build.library("multi_tensor")
    table = _table("norm", rows, dev)
    part = _build.workspace(what, dev, 4 * (nchunks + len(tensors)))
    ticket = _build.tickets(what, dev, 1)
    err = lib.ptt_mt_norm(table.data_ptr(), len(tensors), nchunks, part,
                          ticket.data_ptr(), out.data_ptr(),
                          _build.stream_of(out))
    _build.check(lib, err, what)
    _build.charge(what, costs.mt_norm, tensors)
    multi_tensor_norm.launches += 1
    return out


multi_tensor_norm.launches = 0


def _scalar(x, dtype, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def multi_tensor_adam(params, grads, moment1, moment2, masters, *, lr, step,
                      beta1=0.9, beta2=0.999, epsilon=1e-8,
                      weight_decays=None, decoupled=True,
                      multi_precision=False, scale: Optional = None,
                      keep: Optional = None):
    """One Adam (``decoupled=False``: L2 decay folded into the gradient)
    or AdamW (decoupled decay) update of every parameter, in place.

    params float32 or bfloat16; grads float32 or bfloat16, each its
    parameter's shape; moment1 / moment2 fp32; masters a list holding an
    fp32 master or None for each parameter.  lr (fp32) and step (the
    update count, int32) are numbers or 0-d tensors; weight_decays one
    float a parameter (None: no decay); scale the 0-d fp32 clip scale or
    None; keep the guard's 0-d bool or None (always keep)."""
    n = len(params)
    if weight_decays is None:
        weight_decays = [0.0] * n
    lists = (grads, moment1, moment2, masters, weight_decays)
    if any(len(x) != n for x in lists):
        raise ValueError("multi_tensor_adam: params, grads, moments, "
                         "masters and weight_decays must be one per "
                         "parameter")
    if not n:
        return
    hyper = dict(beta1=beta1, beta2=beta2, epsilon=epsilon,
                 decoupled=decoupled, multi_precision=multi_precision)
    if params[0].device.type == "cpu":
        def update():
            for p, g, m, v, ms, wd in zip(params, grads, moment1, moment2,
                                          masters, weight_decays):
                adam_reference(p, g, m, v, ms, lr=lr, step=step,
                               weight_decay=wd, scale=scale, keep=keep,
                               **hyper)
        _build.plain("multi_tensor_adam",
                     lambda: costs.mt_adam(params, grads, masters), update)
        return
    what = "multi_tensor_adam"
    dev = params[0].device
    rows = np.zeros((n, 8), dtype=np.int64)
    chunk0, nchunks = _chunk0([p.numel() for p in params])
    for i, (p, g, m, v, ms, wd) in enumerate(zip(
            params, grads, moment1, moment2, masters, weight_decays)):
        named = [(f"params[{i}]", p), (f"grads[{i}]", g),
                 (f"moment1[{i}]", m), (f"moment2[{i}]", v)]
        if ms is not None:
            named.append((f"masters[{i}]", ms))
        _check(what, named, dev)
        for name, t in named[1:]:
            if t.numel() != p.numel():
                raise ValueError(f"{what}: {name} has {t.numel()} elements, "
                                 f"params[{i}] {p.numel()}")
        for name, t in named[2:]:
            if t.dtype != torch.float32:
                raise TypeError(f"{what}: {name} must be float32")
        if ms is not None and p.dtype != torch.bfloat16:
            raise TypeError(f"{what}: masters[{i}] given for a {p.dtype} "
                            "parameter (bfloat16 only)")
        dt = (_dt(p, what, f"params[{i}]")
              | _dt(g, what, f"grads[{i}]") << 8
              | (ms is not None) << 16)
        # the last 8 bytes: the int dt, then the float wd
        tail = np.array([dt, np.float32(wd or 0.0).view(np.uint32)],
                        dtype=np.uint32).view(np.int64)[0]
        rows[i] = (p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                   0 if ms is None else ms.data_ptr(), p.numel(), chunk0[i],
                   tail)
    lr_t = _scalar(lr, torch.float32, dev)
    step_t = _scalar(step, torch.int32, dev)
    if scale is not None:
        scale = _scalar(scale, torch.float32, dev)
    if keep is not None:
        keep = _scalar(keep, torch.bool, dev)
    lib = _build.library("multi_tensor")
    table = _table("adam", rows, dev)
    err = lib.ptt_mt_adam(
        table.data_ptr(), n, nchunks, float(np.float32(beta1)),
        float(np.float32(1 - beta1)), float(np.float32(beta2)),
        float(np.float32(1 - beta2)), float(np.float32(epsilon)),
        int(bool(decoupled)), int(bool(multi_precision)), lr_t.data_ptr(),
        step_t.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if keep is None else keep.data_ptr(), _build.stream_of(lr_t))
    _build.check(lib, err, what)
    _build.charge(what, costs.mt_adam, params, grads, masters)
    multi_tensor_adam.launches += 1


multi_tensor_adam.launches = 0


FNV_BASIS = 2166136261
FNV_PRIME = 16777619
# elements a chunk of the plain digest (int64 temporaries of 128 MiB)
DIGEST_CHUNK = 1 << 24
# bytes a chunk of the digest kernel (a multiple of 16; passed to it)
DIGEST_CHUNK_BYTES = 1 << 18
_INTS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _digest_check(tensors):
    for i, t in enumerate(tensors):
        if t.element_size() not in _INTS or not t.is_contiguous():
            raise ValueError(
                f"multi_tensor_digest: tensors[{i}] must be contiguous "
                f"with 1-, 2- or 4-byte elements (got {t.dtype}, "
                f"contiguous={t.is_contiguous()})")


def fnv_fold(sums) -> int:
    """The FNV fold of per-tensor uint32 sums, in order."""
    acc = FNV_BASIS
    for s in sums:
        acc = (acc * FNV_PRIME + int(s)) & 0xFFFFFFFF
    return acc


def digest_reference(tensors: Sequence[torch.Tensor],
                     chunk: int = DIGEST_CHUNK) -> torch.Tensor:
    """The plain version: an int32 tensor of ``len(tensors) + 1`` on the
    tensors' device holding (as bits) each tensor's uint32 sum of its
    element bits, then their FNV fold.  Each sum runs over chunks of
    `chunk` elements widened to int64 (masked to the element's width)."""
    tensors = list(tensors)
    _digest_check(tensors)
    dev = tensors[0].device if tensors else torch.device("cpu")
    sums = []
    for t in tensors:
        size = t.element_size()
        flat = t.reshape(-1).view(_INTS[size])
        mask = (1 << (8 * size)) - 1
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(0, flat.numel(), chunk):
            part = flat[i:i + chunk].to(torch.int64)
            if size > 1:
                part = part & mask
            acc = (acc + part.sum()) & 0xFFFFFFFF
        sums.append(acc)
    vals = [int(s) for s in sums]
    out = np.array(vals + [fnv_fold(vals)], dtype=np.uint32).view(np.int32)
    return torch.from_numpy(out).to(dev)


def multi_tensor_digest(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each tensor's uint32 sum of its element bits and their FNV fold
    (``digest_reference``'s result), one launch over every tensor on the
    card; the tensors are read in place."""
    tensors = list(tensors)
    if not tensors or tensors[0].device.type == "cpu":
        return _build.plain("multi_tensor_digest",
                            lambda: costs.mt_digest(tensors),
                            digest_reference, tensors)
    what = "multi_tensor_digest"
    dev = tensors[0].device
    _check(what, [(f"tensors[{i}]", t) for i, t in enumerate(tensors)], dev)
    _digest_check(tensors)
    n = len(tensors)
    nbytes = [t.numel() * t.element_size() for t in tensors]
    counts = [(b + DIGEST_CHUNK_BYTES - 1) // DIGEST_CHUNK_BYTES
              for b in nbytes]
    starts = np.cumsum([0] + counts)
    nchunks = int(starts[-1])
    if nchunks == 0:
        return digest_reference(tensors)
    rows = np.zeros((n, 4), dtype=np.int64)
    for i, t in enumerate(tensors):
        rows[i] = (t.data_ptr(), nbytes[i], starts[i], t.element_size())
    out = torch.empty(n + 1, dtype=torch.int32, device=dev)
    lib = _build.library("multi_tensor")
    table = _table("digest", rows, dev)
    part = _build.workspace(what, dev, 4 * nchunks)
    ticket = _build.tickets(what, dev, 1)
    err = lib.ptt_mt_digest(table.data_ptr(), n, nchunks, DIGEST_CHUNK_BYTES,
                            part,
                            ticket.data_ptr(), out.data_ptr(),
                            _build.stream_of(out))
    _build.check(lib, err, what)
    _build.charge(what, costs.mt_digest, tensors)
    multi_tensor_digest.launches += 1
    return out


multi_tensor_digest.launches = 0
