"""The port's ``TrainStep`` telemetry against the JAX package's on the
CPU.  The same steps on both (a float-input Linear regression, the same
weights, ``accum_steps=2``): two plain steps, one whose batch the fault
``train.nonfinite_batch`` poisons (skipped by the guard), one with a
novel batch signature (a recompile), and one more of the first
signature.  After them: the counters (steps, tokens, recompiles,
skipped by reason) and the accumulation histogram moved as JAX's did,
the losses agree within 1e-4 relative, the spans have JAX's names and
parents, the flight recorder JAX's event kinds in JAX's order, and the
goodput split (productive against skipped seconds) is non-zero on the
same sides; the ported goodput and the fleet's straggler feed read a
port run.  ``train.straggler_delay`` sleeps inside the timed step."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu.nn as jnn
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.observability import default_registry as jregistry
from paddle_tpu.observability import flight_recorder as jrecorder
from paddle_tpu.observability.tracing import tracer as jtracer
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.robustness import clear_faults as jclear
from paddle_tpu.robustness import inject as jinject

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.observability import default_registry, flight_recorder
from paddle_tpu_torch.observability import goodput
from paddle_tpu_torch.observability.tracing import tracer
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.robustness import clear_faults, inject

COUNTERS = ("paddle_tpu_train_steps_total", "paddle_tpu_train_tokens_total",
            "paddle_tpu_train_recompiles_total")
REASONS = ("nonfinite_loss", "nonfinite_grad")


def _raw(x):
    return x._data if hasattr(x, "_data") else x


def _pair():
    pp.seed(0)
    jm = jnn.Linear(8, 4)
    tm = tnn.Linear(8, 4, device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 8)).astype(np.float32),
            rng.standard_normal((b, 4)).astype(np.float32))


def _counters(reg):
    out = {n: reg.get(n).value() if reg.get(n) is not None else 0.0
           for n in COUNTERS}
    sk = reg.get("paddle_tpu_train_step_skipped_total")
    for r in REASONS:
        out[r] = sk.labels(reason=r).value() if sk is not None else 0.0
    acc = reg.get("paddle_tpu_train_accum_microbatches")
    out["accum_count"] = acc.count() if acc is not None else 0.0
    out["accum_sum"] = acc.sum() if acc is not None else 0.0
    for n in ("paddle_tpu_train_productive_seconds_total",
              "paddle_tpu_train_skipped_seconds_total"):
        out[n] = reg.get(n).value() if reg.get(n) is not None else 0.0
    return out


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _spans(tr):
    spans = tr.finished_spans()
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent_id"])) for s in spans)


def _run(pkg):
    """The step sequence on one package; (losses, counter deltas, spans,
    recorder kinds)."""
    jm, tm = _pair()
    if pkg == "jax":
        step = JTrainStep(jm, JAdamW(learning_rate=1e-2,
                                     parameters=jm.parameters()),
                          loss_fn=lambda o, y: ((_raw(o) - y) ** 2).mean(),
                          accum_steps=2)
        reg, rec, tr, arm, clear = (jregistry(), jrecorder(), jtracer(),
                                    jinject, jclear)
    else:
        step = TrainStep(tm, AdamW(learning_rate=1e-2),
                         loss_fn=lambda o, y: ((o - y) ** 2).mean(),
                         accum_steps=2)
        reg, rec, tr, arm, clear = (default_registry(), flight_recorder(),
                                    tracer(), inject, clear_faults)
    clear()
    rec.clear()
    tr.clear()
    before = _counters(reg)
    losses = []
    for i in range(5):
        if i == 2:
            arm("train.nonfinite_batch", times=1)
        batch = _batch(i, b=2 if i == 3 else 4)
        losses.append(float(_raw(step(batch))))
    clear()
    kinds = [e["kind"] for e in rec.snapshot()]
    return losses, _delta(_counters(reg), before), _spans(tr), kinds


@pytest.fixture(scope="module")
def runs():
    return _run("jax"), _run("port")


def test_losses_agree(runs):
    (jl, *_), (tl, *_) = runs
    assert np.isnan(jl[2]) and np.isnan(tl[2])
    for i in (0, 1, 3, 4):
        np.testing.assert_allclose(tl[i], jl[i], rtol=1e-4)


def test_counters_and_accum_histogram_equal_jaxs(runs):
    (_, jd, *_), (_, td, *_) = runs
    for k in COUNTERS + REASONS + ("accum_count", "accum_sum"):
        assert td[k] == jd[k], k
    assert td["paddle_tpu_train_steps_total"] == 5
    assert td["paddle_tpu_train_tokens_total"] == 4 + 4 + 4 + 2 + 4
    assert td["paddle_tpu_train_recompiles_total"] == 1
    assert td["nonfinite_loss"] == 1 and td["accum_sum"] == 10


def test_goodput_split_equal_sides(runs):
    (_, jd, *_), (_, td, *_) = runs
    for k in ("paddle_tpu_train_productive_seconds_total",
              "paddle_tpu_train_skipped_seconds_total"):
        assert td[k] > 0 and jd[k] > 0, k


def test_span_names_and_parents_equal_jaxs(runs):
    (_, _, js, _), (_, _, ts, _) = runs
    assert ts == js
    assert ("train.accum_microbatches", "train.dispatch") in ts
    assert ts.count(("train.step", None)) == 5


def test_recorder_kinds_equal_jaxs(runs):
    (*_, jk), (*_, tk) = runs
    assert tk == jk
    assert "train.step_skipped" in tk and "train.recompile" in tk


def test_goodput_and_fleet_feed_read_a_port_run():
    _, tm = _pair()
    step = TrainStep(tm, AdamW(learning_rate=1e-2),
                     loss_fn=lambda o, y: ((o - y) ** 2).mean())
    for i in range(3):
        step(_batch(10 + i))
    reg = default_registry()
    g = goodput.compute_goodput(reg, wall_s=1e6)
    assert g["productive_s"] > 0 and g["goodput"] > 0
    assert reg.get("paddle_tpu_train_step_ema_seconds").value() > 0


def test_loss_gauge_holds_the_step_tensor():
    """The loss and grad-norm gauges keep the step's own tensors (read
    at a scrape), not host floats."""
    _, tm = _pair()
    step = TrainStep(tm, AdamW(learning_rate=1e-2),
                     loss_fn=lambda o, y: ((o - y) ** 2).mean())
    loss = step(_batch(30))
    reg = default_registry()
    assert reg.get("paddle_tpu_train_loss")._value is loss
    assert torch.is_tensor(reg.get("paddle_tpu_train_grad_norm")._value)
    assert reg.get("paddle_tpu_train_loss").value() == float(loss)


def test_straggler_delay_sleeps_inside_the_step(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_STRAGGLER_DELAY_S", "0.05")
    _, tm = _pair()
    step = TrainStep(tm, AdamW(learning_rate=1e-2),
                     loss_fn=lambda o, y: ((o - y) ** 2).mean())
    hist = default_registry().get("paddle_tpu_train_step_seconds")
    step(_batch(40))
    s0 = hist.sum()
    inject("train.straggler_delay", times=1)
    try:
        step(_batch(41))
    finally:
        clear_faults()
    assert hist.sum() - s0 >= 0.05


def test_watermark_sampled_per_interval(monkeypatch):
    """On the CPU, where a sample walks the heap, the watermark is taken
    only when asked for; then every ``PADDLE_TPU_WATERMARK_INTERVAL``
    steps."""
    monkeypatch.delenv("PADDLE_TPU_DEVICE_WATERMARK", raising=False)
    _, tm = _pair()
    assert TrainStep(tm, AdamW(learning_rate=1e-2))._memmon is None
    monkeypatch.setenv("PADDLE_TPU_DEVICE_WATERMARK", "1")
    monkeypatch.setenv("PADDLE_TPU_WATERMARK_INTERVAL", "2")
    step = TrainStep(tm, AdamW(learning_rate=1e-2),
                     loss_fn=lambda o, y: ((o - y) ** 2).mean())
    seen = []
    monkeypatch.setattr(step._memmon, "sample",
                        lambda **kw: seen.append(kw["step"]))
    for i in range(5):
        step(_batch(50 + i))
    assert seen == [2, 4]
    monkeypatch.setenv("PADDLE_TPU_DEVICE_WATERMARK", "0")
    assert TrainStep(tm, AdamW(learning_rate=1e-2))._memmon is None


def test_unknown_card_leaves_mfu_unset(monkeypatch):
    """A device with no known roofline: ``compile()`` records one
    ``train.mfu_unavailable`` event, the steps run and the MFU gauge is
    not set by them."""
    import paddle_tpu_torch.jit.train_step as ts

    def unknown(device=None):
        raise RuntimeError("no roofline for 'some card': set "
                           "PADDLE_TPU_PEAK_FLOPS and PADDLE_TPU_HBM_BW")

    monkeypatch.setattr(ts, "detect_roofline", unknown)
    _, tm = _pair()
    step = TrainStep(tm, AdamW(learning_rate=1e-2),
                     loss_fn=lambda o, y: ((o - y) ** 2).mean())
    gauge = default_registry().get("paddle_tpu_train_mfu")
    gauge.set(-1.0)
    seq0 = flight_recorder().total_recorded
    step.compile(_batch(60))
    for i in range(2):
        assert np.isfinite(float(step(_batch(60 + i))))
    events = [e for e in flight_recorder().events()
              if e["seq"] > seq0 and e["kind"] == "train.mfu_unavailable"]
    assert len(events) == 1
    assert "PADDLE_TPU_PEAK_FLOPS" in events[-1]["reason"]
    assert gauge.value() == -1.0
