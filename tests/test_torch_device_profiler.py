"""The port's device profiler (``paddle_tpu_torch/observability/
device_profiler.py``) against the JAX package's on the CPU.

``llama_step_segments`` of a tiny Llama (fp32, the same weights through
``set_state_dict``, JAX's activation) gives JAX's names, counts and
groups, and each segment's output equals JAX's within 1e-5 of its
largest element; signatures carry JAX's ``dtype[shape]`` leaves; the
profile ranks by gap and lists a segment that cannot be captured; the
memory monitor's watermark and leak detector follow JAX's on the same
samples, and its census names live tensors; ``TrainStep.compile()`` and
``aot_warmup`` record ``CompileInfo`` and move the compile counter and
gauges as the JAX package's do.  Timing here is the host clock: no
number from this file is a device time."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.observability import default_registry as jdefault_registry
from paddle_tpu.observability import device_profiler as JDP
from paddle_tpu.observability.metrics import MetricsRegistry as JRegistry
from paddle_tpu.optimizer import AdamW as JAdamW

from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import default_registry
from paddle_tpu_torch.observability import device_profiler as DP
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from paddle_tpu_torch.optimizer import AdamW

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
TOL = 1e-5


def _pair(seed=0):
    pp.seed(seed)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed=1, b=2, s=16):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s + 1))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


@pytest.fixture(scope="module")
def segs():
    jm, tm = _pair()
    batch = _batch()
    js = JDP.llama_step_segments(jm, batch)
    x = torch.from_numpy(np.asarray(js[1].args[1]))
    return js, DP.llama_step_segments(tm, batch, x=x)


def test_segment_names_counts_groups_equal_jax(segs):
    js, ts = segs
    assert [(s.name, s.count, s.group) for s in ts] == \
        [(s.name, s.count, s.group) for s in js]
    assert len(ts) == 10
    assert [s.name for s in DP.llama_step_segments(
        _pair()[1], _batch(), grad=False)] == [s.name for s in ts[:8]]


def _flat(out):
    """The arrays of a segment's output, in order (a dict by sorted
    key, as JAX's tree flattening)."""
    if isinstance(out, dict):
        return [a for k in sorted(out) for a in _flat(out[k])]
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out.detach() if torch.is_tensor(out) else out,
                       dtype=np.float64)]


def _close(got, ref, what):
    got, ref = _flat(got), _flat(ref)
    assert len(got) == len(ref), what
    for g, r in zip(got, ref):
        assert g.shape == r.shape, what
        scale = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= TOL * scale, what


@pytest.mark.parametrize("name", ["embed", "rmsnorm", "rmsnorm_qkv",
                                  "attention", "mlp", "decoder_block",
                                  "decoder_block_fused", "lm_head_ce"])
def test_forward_segment_outputs_equal_jax(segs, name):
    js, ts = (next(s for s in group if s.name == name) for group in segs)
    _close(ts.fn(*ts.args, **ts.kwargs), js.fn(*js.args, **js.kwargs), name)


@pytest.mark.parametrize("name", ["attention_fwdbwd", "mlp_fwdbwd"])
def test_fwdbwd_segments_equal_jax(segs, name):
    """The value and the gradients in every parameter (by name) and in
    x, against ``jax.value_and_grad``."""
    js, ts = (next(s for s in group if s.name == name) for group in segs)
    jval, (jgp, jgx) = js.fn(*js.args, **js.kwargs)
    val, grads = ts.fn(*ts.args, **ts.kwargs)
    names = list(ts.args[0])
    _close(val, jval, name)
    _close(grads[-1], jgx, name + " dx")
    for n, g in zip(names, grads):
        _close(g, jgp[n], f"{name} d{n}")


def test_signatures_carry_jaxs_leaves():
    batch = {"labels": np.zeros((2, 16), np.int32),
             "input_ids": np.zeros((2, 16), np.int32)}
    sig = DP.signature_of(batch)
    assert sig.split("|")[1] == JDP.signature_of(batch).split("|")[1]
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert DP.signature_of(t) == sig
    assert DP.signature_of({**t, "labels": t["labels"][:, :8]}) != sig
    assert DP.signature_of({**t, "labels": t["labels"].long()}) != sig
    assert DP.signature_of((t["labels"], 3)).endswith("int64[]")


def test_rooflines():
    assert DP.detect_roofline("cpu") == DP._HOST_ROOFLINE
    assert DP.roofline_source("cpu").startswith("host")
    assert DP.GPU_ROOFLINES["h100"] == (989e12, 3.35e12)


def test_roofline_env_overrides(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "1e12")
    assert DP.detect_roofline("cpu") == (1e12, DP._HOST_ROOFLINE[1])
    monkeypatch.setenv("PADDLE_TPU_HBM_BW", "2e9")
    assert DP.detect_roofline("cpu") == (1e12, 2e9)


def test_profile_ranks_by_gap_and_lists_skipped(segs):
    _, ts = segs
    reg = MetricsRegistry()
    prof = DP.DeviceProfiler(device="cpu", registry=reg)
    for s in ts[:5]:
        prof.add(s)

    def broken(x):
        raise RuntimeError("cannot run")
    prof.add_segment("broken", broken, torch.ones(2))
    res = prof.profile(reps=2, warmup=0)
    assert [r.name for r in res.segments] == [s.name for s in ts[:5]]
    assert res.skipped and res.skipped[0][0] == "broken"
    assert "cannot run" in res.skipped[0][1]
    gaps = [r.gap for r in res.ranked()]
    assert gaps == sorted(gaps, reverse=True)
    assert res.device == "cpu" and {r.device for r in res.segments} == {"cpu"}
    table = res.table()
    assert all(s.name in table for s in ts[:5]) and "broken" in table
    for r in res.segments:
        assert r.device_s > 0 and r.predicted_s > 0 and r.bytes_accessed > 0
        assert r.gap == r.device_s / r.predicted_s
        assert r.heaviest
    assert reg.get("paddle_tpu_device_segment_seconds") is not None
    assert reg.get("paddle_tpu_compile_total").labels(
        target="mlp").value() == 1
    assert DP.segment_records("mlp")[-1] is res.segments[4]
    assert prof.records("mlp") == [res.segments[4]]


def _leak_run(mod, reg, samples):
    mon = mod.DeviceMemoryMonitor(registry=reg, leak_window=4,
                                  leak_min_bytes=100)
    for v in samples:
        mon.sample(live_bytes=v, buffers=1)
    return mon


def test_memory_monitor_follows_jax():
    samples = [1000, 900, 1000, 1100, 1250, 1400, 1300, 1400, 1450, 1460,
               1500, 5000]
    mon = _leak_run(DP, MetricsRegistry(), samples)
    jreg = JRegistry()
    jmon = _leak_run(JDP, jreg, samples)
    assert mon.watermark == jmon.watermark == 5000
    leaks = mon._leaks.value()
    assert leaks == jmon._leaks.value() == 2
    assert mon._watermark_g.value() == 5000.0


def test_memory_monitor_measures_and_names_live_tensors():
    reg = MetricsRegistry()
    mon = DP.DeviceMemoryMonitor(registry=reg, device="cpu")
    before, _ = mon.measure()
    keep = torch.zeros((1023, 1031), dtype=torch.float32)
    after, _ = mon.measure()
    # other tests' tensors freed in between may take a few bytes off
    assert after - before >= keep.numel() * 4 - (64 << 10)
    rows = mon.census(top=1000)
    row = next(r for r in rows if r["shape"] == [1023, 1031])
    assert row["dtype"] == "float32" and row["bytes"] >= 1023 * 1031 * 4
    assert mon.sample() > 0 and mon.watermark > 0
    del keep


def _compile_count(reg, target):
    m = reg.get("paddle_tpu_compile_total")
    return m.labels(target=target).value() if m is not None else 0.0


def test_train_step_compile_records_as_jax():
    """``compile()`` on both packages: one ``CompileInfo`` under
    ``TrainStep(LlamaForCausalLM)`` and the compile counter up by one;
    the port's stats are the cost model's count of the step (FLOPs at
    least the forward's and backward's products), its FLOPs gauge set,
    and the MFU gauge set by the next step."""
    jm, tm = _pair(2)
    target = "TrainStep(LlamaForCausalLM)"
    batch = _batch(3)
    jstep = JTrainStep(jm, JAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters()))
    step = TrainStep(tm, AdamW(learning_rate=1e-3))
    j0 = _compile_count(jdefault_registry(), target)
    t0 = _compile_count(default_registry(), target)
    jinfo = jstep.compile(batch)
    info = step.compile(batch)
    assert _compile_count(jdefault_registry(), target) == j0 + 1
    assert _compile_count(default_registry(), target) == t0 + 1
    assert info.target == jinfo.target == target
    assert DP.compile_records(target)[-1] is info
    assert not info.graph and info.launches == {} and not info.cached
    assert info.seconds == info.lower_s + info.compile_s
    # 6 x the parameters' products a token, at least (fwd + bwd)
    n_tok = batch["input_ids"].size
    assert info.stats.flops >= 6 * 0.5 * sum(
        p.numel() for p in tm.parameters()) * n_tok
    assert info.cost.product_flops > 0
    assert default_registry().get("paddle_tpu_xla_flops").labels(
        executable=target).value() == info.stats.flops
    step(batch)
    mfu = default_registry().get("paddle_tpu_train_mfu").value()
    assert 0 < mfu


def test_aot_warmup_records_each_program():
    """The slot engine's programs: a ``CompileInfo`` and one more compile
    each, under the JAX engine's targets; the decode and prefill programs
    counted (their first warm-up), the insert (no warm-up) not."""
    _, tm = _pair(4)
    eng = ContinuousBatchingEngine(tm, slots=2, max_len=64,
                                   prefill_buckets=(16,))
    targets = ("serving.decode", "serving.insert", "serving.prefill[16]")
    before = {t: _compile_count(default_registry(), t) for t in targets}
    stats = eng.aot_warmup()
    assert set(stats) == set(targets)
    for t in targets:
        assert _compile_count(default_registry(), t) == before[t] + 1
        info = DP.compile_records(t)[-1]
        assert info.target == t and not info.graph
    assert DP.compile_records("serving.decode")[-1].stats.flops > 0
    assert DP.compile_records("serving.prefill[16]")[-1].stats.flops > 0
    assert DP.compile_records("serving.insert")[-1].stats.flops == 0
    eng.close()


def test_aot_compile_spans_and_replay():
    from paddle_tpu_torch.observability.tracing import tracer
    x = torch.randn(8, 8)
    compiled, info = DP.aot_compile(lambda a, b: a @ b, x, x,
                                    target="matmul8")
    torch.testing.assert_close(compiled(), x @ x)
    assert info.stats.flops == 2 * 8 * 8 * 8
    assert DP.compiled_stats(compiled, info.cost) == info.stats
    names = [s["name"] for s in tracer().finished_spans(last=6)]
    assert {"compile", "compile.lower", "compile.xla"} <= set(names)
    with pytest.raises(ValueError, match="no tensor argument"):
        DP.aot_compile(lambda: 1, target="none")
