"""The port's measurement ledger and calibrated cost model
(``paddle_tpu_torch/observability/calibration.py``) against the JAX
package's on the CPU: keys and shape buckets; one file format, so a
ledger written by either package reads back equal in the other (and the
same records give the same bytes); corrupt, truncated and old-schema
files dropped; residuals and ``measured_for``; and the ``measured``
fusion tier: ``measured_tier_for`` answers ``decoder`` / ``segments``
where JAX's answers ``decoder`` / ``fused``, and a Llama layer is routed
accordingly.  Each test points both packages at its own directory."""

import json

import numpy as np
import pytest
import torch

from paddle_tpu.observability import calibration as jcal
from paddle_tpu.ops.pallas import fused_block as JFB

from paddle_tpu_torch.core.state import backend_fingerprint
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import calibration as cal
from paddle_tpu_torch.observability import device_profiler as DP
from paddle_tpu_torch.ops.kernels import fused_block as FB

SHAPES = [(4, 2048, 4096), (8, 1024, 2048), (7,), (3, 5), (), (1, 1, 1),
          (65, 33), "autotune|key"]
RECORDS = [("decoder_block", (4, 2048, 4096), "bfloat16", 0.012, 0.004,
            "tier=segments", "device_profiler"),
           ("decoder_block", (4, 2048, 4096), "bfloat16", 0.010, 0.004,
            "tier=segments", "device_profiler"),
           ("attention", (2, 16, 64), "float32", 3e-4, 1e-4, "-", "manual"),
           ("mlp", (2, 16, 64), "float32", 2e-4, 0.0, "tier=decoder",
            "bench")]


@pytest.fixture
def ledger_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION_DIR", str(tmp_path))
    cal.reset()
    jcal.reset()
    FB.clear_measured_tiers()
    yield tmp_path
    cal.reset()
    jcal.reset()
    FB.clear_measured_tiers()


def test_keys_and_buckets_equal_jaxs():
    for shape in SHAPES:
        assert cal.shape_bucket(shape) == jcal.shape_bucket(shape)
        assert cal.make_key("op", shape, "bfloat16", "tier=x", "b:k:n1") == \
            jcal.make_key("op", shape, "bfloat16", "tier=x", "b:k:n1")
    assert cal.LEDGER_VERSION == jcal.LEDGER_VERSION
    assert cal.make_key("op", (2, 3)).endswith("@" + backend_fingerprint())
    assert backend_fingerprint("cpu") == "cpu:cpu:n1"


def _fill(mod, path, backend):
    led = mod.MeasurementLedger(str(path))
    for op, shape, dt, meas, pred, layout, prov in RECORDS:
        led.record(op, shape, dt, measured_s=meas, predicted_s=pred,
                   layout=layout, provenance=prov, backend=backend,
                   save=False)
    led.save()
    return led


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_ledger_file_reads_equal_in_both(tmp_path, writer):
    path = tmp_path / "ledger.json"
    w, r = (jcal, cal) if writer == "jax" else (cal, jcal)
    _fill(w, path, "cpu:cpu:n1")
    got = r.MeasurementLedger(str(path)).entries()
    want = w.MeasurementLedger(str(path)).entries()
    assert got == want and len(got) == 3
    e = got[cal.make_key("decoder_block", (4, 2048, 4096), "bfloat16",
                         "tier=segments", "cpu:cpu:n1")]
    assert e["measured_s"] == 0.010 and e["n"] == 2
    assert e["mean_s"] == pytest.approx(0.011)


def test_same_records_same_bytes(tmp_path, monkeypatch):
    import time
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    _fill(jcal, tmp_path / "j.json", "x:y:n2")
    _fill(cal, tmp_path / "t.json", "x:y:n2")
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()


@pytest.mark.parametrize("content", [
    "{not json", '{"version": 1, "entries": {"k": {"measured_s": 1.0',
    json.dumps({"version": 0, "entries": {"k": {"measured_s": 1.0}}}),
    json.dumps({"version": 1, "entries": []}), json.dumps([1, 2])])
def test_bad_files_are_dropped_in_both(tmp_path, content):
    path = tmp_path / "ledger.json"
    path.write_text(content)
    for mod in (cal, jcal):
        led = mod.MeasurementLedger(str(path))
        assert led.entries() == {}
        led.record("op", (2, 2), measured_s=1.0, backend="b:k:n1")
        assert len(mod.MeasurementLedger(str(path)).entries()) == 1
        path.write_text(content)


def test_malformed_entries_are_dropped(tmp_path):
    path = tmp_path / "ledger.json"
    path.write_text(json.dumps({"version": 1, "entries": {
        "a": {"measured_s": 1.0}, "b": {"measured_s": -1.0},
        "c": {"measured_s": 1.0, "n": 0}, "d": "x",
        "e": {"measured_s": 2.0, "predicted_s": -3}}}))
    assert set(cal.MeasurementLedger(str(path)).entries()) == \
        set(jcal.MeasurementLedger(str(path)).entries()) == {"a"}


def test_residuals_and_measured_for_equal_jaxs(tmp_path):
    path = tmp_path / "ledger.json"
    backend = "cpu:cpu:n1"
    t = cal.CalibratedCostModel(_fill(cal, path, backend))
    j = jcal.CalibratedCostModel(jcal.MeasurementLedger(str(path)))
    for op, shape, dt, _, _, layout, _ in RECORDS + [
            ("missing", (1, 2), "", 0, 0, "-", "")]:
        args = (op, shape, dt, layout, backend)
        assert t.residual_for(*args) == j.residual_for(*args)
        assert t.measured_for(*args) == j.measured_for(*args)
        assert t.calibrate(1e-3, *args) == j.calibrate(1e-3, *args)
    assert t.coverage() == j.coverage()


def _route(kind):
    """Records that make `kind` ('decoder' or 'segments') faster at
    (1, 64, 256) on both packages' backends (JAX's per-segment tier is
    ``fused``)."""
    fast, slow = 1e-3, 2e-3
    shape = (1, 64, 256)
    t_dec, t_seg = (fast, slow) if kind == "decoder" else (slow, fast)
    for mod, seg_tier in ((cal, "segments"), (jcal, "fused")):
        led = mod.ledger()
        led.record("decoder_block_fused", shape, "float32",
                   measured_s=t_dec, layout="tier=decoder", save=False)
        led.record("decoder_block", shape, "float32", measured_s=t_seg,
                   layout=f"tier={seg_tier}", save=False)
        led.save()


@pytest.mark.parametrize("kind", ["decoder", "segments"])
def test_measured_tier_for_follows_jaxs(ledger_dir, kind):
    assert FB.measured_tier_for((1, 64, 256), "float32") == "segments"
    assert JFB.measured_tier_for((1, 64, 256), "float32") == "fused"
    FB.clear_measured_tiers()
    _route(kind)
    got = FB.measured_tier_for((1, 64, 256), torch.float32)
    want = JFB.measured_tier_for((1, 64, 256), "float32")
    assert got == kind
    assert want == ("decoder" if kind == "decoder" else "fused")
    # the answer is kept: a later record does not move a cached route
    _route("segments" if kind == "decoder" else "decoder")
    assert FB.measured_tier_for((1, 64, 256), "float32") == kind


@pytest.mark.parametrize("kind", ["decoder", "segments"])
def test_llama_layers_routed_by_the_ledger(ledger_dir, monkeypatch, kind):
    """At ``PADDLE_TPU_FUSED_BLOCK=measured`` each layer of a
    decoder-eligible Llama goes where the ledger says, and the output is
    the decoder tier's or the per-segment path's, exactly."""
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1,
                           max_position_embeddings=128)
    model = LlamaForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                             (1, 64)))
    _route(kind)
    ref = {}
    with torch.no_grad():
        for knob in ("decoder", ""):
            monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", knob)
            ref[knob or "segments"] = model(ids)
        monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "measured")
        FB.fused_decoder_block.routes = {"decoder": 0, "segments": 0}
        got = model(ids)
    assert FB.fused_decoder_block.routes[kind] == cfg.num_hidden_layers
    assert torch.equal(got, ref[kind])


def test_profiler_feeds_the_ledger_under_its_tier(ledger_dir, monkeypatch):
    """With ``PADDLE_TPU_CALIBRATION=1`` the profiled ``decoder_block``
    (at the segments tier) and ``decoder_block_fused`` (at the decoder
    tier) land under their tiers, and ``measured_tier_for`` names the one
    measured faster."""
    monkeypatch.setenv("PADDLE_TPU_CALIBRATION", "1")
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512,
                           num_attention_heads=2, num_key_value_heads=1)
    model = LlamaForCausalLM(cfg, device="cpu")
    ids = np.random.default_rng(1).integers(0, 256, (1, 65))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    segs = {s.name: s for s in DP.llama_step_segments(model, batch,
                                                      grad=False)}
    for knob, name in (("", "decoder_block"),
                       ("decoder", "decoder_block_fused")):
        monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", knob)
        DP.DeviceProfiler(device="cpu").add(segs[name]).profile(reps=1)
    model_ = cal.CalibratedCostModel()
    t_seg = model_.measured_for("decoder_block", (1, 64, 256), "float32",
                                layout="tier=segments")
    t_dec = model_.measured_for("decoder_block_fused", (1, 64, 256),
                                "float32", layout="tier=decoder")
    assert t_seg and t_dec
    saved = json.loads((ledger_dir / "ledger.json").read_text())
    assert len(saved["entries"]) == 2
    want = "decoder" if t_dec < t_seg else "segments"
    assert FB.measured_tier_for((1, 64, 256), "float32") == want
    assert cal.bench_detail()["entries"] == 2
