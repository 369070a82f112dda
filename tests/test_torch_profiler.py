"""The port's ``paddle_tpu_torch.profiler`` against the JAX package's
``paddle_tpu.profiler`` on the CPU: ``make_scheduler``'s states step by
step; a ``RecordEvent`` in ``summary()`` and, as a
``torch.profiler.record_function`` range, in the exported chrome trace,
which ``load_profiler_result`` reads back; the device section of the
summary from ``segment_records()``; and the observability demo (with
its fleet phase) run in this process on the CPU, exit code 0."""

import os

import pytest
import torch

import paddle_tpu.profiler as jprofiler

import paddle_tpu_torch.profiler as profiler
from paddle_tpu_torch.observability import demo
from paddle_tpu_torch.observability import device_profiler as DP


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2),
    dict(closed=0, ready=0, record=3, repeat=2),
    dict(closed=2, ready=1, record=1, repeat=1, skip_first=3)])
def test_scheduler_states_equal_jaxs(kw):
    ours, theirs = profiler.make_scheduler(**kw), jprofiler.make_scheduler(**kw)
    assert [ours(i).name for i in range(20)] == \
        [theirs(i).name for i in range(20)]


def test_record_event_in_summary_and_trace(tmp_path):
    prof = profiler.Profiler(log_dir=str(tmp_path / "log"),
                             targets=[profiler.ProfilerTarget.CPU])
    with prof:
        with profiler.RecordEvent("my_forward", event_type="Forward"):
            torch.randn(64, 64) @ torch.randn(64, 64)
        prof.step(num_samples=4)
    table = prof.summary()
    assert "my_forward" in table and "Forward" in table
    path = str(tmp_path / "trace.json")
    prof.export(path)
    events = profiler.load_profiler_result(path)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("my_forward") >= 2     # the range and the host event
    assert any(e.get("cat") == "Forward" for e in events)
    assert any("mm" in str(n) for n in names)  # the CPU operator
    assert os.path.exists(tmp_path / "log" / "trace_0.json")
    assert "samples/s" in prof.step_info()


def test_decorator_and_benchmark():
    @profiler.RecordEvent("decorated")
    def f(x):
        return x + 1
    prof = profiler.Profiler(timer_only=True)
    with prof:
        assert f(1) == 2
    assert "decorated" in prof.summary()
    with profiler.benchmark() as box:
        pass
    assert box["seconds"] >= 0


def test_gpu_target_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiler.Profiler(targets=[profiler.ProfilerTarget.GPU])


def test_summary_device_section_from_segment_records():
    x = torch.randn(16, 16)
    prof = DP.DeviceProfiler(device="cpu")
    prof.add_segment("summary_matmul", lambda a: a @ a, x)
    prof.profile(reps=1)
    table = profiler.Profiler(timer_only=True).summary()
    assert "-- device time / roofline" in table and "summary_matmul" in table


def test_format_diagnostics_renders_the_cost_model():
    import paddle_tpu_torch.analysis as analysis
    report = analysis.check(lambda a: a @ a, torch.ones(8, 8),
                            passes=["cost-model"])
    prof = profiler.Profiler(timer_only=True)
    prof.add_analysis(report)
    table = prof.summary()
    assert "cost-model" in table and "aten.mm" in table


def test_demo_runs_on_the_cpu(tmp_path, capsys):
    """The demo with its fleet phase (the forensics phase, a serving
    drill of several engines, runs on the card in chip_smoke.py's demo
    phase and from the command line here)."""
    rc = demo.main(["--device", "cpu",
                    "--trace-out", str(tmp_path / "t.json"),
                    "--fleet-trace-out", str(tmp_path / "f.json"),
                    "--fleet"])
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    assert "paddle_tpu_train_step_seconds_bucket" in out.out
    assert "[demo] OK" in out.err


def test_demo_defaults_to_the_card(tmp_path, monkeypatch):
    """Without ``--device`` the demo asks for the card, and where there
    is none it raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--trace-out", str(tmp_path / "t.json")])
