"""chip_smoke.py's per-launch reading of the MLP / FFN split-K call.

`splitk_launches` reads the two launches' device times from a profiler
window; a window that shows no device event is read again, up to
`PROFILE_SESSIONS` windows, and the call fails if none showed both
launches.  The profiler runs only on the card, so here `launch_us` is
replaced by a stand-in that returns the windows given."""

import chip_smoke

UP = "void (anonymous namespace)::mlp_splitk_kernel<1, 0, 1>(MlpSplitArgs)"
DOWN = "void (anonymous namespace)::mlp_splitk_kernel<2, 0, 1>(MlpSplitArgs)"
SHAPE = (512, 2048, 2 << 20)


def _windows(monkeypatch, windows):
    seen = iter(windows)
    calls = []

    def launch_us(timer, fn, iters=5):
        calls.append(fn)
        return next(seen)

    monkeypatch.setattr(chip_smoke, "launch_us", launch_us)
    return calls


def test_splitk_launches_reads_an_empty_window_again(monkeypatch):
    calls = _windows(monkeypatch, [{}, {UP: 7.0, DOWN: 12.0}])
    out = chip_smoke.splitk_launches(None, "fn", 0.0185, SHAPE, SHAPE, 132)
    assert calls == ["fn", "fn"]
    assert out["profiler_sessions"] == 2
    assert out["up"]["us"] == 7.0
    assert out["down"]["profiled_span_us"] == 12.0
    # the down launch's share is the rest of the timed call
    assert abs(out["down"]["us"] - (18.5 - 7.0)) < 1e-9


def test_splitk_launches_fails_when_no_window_shows_both(monkeypatch):
    n = chip_smoke.PROFILE_SESSIONS
    calls = _windows(monkeypatch, [{UP: 7.0}] * n)
    try:
        chip_smoke.splitk_launches(None, "fn", 0.0185, SHAPE, SHAPE, 132)
    except AssertionError as e:
        assert "not both profiled" in str(e)
    else:
        raise AssertionError("a window without the down launch passed")
    assert len(calls) == n
