"""``static`` of the port against the JAX package's on the CPU: the
``static.nn`` builders (fc, embedding, conv2d, batch_norm, layer_norm)
run in both packages with JAX's parameters carried into the port's
program scope by name; outputs and the running statistics agree within
1e-5 relative, 1e-6 absolute (fp32; products and convolutions sum in
other orders).  Held too: ``program_guard``'s name reuse and the
reference's auto-names, the scope's refusals, training through the
builders, and ``save_inference_model`` / ``load_inference_model`` over
``jit``."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu import static as jstatic

import paddle_tpu_torch as tp
from paddle_tpu_torch import static

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_programs():
    tp.set_device("cpu")
    jstatic.reset_program()
    static.reset_program()
    yield
    jstatic.reset_program()
    static.reset_program()
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


def _carry():
    """JAX's builder parameters into the port's scope, by name."""
    with torch.no_grad():
        for p in jstatic.nn.parameters():
            static.nn._PARAMS[p.name].copy_(torch.from_numpy(
                np.array(p.numpy())))


def _both(build, x):
    """`build(static_module, x)` in JAX and in the port (twice: the first
    call creates the port's parameters, JAX's are carried in, the second
    resolves to them under program_guard)."""
    with jstatic.program_guard():
        want = build(jstatic, pp.to_tensor(x))
    with static.program_guard():
        build(static, torch.from_numpy(x))
    assert sorted(p.name for p in static.nn.parameters()) == \
        sorted(p.name for p in jstatic.nn.parameters())
    _carry()
    with static.program_guard():
        got = build(static, torch.from_numpy(x))
    return np.asarray(want.numpy()), got.detach().numpy()


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


BUILDERS = {
    "fc": (lambda s, x: s.nn.fc(x, 16, activation="relu"), _x(4, 8)),
    "fc_flatten": (lambda s, x: s.nn.fc(x, 5, num_flatten_dims=2),
                   _x(2, 3, 4, 2)),
    "conv2d": (lambda s, x: s.nn.conv2d(x, 4, 3, padding=1,
                                        activation="relu"), _x(2, 3, 8, 8)),
    "conv2d_stride_groups": (lambda s, x: s.nn.conv2d(
        x, 4, (3, 3), stride=2, groups=2), _x(2, 4, 9, 9)),
    "batch_norm_train": (lambda s, x: s.nn.batch_norm(x), _x(8, 4, 5, 5)),
    "batch_norm_test": (lambda s, x: s.nn.batch_norm(x, is_test=True),
                        _x(8, 4, 5, 5)),
    "layer_norm": (lambda s, x: s.nn.layer_norm(x, begin_norm_axis=2),
                   _x(2, 3, 8)),
    "stack": (lambda s, x: s.nn.fc(s.nn.batch_norm(s.nn.conv2d(
        x, 4, 3, padding=1, activation="relu")), 10), _x(2, 3, 8, 8)),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_equals_jaxs(name):
    build, x = BUILDERS[name]
    want, got = _both(build, x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_embedding_equals_jaxs():
    ids = np.array([[1, 2, 3], [0, 15, 7]], np.int64)
    with jstatic.program_guard():
        want = jstatic.nn.embedding(pp.to_tensor(ids), size=[16, 8])
    with static.program_guard():
        static.nn.embedding(torch.from_numpy(ids), size=[16, 8])
    _carry()
    with static.program_guard():
        got = static.nn.embedding(torch.from_numpy(ids), size=[16, 8])
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(want.numpy()))


def test_batch_norm_running_stats_are_jaxs():
    """Training mode moves the scope's running statistics as JAX's does
    (momentum 0.9, biased batch variance), over two calls."""
    x = _x(8, 4, 5, 5) * 2.0 + 3.0
    for _ in range(2):
        with jstatic.program_guard():
            jstatic.nn.batch_norm(pp.to_tensor(x), name="bn")
        with static.program_guard():
            static.nn.batch_norm(torch.from_numpy(x), name="bn")
    for stat in ("bn.mean", "bn.var"):
        j = next(p for p in jstatic.nn.parameters() if p.name == stat)
        t = static.nn._PARAMS[stat]
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j.numpy()),
                                   rtol=RTOL, atol=ATOL)
        assert not t.requires_grad


def test_program_guard_reuses_names():
    x = torch.from_numpy(_x(4, 8))
    with static.program_guard():
        y1 = static.nn.fc(x, 16, activation="relu")
        static.nn.fc(y1, 4)
    with static.program_guard():
        y2 = static.nn.fc(x, 16, activation="relu")
    assert torch.equal(y1, y2)
    names = sorted(p.name for p in static.nn.parameters())
    assert names == ["fc_0.b", "fc_0.w", "fc_1.b", "fc_1.w"]
    # a guard restores the counters it found (empty here), as JAX's
    # does: the next unguarded fc is fc_0 again, the same parameters
    assert torch.equal(static.nn.fc(x, 16, activation="relu"), y1)
    assert len(static.nn.parameters()) == 4


def test_scope_refusals():
    x = torch.from_numpy(_x(4, 8))
    with static.program_guard():
        static.nn.fc(x, 16, name="shared")
    with pytest.raises(ValueError, match="same parameter"):
        static.nn.fc(x, 32, name="shared")
    spec = static.data("x", [None, 8], "float32")
    assert isinstance(spec, tp.jit.InputSpec) and spec.name == "x"
    with pytest.raises(TypeError, match="to_static"):
        static.nn.fc(spec, 16)


def test_same_shape_layers_differ_at_init():
    x = torch.from_numpy(_x(4, 16))
    with static.program_guard():
        h = static.nn.fc(x, 16, name="a")
        static.nn.fc(h, 16, name="b")
    assert not torch.equal(static.nn._PARAMS["a.w"],
                           static.nn._PARAMS["b.w"])


def test_fc_trains():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype("float32"))
    y = torch.from_numpy((rng.normal(size=(16, 1)) > 0).astype("float32"))

    def forward():
        with static.program_guard():
            h = static.nn.fc(x, 16, activation="tanh")
            return static.nn.fc(h, 1)

    forward()
    opt = tp.optimizer.Adam(learning_rate=5e-2,
                            parameters=static.nn.parameters())
    losses = []
    for _ in range(15):
        loss = tp.nn.functional.binary_cross_entropy_with_logits(forward(), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.8


def test_inference_model_round_trip_is_jaxs(tmp_path):
    """save_inference_model / load_inference_model over jit, in both
    packages, on the same weights."""
    pp.seed(0)
    jnet = pp.nn.Sequential(pp.nn.Linear(8, 16), pp.nn.ReLU(),
                            pp.nn.Linear(16, 4))
    tnet = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.ReLU(),
                            tp.nn.Linear(16, 4))
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    jstatic.save_inference_model(str(tmp_path / "j"),
                                 [jstatic.InputSpec([2, 8], "float32")],
                                 jnet)
    static.save_inference_model(str(tmp_path / "t"),
                                [static.InputSpec([2, 8], "float32")],
                                None, layer=tnet)
    x = _x(2, 8, seed=3)
    want = jstatic.load_inference_model(str(tmp_path / "j"))(x)
    got = static.load_inference_model(str(tmp_path / "t"), device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="Layer"):
        static.save_inference_model(str(tmp_path / "n"), [x], None)
