"""The predictor API of the port (``inference.Config``, the handles,
``Predictor``, ``create_predictor``, ``PredictorPool``) against the JAX
package's on the CPU, over artifacts each package saved of the same
weights (the JAX package's ``small_net``: Linear, GELU, Linear).  fp32
outputs within 1e-5 relative, 1e-6 absolute (XLA and torch sum the
products in other orders); names, shapes and the Config's recorded
knobs equal."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu import inference as jinf
from paddle_tpu import jit as jjit

import paddle_tpu_torch as tp
from paddle_tpu_torch import inference, jit

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


@pytest.fixture
def saved(tmp_path):
    """(jax prefix, port prefix) of the same net, dynamic batch."""
    pp.seed(0)
    jnet = pp.nn.Sequential(pp.nn.Linear(8, 16), pp.nn.GELU(),
                            pp.nn.Linear(16, 4))
    tnet = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.GELU(),
                            tp.nn.Linear(16, 4))
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    spec = ([None, 8], "float32", "feat")
    jjit.save(jnet, str(tmp_path / "j"), input_spec=[jjit.InputSpec(*spec)])
    jit.save(tnet, str(tmp_path / "t"), input_spec=[jit.InputSpec(*spec)])
    return str(tmp_path / "j"), str(tmp_path / "t")


def _x(b, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 8)).astype(
        np.float32)


def test_config_is_jaxs(saved):
    jp, tpref = saved
    jc, tc = jinf.Config(jp + ".pdmodel"), inference.Config(tpref + ".pdmodel")
    assert tc.model_dir() == tpref and jc.model_dir() == jp
    for c in (jc, tc):
        c.enable_use_gpu(100, 0)
        c.enable_tensorrt_engine()
        c.enable_mkldnn()
        c.switch_ir_optim(False)
        c.enable_memory_optim()
        c.set_cpu_math_library_num_threads(4)
    assert tc._flags == jc._flags
    tc.set_model(tpref + ".pdmodel")
    assert tc.model_dir() == tpref
    tc.disable_gpu()
    assert tc.device() == "cpu"


@pytest.mark.parametrize("b", [1, 3])
def test_predictor_run_is_jaxs(saved, b):
    jp, tpref = saved
    jpred = jinf.create_predictor(jinf.Config(jp))
    tpred = inference.create_predictor(inference.Config(tpref))
    assert tpred.get_input_names() == jpred.get_input_names() == ["feat"]
    x = _x(b, b)
    for pred in (jpred, tpred):
        pred.get_input_handle("feat").copy_from_cpu(x)
    want, got = jpred.run(), tpred.run()
    assert len(got) == len(want) == 1 and isinstance(got[0], np.ndarray)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert tpred.get_output_names() == jpred.get_output_names() == ["out0"]
    h = tpred.get_output_handle("out0")
    np.testing.assert_array_equal(h.copy_to_cpu(), got[0])
    assert h.shape == [b, 4]
    # run(inputs) copies them into the handles first
    np.testing.assert_allclose(tpred.run([x])[0], jpred.run([x])[0],
                               rtol=RTOL, atol=ATOL)


def test_handle_reshape_is_jaxs():
    for mod in (jinf, inference):
        h = mod._Handle()
        h.reshape([2, 3])
        assert h.shape is None
        h.copy_from_cpu(np.arange(6, dtype=np.float32))
        assert h.shape == [2, 3]
        h.reshape([3, 2])
        assert h.shape == [3, 2]
        h.reshape([4, 4])
        assert h.shape is None


def test_bfloat16_outputs_widen_to_float32(tmp_path):
    tnet = tp.nn.Linear(8, 4).astype("bfloat16")
    jit.save(tnet, str(tmp_path / "b"),
             input_spec=[jit.InputSpec([2, 8], "bfloat16")])
    pred = inference.create_predictor(inference.Config(str(tmp_path / "b")))
    x = torch.from_numpy(_x(2)).bfloat16()
    pred.get_input_handle(pred.get_input_names()[0])._value = x
    out = pred.run()[0]
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, tnet(x).float().detach().numpy())


def test_pool_shares_one_program_and_parameters(saved):
    jp, tpref = saved
    jpool = jinf.PredictorPool(jinf.Config(jp), size=3)
    pool = inference.PredictorPool(inference.Config(tpref), size=3)
    preds = [pool.retrieve(i) for i in range(3)]
    assert all(p._layer is preds[0]._layer for p in preds)
    assert all(p._layer._params[0].data_ptr() ==
               preds[0]._layer._params[0].data_ptr() for p in preds)
    assert len({id(p.get_input_handle("feat")) for p in preds}) == 3
    for i, pred in enumerate(preds):
        x = _x(i + 1, i)
        want = jpool.retrieve(i).run([x])[0]
        np.testing.assert_allclose(pred.run([x])[0], want, rtol=RTOL,
                                   atol=ATOL)


def test_predictor_device_rule(saved, monkeypatch):
    """The predictor loads on the default device (the card unless
    set_device named the CPU) and on the CPU after disable_gpu()."""
    _, tpref = saved
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")
    cfg = inference.Config(tpref)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            inference.create_predictor(cfg)
    cfg.disable_gpu()
    assert inference.create_predictor(cfg)._layer.device.type == "cpu"
