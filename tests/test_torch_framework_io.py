"""``framework.save`` / ``load`` of the port against the JAX package's
on the CPU: files written by one package load in the other, values
bitwise for fp32, int32 and int64, with the ``Parameter`` / tensor tags
(``trainable``, ``stop_gradient``, ``name``) kept and ``return_numpy``;
bfloat16 both ways with ``ml_dtypes`` hidden from the port; a JAX-saved
LeNet gives the port's model JAX's logits (fp32 convolutions sum in
another order than XLA's: 1e-5)."""

import pickle
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.framework import io_ as J
from paddle_tpu.vision.models import LeNet as JLeNet

import paddle_tpu_torch as tp
from paddle_tpu_torch.core.tensor import Parameter
from paddle_tpu_torch.framework import io_ as T
from paddle_tpu_torch.vision.models import LeNet

DTYPES = [np.float32, np.int32, np.int64]


def _arr(dtype, shape=(3, 4), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(-2 ** 30, 2 ** 30, shape).astype(dtype)


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int16).numpy().tobytes()


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_jax_file_loads_in_the_port(tmp_path, dtype):
    a, b = _arr(dtype, seed=1), _arr(dtype, (5,), seed=2)
    p = JParameter(a, trainable=False, name="w0")
    t = JTensor(b, stop_gradient=True)
    J.save({"p": p, "nested": [t, (3, "x")], "raw": a}, str(tmp_path / "f"))
    got = T.load(str(tmp_path / "f"))
    assert isinstance(got["p"], Parameter) and got["p"].name == "w0"
    assert got["p"].trainable is False
    np.testing.assert_array_equal(got["p"].detach().numpy(), a)
    # JAX without x64 holds an int64 Parameter as int32: its file says so
    stored = np.asarray(p._data).dtype
    assert got["p"].dtype == torch.from_numpy(np.zeros(1, stored)).dtype
    assert torch.is_tensor(got["nested"][0]) and \
        not got["nested"][0].requires_grad
    np.testing.assert_array_equal(got["nested"][0].numpy(), b)
    assert got["nested"][1] == (3, "x")
    assert type(got["raw"]) is np.ndarray
    np.testing.assert_array_equal(got["raw"], a)
    raw = T.load(str(tmp_path / "f"), return_numpy=True)
    assert type(raw["p"]) is np.ndarray and raw["p"].dtype == stored
    np.testing.assert_array_equal(raw["p"], a)
    np.testing.assert_array_equal(raw["nested"][0], b)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_port_file_loads_in_jax(tmp_path, dtype):
    a, b = _arr(dtype, seed=3), _arr(dtype, (2, 2), seed=4)
    p = Parameter(torch.from_numpy(a), trainable=dtype == np.float32,
                  name="w1")
    t = torch.from_numpy(b)
    if dtype == np.float32:
        t.requires_grad_(True)
    T.save({"p": p, "t": [t], "n": 7}, str(tmp_path / "f"))
    got = J.load(str(tmp_path / "f"))
    assert isinstance(got["p"], JParameter) and got["p"].name == "w1"
    assert got["p"].trainable == (dtype == np.float32)
    np.testing.assert_array_equal(np.asarray(got["p"]._data), a)
    assert np.asarray(got["p"]._data).dtype == np.dtype(dtype) or \
        dtype == np.int64          # JAX without x64 holds int64 as int32
    assert isinstance(got["t"][0], JTensor)
    assert got["t"][0].stop_gradient == (dtype != np.float32)
    np.testing.assert_array_equal(np.asarray(got["t"][0]._data), b)
    raw = J.load(str(tmp_path / "f"), return_numpy=True)
    assert raw["p"].dtype == np.dtype(dtype)
    np.testing.assert_array_equal(raw["p"], a)
    assert raw["n"] == 7


def test_files_are_the_same_pickle(tmp_path):
    """fp32 / int state dicts: the port's file is JAX's, byte for byte."""
    a, b = _arr(np.float32), _arr(np.int64, (4,))
    J.save({"a": a, "b": [b, 1.5]}, str(tmp_path / "j"))
    T.save({"a": a, "b": [b, 1.5]}, str(tmp_path / "t"))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()


def test_bf16_both_ways_without_ml_dtypes(tmp_path, monkeypatch):
    """JAX writes ml_dtypes bfloat16 arrays; the port, with ml_dtypes
    hidden, reads them as bf16 tensors of the same bits and writes bf16
    tensors JAX's load returns as ml_dtypes arrays of the same bits."""
    w = np.random.default_rng(5).standard_normal((4, 6)).astype(
        ml_dtypes.bfloat16)
    J.save({"p": JParameter(w), "raw": w}, str(tmp_path / "jax"))
    src = torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    got = T.load(str(tmp_path / "jax"))
    assert got["p"].dtype == torch.bfloat16 and _bits(got["p"]) == _bits(src)
    # untagged, without ml_dtypes: a CPU tensor (optimizer.to_numpy's rule)
    assert torch.is_tensor(got["raw"]) and _bits(got["raw"]) == _bits(src)
    T.save({"p": Parameter(src.clone()), "t": src.clone(), "l": [src]},
           str(tmp_path / "port"))
    monkeypatch.undo()
    back = J.load(str(tmp_path / "port"))
    for v in (back["p"]._data, back["t"]._data, back["l"][0]._data):
        arr = np.asarray(v)
        assert arr.dtype == ml_dtypes.bfloat16
        assert arr.view(np.int16).tobytes() == w.view(np.int16).tobytes()
    raw = T.load(str(tmp_path / "jax"), return_numpy=True)
    assert raw["p"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(raw["p"].view(np.int16),
                                  w.view(np.int16))


def test_plain_pickle_without_magic(tmp_path):
    (tmp_path / "f").write_bytes(pickle.dumps({"a": np.arange(3)}))
    assert T.load(str(tmp_path / "f"))["a"].tolist() == [0, 1, 2]


def test_jax_saved_lenet_gives_jax_logits(tmp_path):
    pp.seed(0)
    jnet = JLeNet()
    pp.save(jnet.state_dict(), str(tmp_path / "lenet.pdparams"))
    net = LeNet(device="cpu")
    net.set_state_dict(tp.load(str(tmp_path / "lenet.pdparams")))
    x = np.random.default_rng(0).standard_normal((4, 1, 28, 28)).astype(
        np.float32)
    ref = np.asarray(jnet(pp.to_tensor(x)).numpy())
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_top_level_names_are_jaxs():
    """The names of JAX's top level that this slice ports
    (``paddle_tpu/__init__.py:51-80``)."""
    for name in ("framework", "hapi", "Model", "summary", "flops", "io",
                 "metric", "save", "load"):
        assert hasattr(pp, name) and hasattr(tp, name), name
    assert tp.save is T.save and tp.load is T.load
