"""``jit.save`` / ``jit.load`` of the port against the JAX package's on
the CPU: the same Layers with JAX's weights carried over, saved by both
packages and loaded back; the outputs agree within 1e-5 relative, 1e-6
absolute (fp32; XLA and torch sum the products in other orders).  Held
too: example-tensor specs, a dynamic batch, the meta's and the npz's
keys (and values) against JAX's, bfloat16 parameters as their bits, the
refusals (a dynamic dim a kernel's gate reads, a foreign platform, the
NaN sweep), and each ``ptt::`` op's fake: a module calling the op
directly exports, saves and loads, and the op's node carries the output
shapes and dtypes the op returns."""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu import jit as jjit

import paddle_tpu_torch as tp
from paddle_tpu_torch import jit
from paddle_tpu_torch.ops.kernels import flash_attention as FA

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


def _nets():
    """The JAX package's ``small_net`` (tests/test_export_native.py) and
    the port's, JAX's weights carried over."""
    pp.seed(0)
    jnet = pp.nn.Sequential(pp.nn.Linear(8, 16), pp.nn.GELU(),
                            pp.nn.Linear(16, 4))
    tnet = tp.nn.Sequential(tp.nn.Linear(8, 16), tp.nn.GELU(),
                            tp.nn.Linear(16, 4))
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    return jnet, tnet


def _x(b, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 8)).astype(
        np.float32)


def _np(out):
    return out.numpy() if hasattr(out, "numpy") else np.asarray(out)


@pytest.mark.parametrize("shape", [[2, 8], [None, 8]],
                         ids=["static", "dynamic_batch"])
def test_save_load_round_trip_is_jaxs(tmp_path, shape):
    jnet, tnet = _nets()
    jjit.save(jnet, str(tmp_path / "j"),
              input_spec=[jjit.InputSpec(shape, "float32", "x")])
    jit.save(tnet, str(tmp_path / "t"),
             input_spec=[jit.InputSpec(shape, "float32", "x")])
    jl, tl = jjit.load(str(tmp_path / "j")), jit.load(str(tmp_path / "t"))
    for b in ([2] if shape[0] else [1, 2, 5]):
        x = _x(b, b)
        np.testing.assert_allclose(_np(tl(x)), _np(jl(x)), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(_np(tl(x)), tnet(torch.from_numpy(x))
                                   .detach().numpy(), rtol=0, atol=0)


def test_example_tensor_specs(tmp_path):
    """A tensor (or array) in place of an InputSpec pins its shape and
    dtype, as in the JAX package."""
    jnet, tnet = _nets()
    jit.save(tnet, str(tmp_path / "t"), input_spec=[torch.randn(3, 8)])
    jit.save(tnet, str(tmp_path / "n"), input_spec=[_x(3)])
    for name in ("t", "n"):
        tl = jit.load(str(tmp_path / name))
        assert tl.input_specs == [{"shape": [3, 8], "dtype": "float32"}]
        x = _x(3, 7)
        np.testing.assert_allclose(_np(tl(x)), _np(jnet(pp.to_tensor(x))),
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(Exception):
        jit.load(str(tmp_path / "t"))(_x(4))          # the shape is pinned


def test_missing_spec_and_non_layer_raise(tmp_path):
    _, tnet = _nets()
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(tnet, str(tmp_path / "m"))
    with pytest.raises(TypeError, match="Layer"):
        jit.save(lambda x: x, str(tmp_path / "m"), input_spec=[_x(2)])


def test_meta_and_params_are_jaxs(tmp_path):
    """The meta's shared keys hold JAX's values (symbolic dims by their
    names) and the npz holds JAX's keys with JAX's values."""
    jnet, tnet = _nets()
    spec = ([None, 8], "float32", "feat")
    jjit.save(jnet, str(tmp_path / "j"), input_spec=[jjit.InputSpec(*spec)])
    jit.save(tnet, str(tmp_path / "t"), input_spec=[jit.InputSpec(*spec)])
    jm = json.load(open(tmp_path / "j.pdmeta"))
    tm = json.load(open(tmp_path / "t.pdmeta"))
    for key in ("param_names", "input_names", "inputs"):
        assert tm[key] == jm[key], key
    assert tm["inputs"] == [{"shape": ["batch", 8], "dtype": "float32"}]
    assert tm["format"] == jit.save_load.FORMAT and tm["platform"] == "cpu"
    assert set(tm["param_dtypes"].values()) == {"float32"}
    jz = np.load(tmp_path / "j.pdiparams.npz")
    tz = np.load(tmp_path / "t.pdiparams.npz")
    assert sorted(jz.files) == sorted(tz.files) == jm["param_names"]
    for k in jz.files:
        np.testing.assert_array_equal(tz[k], jz[k])


def test_bfloat16_parameters_are_stored_as_bits(tmp_path):
    _, tnet = _nets()
    tnet.astype("bfloat16")
    jit.save(tnet, str(tmp_path / "b"),
             input_spec=[jit.InputSpec([2, 8], "bfloat16")])
    meta = json.load(open(tmp_path / "b.pdmeta"))
    assert set(meta["param_dtypes"].values()) == {"bfloat16"}
    z = np.load(tmp_path / "b.pdiparams.npz")
    for name, t in tnet.state_dict().items():
        assert z[name].dtype == np.int16
        np.testing.assert_array_equal(z[name], t.view(torch.int16).numpy())
    x = torch.from_numpy(_x(2)).bfloat16()
    assert torch.equal(jit.load(str(tmp_path / "b"))(x), tnet(x))


def test_to_static_layer_is_unwrapped(tmp_path):
    _, tnet = _nets()
    static = jit.to_static(tnet, input_spec=[jit.InputSpec([None, 8])])
    jit.save(static, str(tmp_path / "s"),
             input_spec=[jit.InputSpec([None, 8])])
    x = _x(3)
    np.testing.assert_array_equal(_np(jit.load(str(tmp_path / "s"))(x)),
                                  _np(static(x).detach()))


# -- refusals -------------------------------------------------------------

def test_dynamic_dim_at_a_kernel_gate_raises(tmp_path):
    """An ERNIE encoder at head_dim 64 with a dynamic sequence: flash's
    gate would read the length, so save names the dim and the gate; the
    pinned length saves."""
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    model = ErnieForSequenceClassification(
        ErnieConfig.tiny(hidden_size=128, num_attention_heads=2),
        device="cpu")
    with pytest.raises(ValueError, match=r"x0_d1 .*flash attention"):
        jit.save(model, str(tmp_path / "g"),
                 input_spec=[jit.InputSpec([None, None], "int64")])
    jit.save(model, str(tmp_path / "g"),
             input_spec=[jit.InputSpec([None, 32], "int64")])


def test_foreign_platform_is_refused(tmp_path):
    _, tnet = _nets()
    jit.save(tnet, str(tmp_path / "p"), input_spec=[_x(2)])
    meta = json.load(open(tmp_path / "p.pdmeta"))
    meta["platform"] = "cuda"
    json.dump(meta, open(tmp_path / "p.pdmeta", "w"))
    with pytest.raises(ValueError, match="exported on 'cuda'"):
        jit.load(str(tmp_path / "p"), device="cpu")


def test_nan_sweep_refuses_to_export(tmp_path):
    _, tnet = _nets()
    tp.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(ValueError, match="check_nan_inf"):
            jit.save(tnet, str(tmp_path / "n"), input_spec=[_x(2)])
    finally:
        tp.set_flags({"check_nan_inf": False})


# -- the ptt:: ops' fakes ---------------------------------------------------

def _rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed + sum(shape))
    return torch.randn(*shape, generator=g) * 0.1


def _ops():
    """(name, op, args, dynamic batch axis of args[0] or None)."""
    x = _rand(6, 64)
    w64 = [_rand(64, 64, seed=i) for i in range(3)]
    wu, wg, wd = _rand(64, 128, seed=4), _rand(64, 128, seed=5), \
        _rand(128, 64, seed=6)
    q, k, v = _rand(2, 64, 4, 16), _rand(2, 64, 2, 16), _rand(2, 64, 2, 16)
    b, s, d = 2, 16, 64
    blk = dict(x=_rand(b, s, d), wn=torch.ones(d), wq=_rand(d, d, seed=1),
               wk=_rand(d, 32, seed=2), wv=_rand(d, 32, seed=3),
               cos=torch.ones(s, 8), sin=torch.zeros(s, 8),
               wo=_rand(d, d, seed=7), wg=wg, wu=wu, wd=wd)
    ge = dict(x=_rand(4, 8, 64), w1=_rand(2, 64, 32), b1=_rand(2, 32),
              w2=_rand(2, 32, 64), b2=_rand(2, 64),
              counts=torch.tensor([8, 3, 0, 8], dtype=torch.int32))
    return [
        ("flash_attention_fwd", torch.ops.ptt.flash_attention_fwd,
         (q, k, v, True, None), 0),
        ("fused_rmsnorm_qkv", torch.ops.ptt.fused_rmsnorm_qkv,
         (x, torch.ones(64), *w64, 1e-5), 0),
        ("fused_rmsnorm_qkv_fwd", torch.ops.ptt.fused_rmsnorm_qkv_fwd,
         (x, torch.ones(64), *w64, 1e-5), 0),
        ("fused_mlp", torch.ops.ptt.fused_mlp, (x, wg, wu, wd), 0),
        ("fused_ffn", torch.ops.ptt.fused_ffn,
         (x, wu, _rand(128), wd, None, "gelu"), 0),
        ("fused_decoder_block", torch.ops.ptt.fused_decoder_block,
         (blk["x"], blk["wn"], blk["wq"], blk["wk"], blk["wv"], blk["cos"],
          blk["sin"], blk["wo"], blk["wn"], blk["wg"], blk["wu"], blk["wd"],
          4, 2, 1e-5), 0),
        ("grouped_expert_ffn", torch.ops.ptt.grouped_expert_ffn,
         (ge["x"], ge["w1"], ge["b1"], ge["w2"], ge["b2"], ge["counts"],
          "gelu"), None),
    ]


class _OpModule(torch.nn.Module):
    def __init__(self, op, rest):
        super().__init__()
        self.op, self.rest = op, rest

    def forward(self, first):
        return self.op(first, *self.rest)


@pytest.mark.parametrize("case", _ops(), ids=[c[0] for c in _ops()])
def test_ptt_op_fake_exports_saves_and_loads(tmp_path, case):
    name, op, args, batch_axis = case
    first, rest = args[0], args[1:]
    mod = _OpModule(op, rest)
    dyn = ({batch_axis: torch.export.Dim("batch")},) \
        if batch_axis is not None else None
    with torch.no_grad():
        ep = torch.export.export(mod, (first,), dynamic_shapes=dyn)
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and getattr(n.target, "namespace", None) == "ptt"]
    assert [n.target.name() for n in nodes] == [f"ptt::{name}"]
    eager = op(*args)
    eager = eager if isinstance(eager, tuple) else (eager,)
    meta = nodes[0].meta["val"]
    meta = meta if isinstance(meta, (tuple, list)) else (meta,)
    assert len(meta) == len(eager)
    for m, e in zip(meta, eager):
        assert m.dtype == e.dtype
        assert len(m.shape) == e.ndim
        for axis, (ms, es) in enumerate(zip(m.shape, e.shape)):
            if batch_axis is not None and axis == batch_axis and \
                    isinstance(ms, torch.SymInt):
                continue
            assert int(ms) == es, (name, axis)
    path = tmp_path / "op.pt2"
    torch.export.save(ep, str(path))
    got = torch.export.load(str(path)).module()(first)
    got = got if isinstance(got, tuple) else (got,)
    for g, e in zip(got, eager):
        assert torch.equal(g, e)


def test_inference_forward_reaches_kernels_only_through_ops():
    """Under no_grad the fused functionals and flash attention call the
    ptt:: ops (what an export records), not the wrappers directly."""
    from paddle_tpu_torch.nn import functional as F
    seen = []

    class Spy(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "ptt":
                seen.append(func.name())
            return func(*args, **(kwargs or {}))

    x = _rand(2, 8, 64)
    with torch.no_grad(), Spy():
        F.fused_rmsnorm_qkv(x, torch.ones(64), *(_rand(64, 64, seed=i)
                                                 for i in range(3)))
        F.fused_mlp(x, _rand(64, 128), _rand(64, 128, seed=1),
                    _rand(128, 64))
        F.fused_ffn(x, _rand(64, 128), _rand(128, 64))
        FA.flash_attention(_rand(2, 64, 4, 16), _rand(2, 64, 2, 16),
                           _rand(2, 64, 2, 16, seed=3), causal=True)
    assert seen == ["ptt::fused_rmsnorm_qkv_fwd", "ptt::fused_mlp",
                    "ptt::fused_ffn", "ptt::flash_attention_fwd"]


def test_memory_monitor_skips_an_exports_fake_tensors():
    """A trace's fake tensors stay reachable (the graph's node metadata);
    the CPU memory monitor counts real storages only."""
    from paddle_tpu_torch.observability.device_profiler import \
        DeviceMemoryMonitor
    _, tnet = _nets()
    ep = torch.export.export(tnet, (torch.from_numpy(_x(2)),))
    fakes = [n.meta["val"] for n in ep.graph.nodes if "val" in n.meta]
    assert fakes
    live, buffers = DeviceMemoryMonitor(device="cpu").measure()
    assert live > 0 and buffers > 0
