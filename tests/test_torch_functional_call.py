"""``core.functional`` of the port against the JAX package's on the CPU:
``functional_call`` of ``LlamaConfig.tiny()`` with substituted weights
(logits and loss, fp32, 1e-5), ``params_of`` / ``trainable_mask``, the
substitution flag sending a sparse embedding dense, and the functional
dropout streams."""

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu.core import functional as JFC
from paddle_tpu.models import LlamaConfig as JCfg
from paddle_tpu.models import LlamaForCausalLM as JLlama

import paddle_tpu_torch as tp
from paddle_tpu_torch.core import functional as TFC
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TOL = 1e-5


def _pair(seed=0):
    pp.seed(seed)
    jm = JLlama(JCfg.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _scaled(state, k=0.5):
    """Every floating entry times `k`, as numpy."""
    return {n: (np.asarray(v) * k).astype(np.asarray(v).dtype)
            if np.issubdtype(np.asarray(v).dtype, np.floating)
            else np.asarray(v) for n, v in state.items()}


def test_functional_call_llama_matches_jax():
    """The tiny Llama called with every weight halved, in both packages;
    the models' own weights are untouched."""
    jm, tm = _pair()
    ids = np.random.default_rng(0).integers(0, 256, (2, 12))
    new = _scaled({k: v.numpy() for k, v in jm.state_dict().items()})
    jlog = JFC.functional_call(jm, {k: jax.numpy.asarray(v)
                                    for k, v in new.items()},
                               pp.to_tensor(ids))
    tlog = TFC.functional_call(tm, {k: torch.from_numpy(v)
                                    for k, v in new.items()},
                               torch.from_numpy(ids))
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=TOL, atol=TOL)
    own = tm(torch.from_numpy(ids)).detach().numpy()
    assert not np.allclose(own, tlog.detach().numpy())
    np.testing.assert_allclose(own, jm(pp.to_tensor(ids)).numpy(),
                               rtol=TOL, atol=TOL)


def test_functional_call_method_and_partial_dict():
    """``method="loss"`` and a dict naming only some tensors (the rest
    stay the layer's)."""
    jm, tm = _pair(1)
    ids = np.random.default_rng(1).integers(0, 256, (2, 13))
    x, y = ids[:, :-1], ids[:, 1:]
    w = jm.state_dict()["lm_head.weight"].numpy() * 2.0
    jl = JFC.functional_call(jm, {"lm_head.weight": jax.numpy.asarray(w)},
                             pp.to_tensor(x), pp.to_tensor(y),
                             method="loss")
    tl = TFC.functional_call(tm, {"lm_head.weight": torch.from_numpy(w)},
                             torch.from_numpy(x), torch.from_numpy(y),
                             method="loss")
    np.testing.assert_allclose(float(tl.detach()), float(np.asarray(jl)),
                               rtol=TOL)
    with pytest.raises(KeyError):
        TFC.functional_call(tm, {"nope": torch.zeros(1)},
                            torch.from_numpy(x))


def test_functional_call_gradients_flow_to_substitutes():
    _, tm = _pair(2)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 9)))
    params = {k: v.clone().requires_grad_(True)
              for k, v in TFC.params_of(tm).items()}
    loss = TFC.functional_call(tm, params, ids[:, :-1], ids[:, 1:],
                               method="loss")
    loss.backward()
    assert params["model.embed_tokens.weight"].grad is not None
    assert all(p.grad is None for p in tm.parameters())


def test_params_of_and_trainable_mask_match_jax():
    jm, tm = _pair()
    jp, tpar = JFC.params_of(jm), TFC.params_of(tm)
    assert list(tpar) == list(jp)
    for k in jp:
        np.testing.assert_array_equal(tpar[k].numpy(), np.asarray(jp[k]))
    half = TFC.params_of(tm, dtype="bfloat16")
    assert half["lm_head.weight"].dtype == torch.bfloat16
    tm.model.norm.weight.stop_gradient = True
    jm.model.norm.weight.stop_gradient = True
    assert TFC.trainable_mask(tm) == JFC.trainable_mask(jm)
    assert TFC.trainable_mask(tm)["model.norm.weight"] is False


def test_substitution_sends_sparse_embedding_dense():
    e = tp.nn.Embedding(16, 4, sparse=True)
    ids = torch.tensor([[1, 2, 2]])
    assert not TFC.substitution_active()
    with TFC.substitute():
        assert TFC.substitution_active()
        e(ids).sum().backward()
    assert e.weight.grad.layout == torch.strided
    e.weight.grad = None
    e(ids).sum().backward()
    assert e.weight.grad.layout == torch.sparse_coo
    e.weight.grad = None
    TFC.functional_call(e, {"weight": e.weight}, ids).sum().backward()
    assert e.weight.grad.layout == torch.strided
    with torch.no_grad():                       # grad mode off: dense
        out = e(ids)
    assert out.shape == (1, 3, 4)


def test_functional_dropout_stream():
    """``rngs={"dropout": seed}``: the same stream gives the same mask,
    another seed another one, and the global generator is not drawn."""
    drop = tp.nn.Dropout(0.5)
    x = torch.ones(64)
    tp.seed(7)
    before = tp.get_rng_state("cpu")
    a = TFC.functional_call(drop, {}, x, rngs={"dropout": 3})
    b = TFC.functional_call(drop, {}, x, rngs={"dropout": 3})
    c = TFC.functional_call(drop, {}, x, rngs={"dropout": 4})
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(before, tp.get_rng_state("cpu"))
    assert TFC.next_functional_generator("dropout") is None
    g = torch.Generator().manual_seed(0)
    with TFC.substitute(rngs={"dropout": g}):
        assert TFC.next_functional_generator("dropout") is g
        assert TFC.next_functional_generator("other") is None


def test_no_port_module_imports_jax_or_the_jax_package():
    """A static scan of every module of the port (this slice's among
    them): no import statement names ``jax`` or ``paddle_tpu``."""
    import ast
    import pathlib
    root = pathlib.Path(tp.__file__).parent
    bad = []
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and \
                    node.level == 0:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append(f"{path.relative_to(root)}: {n}")
    assert not bad, bad
    for mod in ("autograd", "vision", "core/functional.py",
                "core/sparse_grad.py", "core/tensor_methods.py",
                "nn/rnn.py", "nn/conv_layers.py", "framework/io_.py",
                "io/dataset.py", "io/dataloader.py", "io/token_dataset.py",
                "metric/__init__.py", "hapi/model.py", "hapi/callbacks.py",
                "hapi/summary.py", "jit/save_load.py", "jit/dy2static.py",
                "static/__init__.py", "static/nn.py", "text/__init__.py",
                "text/tokenizer.py", "models/dit.py"):
        assert (root / mod).exists(), mod
