"""The PyTorch port's ``nn.Transformer`` slice against the JAX package on
the CPU: the act + bias feed-forward (``fused_ffn`` forward against the
Pallas kernel in interpret mode, backward against JAX's custom VJP),
``MultiHeadAttention`` with masks and the concatenated cache,
``LayerList`` naming, and a small encoder-decoder ``Transformer`` with
its weights copied across, against JAX with its fused tier forced on
(``PADDLE_TPU_FUSED_BLOCK=1``, interpret mode) and off.  Inputs come from
``numpy.random.default_rng``; everything is fp32 with the tolerance
stated in each test.  The kernel on the card is in
``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pp
import paddle_tpu.nn as jnn
from paddle_tpu.ops.pallas import fused_block as JFB

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import transformer as TT
from paddle_tpu_torch.ops.kernels import fused_block as FB


def _raw(x):
    return x._data if hasattr(x, "_data") else x


def _np(x):
    return np.asarray(_raw(x))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got)
                               else got, np.asarray(ref), rtol=tol, atol=tol)


# -- the fused feed-forward ---------------------------------------------------

@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
def test_fused_ffn_matches_pallas(act, bias):
    """``fused_ffn`` (its plain version on the CPU) against the Pallas
    kernel in interpret mode, and the gradient of x, both weights and
    both biases through ``F.fused_ffn``'s custom VJP against JAX's
    (``_ffn_bwd``), for a random cotangent.  T=24, d=128, f=256; fp32
    sums over 256 hidden units in another order: 1e-5."""
    rng = np.random.default_rng(["relu", "gelu", "silu"].index(act) + 3 * bias)
    T, d, f = 24, 128, 256
    arrs = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in
            (((T, d), 1.0), ((d, f), d ** -0.5), ((f, d), f ** -0.5),
             ((f,), 0.5), ((d,), 0.5), ((T, d), 1.0))]
    x, w1, w2, b1, b2, dy = arrs

    def jfn(xx, a, b, c1=None, c2=None):
        return JFB.fused_ffn(xx, a, b, c1, c2, activation=act,
                             use_pallas=True, interpret=True)

    jargs = [jnp.asarray(a) for a in (x, w1, w2)] + \
        ([jnp.asarray(b1), jnp.asarray(b2)] if bias else [])
    ref, vjp = jax.vjp(jfn, *jargs)
    ref_grads = vjp(jnp.asarray(dy))
    targs = [torch.from_numpy(a.copy()).requires_grad_(True)
             for a in ((x, w1, w2, b1, b2) if bias else (x, w1, w2))]
    _close(FB.fused_ffn(*(t.detach() for t in targs), activation=act),
           ref, 1e-5)
    got = TF.fused_ffn(*targs, activation=act)
    got.backward(torch.from_numpy(dy))
    _close(got, ref, 1e-5)
    for t, r in zip(targs, ref_grads):
        _close(t.grad, r, 1e-5)
    if not bias:
        _close(FB.ffn_reference(targs[0].detach(), targs[1].detach(),
                                torch.zeros(f), targs[2].detach(),
                                torch.zeros(d), act), ref, 1e-6)


def test_fused_ffn_refuses_an_unknown_activation():
    x, w = torch.zeros(2, 64), torch.zeros(64, 64)
    for fn in (FB.fused_ffn, TF.fused_ffn):
        with pytest.raises(ValueError, match="unsupported activation"):
            fn(x, w, w, activation="tanh")


# -- MultiHeadAttention -------------------------------------------------------

def _mha_pair(seed, d=64, h=4):
    pp.seed(seed)
    jm = jnn.MultiHeadAttention(d, h)
    tm = tnn.MultiHeadAttention(d, h, device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm.eval(), tm.eval()


@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_multihead_attention_matches_jax(mask):
    """Cross-attention (sq = 6 over sk = 9) with no mask, a bool mask
    broadcast over batch and heads, and a float additive mask: 1e-5."""
    jm, tm = _mha_pair(1)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 6, 64)).astype(np.float32)
    kv = rng.standard_normal((2, 9, 64)).astype(np.float32)
    jmask = tmask = None
    if mask == "bool":
        m = rng.random((2, 1, 6, 9)) > 0.3
        m[..., 0] = True
        jmask, tmask = jnp.asarray(m), torch.from_numpy(m)
    elif mask == "float":
        m = rng.standard_normal((6, 9)).astype(np.float32)
        jmask, tmask = jnp.asarray(m), torch.from_numpy(m)
    ref = jm(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
             attn_mask=jmask)
    got = tm(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
             attn_mask=tmask)
    _close(got, _np(ref), 1e-5)


def test_multihead_attention_cache_matches_jax():
    """Three single-token steps from ``gen_cache``: each output and the
    grown (k, v) cache against JAX's: 1e-5."""
    jm, tm = _mha_pair(2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    jc = jm.gen_cache(jnp.asarray(x))
    tc = tm.gen_cache(torch.from_numpy(x))
    assert tuple(tc[0].shape) == (2, 0, 4, 16)
    for i in range(3):
        xi = x[:, i:i + 1]
        jo, jc = jm(jnp.asarray(xi), cache=jc)
        to, tc = tm(torch.from_numpy(xi), cache=tc)
        _close(to, _np(jo), 1e-5)
        for a, b in zip(tc, jc):
            _close(a, _np(b), 1e-5)
    assert tuple(tc[0].shape) == (2, 3, 4, 16)


# -- layers and the whole model -----------------------------------------------

def test_layer_list_names_its_children_by_position():
    ll = tnn.LayerList([tnn.Linear(2, 3), tnn.Linear(3, 4)])
    ll.append(tnn.Linear(4, 5))
    assert [k for k in ll.state_dict()][::2] == ["0.weight", "1.weight",
                                                 "2.weight"]
    ll.insert(0, tnn.Linear(1, 2))
    assert [tuple(m.weight.shape) for m in ll] == [(1, 2), (2, 3), (3, 4),
                                                   (4, 5)]
    assert len(ll) == 4 and len(ll[1:3]) == 2
    assert tuple(ll[-1].weight.shape) == (4, 5)


def test_square_subsequent_mask_matches_jax():
    ref = _np(jnn.Transformer.generate_square_subsequent_mask(5))
    got = tnn.Transformer.generate_square_subsequent_mask(5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def _transformer_pair(seed, **kw):
    cfg = dict(d_model=128, nhead=4, num_encoder_layers=2,
               num_decoder_layers=2, dim_feedforward=256, **kw)
    pp.seed(seed)
    jm = jnn.Transformer(**cfg)
    tm = tnn.Transformer(**cfg, device="cpu")
    assert list(tm.state_dict()) == list(jm.state_dict())
    rng = np.random.default_rng(seed)
    # distinct weights per layer (the JAX constructor deep-copies one
    # layer, so its copies start equal)
    sd = {k: (rng.standard_normal(v.shape) * (0.1 if v.ndim > 1 else 0.2)
              ).astype(np.float32) + (1.0 if "norm" in k and
                                      k.endswith("weight") else 0.0)
          for k, v in jm.state_dict().items()}
    jm.set_state_dict(sd)
    # carried across as JAX's own state dict, LayerList children and the
    # attention's four projections included
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm.eval(), tm.eval()


@pytest.mark.parametrize("normalize_before", [False, True],
                         ids=["post_ln", "pre_ln"])
@pytest.mark.parametrize("jax_fused", ["1", "0"],
                         ids=["jax_fused_ffn", "jax_plain_ffn"])
def test_transformer_forward_matches_jax(monkeypatch, jax_fused,
                                         normalize_before):
    """A 2 + 2-layer encoder-decoder (d_model 128, 4 heads, FFN 256,
    relu) in eval with the causal target mask, against JAX with its fused
    FFN forced on (interpret mode) and off; post-LN (the default) and
    pre-LN with the final norms.  fp32 through four layers: 2e-5."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", jax_fused)
    jm, tm = _transformer_pair(3, normalize_before=normalize_before)
    rng = np.random.default_rng(6)
    src = rng.standard_normal((2, 8, 128)).astype(np.float32)
    tgt = rng.standard_normal((2, 8, 128)).astype(np.float32)
    jmask = jnn.Transformer.generate_square_subsequent_mask(8)
    tmask = tnn.Transformer.generate_square_subsequent_mask(8)
    ref = jm(jnp.asarray(src), jnp.asarray(tgt), tgt_mask=jmask)
    got = tm(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask)
    _close(got, _np(ref), 2e-5)


def test_transformer_ffn_routes_as_jax(monkeypatch):
    """The feed-forward takes ``F.fused_ffn`` in eval and in training at
    dropout 0, and the linear -> act -> dropout -> linear chain in
    training with dropout, or for an activation the kernel lacks."""
    calls = []
    real = TT.F.fused_ffn
    monkeypatch.setattr(TT.F, "fused_ffn",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(2, 4, 64)
    for dropout, train, act, fused in ((0.1, False, "relu", True),
                                       (0.0, True, "gelu", True),
                                       (0.1, True, "relu", False),
                                       (0.0, False, "tanh", False)):
        if act == "tanh":
            monkeypatch.setattr(TT.F, "tanh", torch.tanh, raising=False)
        layer = tnn.TransformerEncoderLayer(64, 4, 128, dropout=dropout,
                                            activation=act, device="cpu")
        layer.train(train)
        calls.clear()
        layer(x)
        assert bool(calls) == fused, (dropout, train, act)
