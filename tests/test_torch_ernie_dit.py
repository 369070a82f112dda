"""The ERNIE 3.0 encoder and DiT of the port against the JAX package's
on the CPU: tiny configs, fp32, the same seeded random weights in both
(numpy, through ``set_state_dict``; DiT's zero-initialised adaLN and
final layers drawn too, so its output is not zero), the same inputs.
Outputs and losses within 1e-5 relative and absolute (XLA and torch sum
the products in other orders).  Then the slice as a whole: tiny ERNIE ->
``jit.save`` -> ``create_predictor`` -> run, in both packages."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu import inference as jinf
from paddle_tpu import jit as jjit
from paddle_tpu import models as jmodels
from paddle_tpu.models import dit as jdit

import paddle_tpu_torch as tp
from paddle_tpu_torch import inference, jit, models
from paddle_tpu_torch.models import dit

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


def _weights(jnet, tnet, seed=0, scale=0.1):
    """Seeded random weights (numpy) into both nets; the port's names and
    shapes must be JAX's."""
    own = {k: tuple(v.shape) for k, v in jnet.state_dict().items()}
    assert own == {k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {k: (rng.standard_normal(s) * scale).astype(np.float32)
          for k, s in own.items()}
    jnet.set_state_dict(sd)
    tnet.set_state_dict(sd)


def _np(t):
    return np.asarray(t.numpy()) if hasattr(t, "numpy") and \
        not torch.is_tensor(t) else t.detach().numpy()


def _ids(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


CFG = dict(hidden_size=32, num_attention_heads=4)


def _ernie(cls, seed=0, **over):
    jcfg = jmodels.ErnieConfig.tiny(**CFG, **over)
    tcfg = models.ErnieConfig.tiny(**CFG, **over)
    jnet, tnet = getattr(jmodels, cls)(jcfg), getattr(models, cls)(
        tcfg, device="cpu")
    _weights(jnet, tnet, seed)
    return jnet, tnet, tcfg


@pytest.mark.parametrize("token_types", [False, True])
def test_ernie_model_is_jaxs(token_types):
    jnet, tnet, cfg = _ernie("ErnieModel")
    ids = _ids(3, 16, cfg.vocab_size)
    tt = _ids(3, 16, cfg.type_vocab_size, 2) if token_types else None
    jx, jp = jnet(pp.to_tensor(ids), None if tt is None
                  else pp.to_tensor(tt))
    tx, tpool = tnet(torch.from_numpy(ids), None if tt is None
                     else torch.from_numpy(tt))
    np.testing.assert_allclose(_np(tx), _np(jx), **TOL)
    np.testing.assert_allclose(_np(tpool), _np(jp), **TOL)


def test_ernie_embeddings_scaled_by_initializer_range():
    tnet = models.ErnieModel(models.ErnieConfig.tiny(), device="cpu")
    for emb in (tnet.word_embeddings, tnet.position_embeddings,
                tnet.token_type_embeddings):
        assert 0.005 < float(emb.weight.detach().std()) < 0.05


def test_ernie_classifier_and_loss_are_jaxs():
    jnet, tnet, cfg = _ernie("ErnieForSequenceClassification")
    ids = _ids(4, 12, cfg.vocab_size)
    labels = np.array([0, 1, 1, 0])
    np.testing.assert_allclose(_np(tnet(torch.from_numpy(ids))),
                               _np(jnet(pp.to_tensor(ids))), **TOL)
    np.testing.assert_allclose(
        float(tnet.loss(torch.from_numpy(ids), torch.from_numpy(labels))),
        float(_np(jnet.loss(pp.to_tensor(ids), pp.to_tensor(labels)))),
        **TOL)


def test_ernie_masked_lm_and_loss_are_jaxs():
    jnet, tnet, cfg = _ernie("ErnieForMaskedLM")
    ids = _ids(2, 16, cfg.vocab_size)
    labels = np.where(np.random.default_rng(3).random((2, 16)) < 0.3, ids,
                      -100)
    np.testing.assert_allclose(_np(tnet(torch.from_numpy(ids))),
                               _np(jnet(pp.to_tensor(ids))), **TOL)
    got = tnet.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    want = jnet.loss(pp.to_tensor(ids), pp.to_tensor(labels))
    np.testing.assert_allclose(float(got), float(_np(want)), **TOL)
    got.backward()
    assert torch.isfinite(tnet.ernie.word_embeddings.weight.grad).all()


# -- DiT -------------------------------------------------------------------

def _dit(seed=0, **over):
    jnet = jdit.DiT(jdit.DiTConfig.tiny(**over))
    tnet = dit.DiT(dit.DiTConfig.tiny(**over), device="cpu")
    _weights(jnet, tnet, seed)
    return jnet, tnet


def _dit_inputs(cfg, b=2, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.in_channels, cfg.input_size,
                             cfg.input_size)).astype(np.float32)
    t = rng.integers(0, 1000, b).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, b)
    return x, t, y


def test_timestep_embedding_and_positions_are_jaxs():
    t = np.array([0.0, 1.0, 999.0], np.float32)
    np.testing.assert_allclose(
        dit.timestep_embedding(torch.from_numpy(t), 64).numpy(),
        np.asarray(jdit.timestep_embedding(pp.to_tensor(t), 64)), **TOL)
    np.testing.assert_array_equal(dit._sincos_2d(64, 4),
                                  jdit._sincos_2d(64, 4))


@pytest.mark.parametrize("learn_sigma", [True, False])
def test_dit_forward_and_loss_are_jaxs(learn_sigma):
    jnet, tnet = _dit(learn_sigma=learn_sigma)
    x, t, y = _dit_inputs(tnet.config)
    want = jnet(pp.to_tensor(x), pp.to_tensor(t), pp.to_tensor(y))
    got = tnet(*map(torch.from_numpy, (x, t, y)))
    assert tuple(got.shape) == tuple(want.shape)
    assert float(np.abs(_np(want)).max()) > 0.1
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    noise = np.random.default_rng(5).standard_normal(
        (2, 4, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        float(tnet.loss(*map(torch.from_numpy, (x, t, y, noise)))),
        float(_np(jnet.loss(*map(pp.to_tensor, (x, t, y, noise))))),
        **TOL)


def test_dit_zero_init_and_patches():
    """adaLN-Zero: a fresh DiT's blocks are the identity and its output
    zero, as in JAX; patchify and unpatchify invert each other."""
    tnet = dit.DiT(dit.DiTConfig.tiny(), device="cpu")
    x, t, y = _dit_inputs(tnet.config)
    out = tnet(*map(torch.from_numpy, (x, t, y)))
    assert torch.equal(out, torch.zeros_like(out))
    xt = torch.from_numpy(x)
    assert torch.equal(tnet.unpatchify(tnet.patchify(xt), 4), xt)
    np.testing.assert_array_equal(
        tnet.patchify(xt).numpy(),
        np.asarray(jdit.DiT(jdit.DiTConfig.tiny()).patchify(
            pp.to_tensor(x))))
    assert "pos_embed" not in tnet.state_dict()


def test_model_exports_are_jaxs():
    for name in ("DiT", "DiTBlock", "DiTConfig", "ErnieConfig", "ErnieModel",
                 "ErnieForSequenceClassification", "ErnieForMaskedLM",
                 "ErnieForCausalLM", "ernie45_moe_config"):
        assert name in models.__all__ and hasattr(models, name)
    assert set(jdit.__all__) <= set(dit.__all__)


# -- the slice: tiny ERNIE -> jit.save -> create_predictor -> run ---------

def test_ernie_saved_and_served_is_jaxs(tmp_path):
    jnet, tnet, cfg = _ernie("ErnieForSequenceClassification")
    specs = lambda mod: [mod.InputSpec([3, 16], "int64", "input_ids"),  # noqa
                         mod.InputSpec([3, 16], "int64", "token_type_ids")]
    jjit.save(jjit.to_static(jnet), str(tmp_path / "j"),
              input_spec=specs(jjit))
    jit.save(jit.to_static(tnet), str(tmp_path / "t"),
             input_spec=specs(jit))
    jpred = jinf.create_predictor(jinf.Config(str(tmp_path / "j")))
    tpred = inference.create_predictor(inference.Config(str(tmp_path / "t")))
    assert tpred.get_input_names() == jpred.get_input_names()
    ids = _ids(3, 16, cfg.vocab_size, 9)
    tt = _ids(3, 16, cfg.type_vocab_size, 10)
    for pred in (jpred, tpred):
        pred.get_input_handle("input_ids").copy_from_cpu(ids)
        pred.get_input_handle("token_type_ids").copy_from_cpu(tt)
    want, got = jpred.run()[0], tpred.run()[0]
    np.testing.assert_allclose(got, want, **TOL)
    eager = tnet(torch.from_numpy(ids), torch.from_numpy(tt))
    np.testing.assert_array_equal(got, _np(eager))
