"""hapi's ``Model`` of the port against the JAX package's on the CPU:
LeNet (``vision.models.LeNet`` in both) with JAX's weights copied into
the port's, ``Momentum``, ``CrossEntropyLoss``, ``Accuracy``,
``shuffle=False``, the same seeded datasets.  fp32: convolutions and
products sum in other orders than XLA's, so losses, logits and weights
within 1e-5 relative, 1e-6 absolute (2 epochs of 6 steps).  Held:
``fit``'s history, ``evaluate``'s logs, ``predict``'s outputs;
``EarlyStopping``'s epoch; ``LRScheduler``'s steps; ``ModelCheckpoint``'s
files; ``save`` / ``load``; ``summary``'s dicts; ``flops`` within 1% of
XLA's count (the cost model counts elementwise work otherwise; the
products exactly, 2 M N K); and ``evaluate`` after ``fit`` on a
BatchNorm net, in training mode: batch statistics, running statistics
left as they were, in both packages."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as pp
from paddle_tpu.vision.models import LeNet as JLeNet

import paddle_tpu_torch as tp
from paddle_tpu_torch.vision.models import LeNet

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


def _dataset(mod, n, seed, hw=28):
    class Images(mod.io.Dataset):
        def __init__(self):
            r = np.random.default_rng(seed)
            self.x = r.standard_normal((n, 1, hw, hw)).astype(np.float32)
            self.y = r.integers(0, 10, (n, 1))

        def __getitem__(self, i):
            return self.x[i], self.y[i]

        def __len__(self):
            return n
    return Images()


def _nets():
    pp.seed(0)
    jnet = JLeNet()
    tnet = LeNet(device="cpu")
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    return {"jax": (pp, jnet), "port": (tp, tnet)}


def _model(mod, net, lr=0.05, metrics=True):
    m = mod.Model(net)
    m.prepare(mod.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                     parameters=net.parameters()),
              mod.nn.CrossEntropyLoss(),
              mod.metric.Accuracy(topk=(1, 3)) if metrics else None)
    return m


def _weights(net):
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") and not
                          torch.is_tensor(v) else v.detach().numpy())
            for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def fitted():
    """Both packages' LeNet after 2 epochs of fit, then evaluate and
    predict."""
    out = {}
    for side, (mod, net) in _nets().items():
        tp.set_device("cpu")
        m = _model(mod, net)
        hist = m.fit(_dataset(mod, 48, 0), _dataset(mod, 16, 1),
                     batch_size=8, epochs=2, shuffle=False, verbose=0)
        logs = m.evaluate(_dataset(mod, 16, 1), batch_size=8, verbose=0)
        pred = m.predict(_dataset(mod, 16, 2), batch_size=8,
                         stack_outputs=True)
        batches = m.predict(_dataset(mod, 16, 2), batch_size=8)
        # JAX's step keeps its own weights until this writes them back;
        # the port's step trains the network's own (a no-op here)
        m._train_step.sync_to_model()
        out[side] = dict(model=m, hist=hist, logs=logs, pred=pred,
                         batches=batches, weights=_weights(net))
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")
    return out


def test_fit_history_matches_jax(fitted):
    j, t = fitted["jax"]["hist"], fitted["port"]["hist"]
    assert list(j) == list(t) == ["loss"] and len(t["loss"]) == 2
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=RTOL, atol=ATOL)
    for k, w in fitted["jax"]["weights"].items():
        np.testing.assert_allclose(fitted["port"]["weights"][k], w,
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_evaluate_logs_match_jax(fitted):
    j, t = fitted["jax"]["logs"], fitted["port"]["logs"]
    assert list(j) == list(t) == ["loss", "acc_top1", "acc_top3"]
    np.testing.assert_allclose(t["loss"], j["loss"], rtol=RTOL, atol=ATOL)
    assert t["acc_top1"] == j["acc_top1"] and t["acc_top3"] == j["acc_top3"]


def test_predict_matches_jax(fitted):
    j, t = fitted["jax"], fitted["port"]
    assert t["pred"].shape == (16, 10) and t["pred"].dtype == np.float32
    np.testing.assert_allclose(t["pred"], j["pred"], rtol=1e-4, atol=1e-5)
    assert len(t["batches"]) == 2
    np.testing.assert_array_equal(np.concatenate(t["batches"]), t["pred"])


def test_early_stopping_and_lr_scheduler_follow_jax():
    """EarlyStopping(patience=1) on the evaluation loss stops both at the
    same epoch; a StepDecay scheduler stepped by TrainStep after every
    batch (LRScheduler(by_step) leaves it to the step) ends where JAX's
    does."""
    out = {}
    for side, (mod, net) in _nets().items():
        sched = mod.optimizer.lr.StepDecay(learning_rate=0.05, step_size=3,
                                           gamma=0.5)
        m = mod.Model(net)
        m.prepare(mod.optimizer.Momentum(learning_rate=sched, momentum=0.9,
                                         parameters=net.parameters()),
                  mod.nn.CrossEntropyLoss())
        es = mod.hapi.EarlyStopping(monitor="loss", patience=1)
        hist = m.fit(_dataset(mod, 48, 0), _dataset(mod, 16, 1),
                     batch_size=8, epochs=8, shuffle=False, verbose=0,
                     callbacks=[es, mod.hapi.LRScheduler()])
        out[side] = (hist["loss"], es.wait, es.best, m.stop_training,
                     sched.last_epoch, sched.get_lr())
    j, t = out["jax"], out["port"]
    assert len(t[0]) == len(j[0]) < 8 and t[3] and j[3]
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)
    assert t[1] == j[1]
    np.testing.assert_allclose(t[2], j[2], rtol=RTOL, atol=ATOL)
    assert t[4:] == j[4:]


def test_lr_scheduler_by_epoch():
    for mod in (pp, tp):
        sched = mod.optimizer.lr.StepDecay(learning_rate=0.1, step_size=1,
                                           gamma=0.5)
        cb = mod.hapi.LRScheduler(by_step=False, by_epoch=True)
        cb.set_model(type("M", (), {"_optimizer": type(
            "O", (), {"_lr_scheduler": sched})()})())
        for e in range(3):
            cb.on_epoch_end(e)
        assert sched.last_epoch == 3 and sched.get_lr() == 0.1 / 8


def test_model_checkpoint_writes_jaxs_files(tmp_path):
    files = {}
    for side, (mod, net) in _nets().items():
        d = tmp_path / side
        m = _model(mod, net, metrics=False)
        m.fit(_dataset(mod, 24, 0), batch_size=8, epochs=2, shuffle=False,
              verbose=0, callbacks=[mod.hapi.ModelCheckpoint(save_dir=str(d))])
        files[side] = d
    names = sorted(os.listdir(files["jax"]))
    assert names == sorted(os.listdir(files["port"])) == [
        "0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams", "final.pdopt",
        "final.pdparams"]
    for n in ("0.pdparams", "final.pdparams"):
        j = pp.load(str(files["jax"] / n), return_numpy=True)
        t = pp.load(str(files["port"] / n), return_numpy=True)
        assert list(j) == list(t)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6)
    jopt = pp.load(str(files["jax"] / "final.pdopt"))
    topt = pp.load(str(files["port"] / "final.pdopt"))
    assert sorted(topt) == sorted(jopt) and topt["step"] == jopt["step"] == 6
    assert sorted(topt["opt_state"]) == sorted(jopt["opt_state"])
    # the port reads JAX's checkpoint into its model
    net = LeNet(device="cpu")
    m = _model(tp, net, metrics=False)
    m.load(str(files["jax"] / "final"))
    for k, v in pp.load(str(files["jax"] / "final.pdparams"),
                        return_numpy=True).items():
        np.testing.assert_array_equal(net.state_dict()[k].numpy(), v)
    assert m._train_step.step_count == 6


def test_save_load_round_trip(tmp_path):
    """A saved model loads bitwise into a fresh one, weights and optimizer
    state, and both continue to the same loss."""
    _, (mod, net) = list(_nets().items())[1]
    ds = _dataset(tp, 24, 0)
    m = _model(tp, net, metrics=False)
    m.fit(ds, batch_size=8, epochs=1, shuffle=False, verbose=0)
    m.save(str(tmp_path / "ck"))
    fresh = LeNet(device="cpu")
    m2 = _model(tp, fresh, metrics=False)
    m2.load(str(tmp_path / "ck"))
    for (k, a), b in zip(net.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), k
    s1, s2 = m._train_step.state_dict(), m2._train_step.state_dict()
    assert s1["step"] == s2["step"] == 3
    for n in s1["opt_state"]:
        for k, v in s1["opt_state"][n].items():
            np.testing.assert_array_equal(s2["opt_state"][n][k], v)
    x, y = ds[0]
    batch = (x[None], y[None])
    assert m.train_batch(*batch) == m2.train_batch(*batch)
    m3 = _model(tp, LeNet(device="cpu"), metrics=False)
    m3.load(str(tmp_path / "ck"), reset_optimizer=True)
    assert m3._train_step.step_count == 0


def test_summary_and_flops_match_jax():
    nets = _nets()
    (jmod, jnet), (tmod, tnet) = nets["jax"], nets["port"]
    assert tp.summary(tnet, (1, 1, 28, 28)) == pp.summary(jnet,
                                                          (1, 1, 28, 28))
    assert tp.summary(tnet) == pp.summary(jnet)
    assert tp.Model(tnet).summary() == pp.Model(jnet).summary() == \
        {"total_params": sum(p.numel() for p in tnet.parameters())}
    for shape in ((1, 1, 28, 28), (4, 1, 28, 28)):
        got, ref = tp.flops(tnet, shape), pp.flops(jnet, shape)
        assert got == pytest.approx(ref, rel=0.01)
    from paddle_tpu_torch.analysis.passes.cost_model import count_cost
    with torch.no_grad():
        _, c = count_cost(tnet, torch.zeros(1, 1, 28, 28))
    # conv1 6x28x28 outputs of 1x3x3, conv2 16x10x10 of 6x5x5, the three
    # Linears: 2 M N K each
    assert c.product_flops == 2 * (6 * 784 * 9 + 1600 * 150 + 400 * 120 +
                                   120 * 84 + 84 * 10)


def _bn_net(mod, **kw):
    n = mod.nn
    return n.Sequential(n.Conv2D(1, 4, 3, padding=1, **kw),
                        n.BatchNorm2D(4, **kw), n.ReLU(), n.Flatten(),
                        n.Linear(4 * 8 * 8, 10, **kw))


def test_evaluate_after_fit_keeps_batchnorm_in_training_mode():
    """After fit the BatchNorm is in training mode.  Both packages'
    evaluate then normalise with each batch's statistics (a batch's
    logits depend on its batch) and leave the running statistics where
    fit left them: untouched, since the step runs under a functional
    call in both."""
    pp.seed(1)
    jnet = _bn_net(pp)
    tnet = _bn_net(tp, device="cpu")
    tnet.set_state_dict({k: np.asarray(v.numpy())
                         for k, v in jnet.state_dict().items()})
    out = {}
    for side, mod, net in (("jax", pp, jnet), ("port", tp, tnet)):
        m = _model(mod, net, lr=0.01)
        m.fit(_dataset(mod, 32, 0, hw=8), batch_size=8, epochs=1,
              shuffle=False, verbose=0)
        stats = _weights(net)
        logs = m.evaluate(_dataset(mod, 16, 1, hw=8), batch_size=8,
                          verbose=0)
        whole = m.predict(_dataset(mod, 16, 1, hw=8), batch_size=16,
                          stack_outputs=True)
        halves = m.predict(_dataset(mod, 16, 1, hw=8), batch_size=8,
                           stack_outputs=True)
        after = _weights(net)
        out[side] = (logs, whole, halves, stats, after, net.training)
    for side in out:
        logs, whole, halves, stats, after, training = out[side]
        assert training
        np.testing.assert_array_equal(stats["1._mean"], 0.0)
        np.testing.assert_array_equal(stats["1._variance"], 1.0)
        for k in stats:
            np.testing.assert_array_equal(after[k], stats[k])
        assert np.abs(whole - halves).max() > 1e-4      # batch statistics
    j, t = out["jax"], out["port"]
    np.testing.assert_allclose(t[0]["loss"], j[0]["loss"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-4, atol=1e-5)


def test_prepare_refuses_meshes():
    m = tp.Model(LeNet(device="cpu"))
    with pytest.raises(NotImplementedError, match="item 8"):
        m.prepare(None, None, mesh=object())
    with pytest.raises(RuntimeError, match="prepare"):
        m.train_batch(np.zeros((1, 1, 28, 28), np.float32))


def test_eval_batch_and_bf16_predictions():
    """eval_batch gives the loss with labels, numpy without; a bf16
    network's predictions come back as float32 numpy (exact)."""
    net = LeNet(device="cpu")
    m = _model(tp, net, metrics=False)
    x = np.random.default_rng(0).standard_normal((2, 1, 28, 28)).astype(
        np.float32)
    y = np.array([[1], [2]])
    with torch.no_grad():
        ref = net(torch.from_numpy(x))
    assert m.eval_batch([x]).dtype == np.float32
    np.testing.assert_array_equal(m.eval_batch([x]), ref.numpy())
    want = float(tp.nn.functional.cross_entropy(ref, torch.from_numpy(y)))
    assert m.eval_batch([x], [y]) == want
    net.astype("bfloat16")
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = m.predict_batch([xb])
    assert out.dtype == np.float32
    with torch.no_grad():
        bf = net(xb)
    np.testing.assert_array_equal(out, bf.float().numpy())


def test_hapi_names_are_jaxs():
    import paddle_tpu.hapi as jh
    import paddle_tpu.hapi.callbacks as jcb
    import paddle_tpu_torch.hapi as th
    import paddle_tpu_torch.hapi.callbacks as tcb
    assert set(jh.__all__) == set(th.__all__)
    assert set(jcb.__all__) == set(tcb.__all__)
