"""The port's ``TrainStep`` beyond one plain update, against the JAX
package on the CPU: gradient accumulation against JAX's scan, remat
under every policy, the LR scheduler and the global clip through the
step, the compiled step's body (the one a CUDA graph captures) against
the eager step and against JAX, the guard's skip inside it, a JAX
step's ``state_dict()`` continued in the port, the port's own state
dict round trip, and ``device_prefetch``.  A tiny Llama (2 layers,
d 64, fp32) with weights copied across and batches from
``numpy.random.default_rng``; tolerances are stated in each test.  The
CUDA graph itself is held on the card (``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu.nn as jnn
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr

import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.io import device_prefetch
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


def _raw(x):
    return x._data if hasattr(x, "_data") else x


def _pair(seed=0):
    pp.seed(seed)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, b=2, s=16):
    ids = np.random.default_rng(seed).integers(0, 256, (b, s + 1))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _sched(m):
    """LinearWarmup over CosineAnnealingDecay, from the package `m`."""
    return m.LinearWarmup(m.CosineAnnealingDecay(2e-3, T_max=6),
                          warmup_steps=2, start_lr=2e-4, end_lr=2e-3)


def _adamw(m, clip):
    """AdamW under the schedule, multi_precision, a tight global clip
    (0.5: the tiny model's gradient norms are larger, so it scales)."""
    return dict(learning_rate=_sched(m), multi_precision=True,
                grad_clip=clip.ClipGradByGlobalNorm(0.5))


def _close_params(got, ref, atol):
    for n, r in ref.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(r), atol=atol,
                                   rtol=atol, err_msg=n)


def test_accum_steps_match_jax_scan():
    """accum_steps=2 over a batch of 4 (two slices of 2) against JAX's
    scan with its fp32 carry, three updates: each loss within 2e-5
    relative, the parameters within 1e-4 (as in the plain three-step
    test: Adam's first updates move each element by about lr * sign(g),
    which magnifies fp32 order differences where a gradient is near
    zero); a batch that does not divide raises."""
    jm, tm = _pair(3)
    jstep = JTrainStep(jm, JAdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  multi_precision=True), accum_steps=2)
    step = TrainStep(tm, AdamW(learning_rate=1e-3, multi_precision=True),
                     accum_steps=2)
    for i in range(3):
        batch = _batch(20 + i, b=4)
        ref = float(_raw(jstep(batch)))
        got = step(batch)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), ref, rtol=2e-5)
    _close_params(step.params, jstep.params, 1e-4)
    with pytest.raises(ValueError, match="not divisible by accum_steps=2"):
        step(_batch(1, b=3))


def test_accum_steps_mean_of_the_slices():
    """The accumulated step's loss is the mean of the two slices' losses,
    each taken on its own slice (not the whole batch's mean over a
    different split)."""
    _, tm = _pair(4)
    batch = _batch(30, b=4)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    with torch.no_grad():
        ls = [float(tm.loss(torch.from_numpy(h["input_ids"]),
                            torch.from_numpy(h["labels"]))) for h in halves]
    step = TrainStep(tm, AdamW(learning_rate=1e-3), accum_steps=2)
    np.testing.assert_allclose(float(step(batch)), np.mean(ls), rtol=1e-6)


@pytest.mark.parametrize("policy", [None, "nothing", "everything", "dots",
                                    "dots_no_batch"])
def test_remat_matches_no_remat(policy):
    """``remat=True`` under each policy against no remat, two updates
    from the same weights: the losses and every parameter bitwise equal
    (recomputing the same operations on the CPU gives the same bits)."""
    batches = [_batch(40 + i) for i in range(2)]

    def run(**kw):
        _, tm = _pair(5)
        step = TrainStep(tm, AdamW(learning_rate=1e-3), **kw)
        return [step(b) for b in batches], step.params

    ref_l, ref_p = run()
    got_l, got_p = run(remat=True, remat_policy=policy)
    for a, b in zip(got_l, ref_l):
        assert torch.equal(a, b)
    for n, p in ref_p.items():
        assert torch.equal(got_p[n], p), n


@pytest.mark.parametrize("policy,recomputed", [
    ("nothing", True), ("everything", False), ("dots", False),
    ("dots_no_batch", False)])
def test_dots_policies_keep_the_fused_products(policy, recomputed,
                                               monkeypatch):
    """The fused MLP is a dispatcher op, so the selective policies see
    it: under "dots", "dots_no_batch" and "everything" the backward
    takes its saved result and never calls the wrapper again; under
    "nothing" the recompute calls it once more a layer."""
    calls = []
    wrapped = FB.fused_mlp

    def counting(*args):
        calls.append(1)
        return wrapped(*args)
    monkeypatch.setattr(FB, "fused_mlp", counting)
    _, tm = _pair(6)
    step = TrainStep(tm, AdamW(learning_rate=1e-3), remat=True,
                     remat_policy=policy)
    step(_batch(50))
    layers = TINY["num_hidden_layers"]
    assert len(calls) == (2 * layers if recomputed else layers)


def test_unknown_remat_policy_raises():
    _, tm = _pair()
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TrainStep(tm, AdamW(), remat=True, remat_policy="offload")


def _jax_step(jm):
    return JTrainStep(jm, JAdamW(parameters=jm.parameters(),
                                 **_adamw(jlr, jnn)))


def test_compiled_body_matches_eager_and_jax():
    """``compile(batch)`` on a CPU model binds the body a CUDA graph
    captures to static buffers: three updates under the schedule and the
    global clip, on batches of the compiled signature, bitwise equal to
    the eager step's and within the plain three-step test's tolerances of
    JAX's (losses 1e-5 relative, parameters 1e-4); the schedule moved
    three times on each side."""
    jm, tm = _pair(7)
    _, em = _pair(7)
    jstep = _jax_step(jm)
    step = TrainStep(tm, AdamW(**_adamw(tlr, tnn)))
    eager = TrainStep(em, AdamW(**_adamw(tlr, tnn)))
    info = step.compile(_batch(0))
    assert info.graph is False and info.launches == {}
    for i in range(3):
        batch = _batch(60 + i)
        ref = float(_raw(jstep(batch)))
        got = step(batch)
        assert torch.equal(got, eager(batch))
        np.testing.assert_allclose(float(got), ref, rtol=1e-5)
    assert step.step_count == eager.step_count == 3 and step.replays == 0
    for n, p in eager.params.items():
        assert torch.equal(step.params[n], p), n
    _close_params(step.params, jstep.params, 1e-4)
    assert step.optimizer.get_lr() == jstep.optimizer.get_lr()
    # a batch of another signature runs the eager body
    got = step(_batch(70, b=3))
    assert torch.isfinite(got) and step.step_count == 4


def test_compiled_body_skips_a_nonfinite_step_bitwise():
    """A NaN in a parameter inside the compiled body: the skip code comes
    back 1, the parameters, every optimizer state tensor and the count
    are bitwise as they were, the skip is counted, and the scheduler
    still steps (as the reference's does)."""
    _, tm = _pair(8)
    opt = AdamW(**_adamw(tlr, tnn))
    step = TrainStep(tm, opt)
    batch = _batch(80)
    step.compile(batch)
    step(batch)
    with torch.no_grad():
        tm.model.norm.weight[5] = float("nan")
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    state = {k: {n: t.clone() for n, t in st.items()}
             for k, st in opt._accumulators.items()}
    count = step._count.clone()
    lr = opt.get_lr()
    loss = step(batch)
    assert not torch.isfinite(loss)
    assert step.skipped == {"nonfinite_loss": 1, "nonfinite_grad": 0}
    assert step.step_count == 1 and torch.equal(step._count, count)
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach().view(torch.int32),
                           before[n].view(torch.int32)), n
    for k, st in opt._accumulators.items():
        for n, t in st.items():
            assert torch.equal(t.view(torch.int32),
                               state[k][n].view(torch.int32)), n
    assert opt.get_lr() != lr


def test_frozen_hands_the_capture_its_buffers():
    """Inside ``_build.frozen`` (a CUDA graph's capture) a workspace or
    ticket array is handed out only if it exists, and the block yields
    every one it handed out: the graph's owner keeps them, so a later
    call that grows the cached buffer leaves the captured one alive."""
    from paddle_tpu_torch.ops.kernels import _build
    dev = torch.device("cpu")
    owner = "test_frozen"
    _build.workspace(owner, dev, 100)
    _build.tickets(owner, dev, 4)
    with _build.frozen("a capture") as held:
        ptr = _build.workspace(owner, dev, 100)
        _build.workspace(owner, dev, 50)
        tickets = _build.tickets(owner, dev, 4)
        with pytest.raises(RuntimeError, match="inside a capture"):
            _build.workspace(owner, dev, 1 << 20)
    assert [t.data_ptr() for t in held] == [ptr, tickets.data_ptr()]
    assert _build.workspace(owner, dev, 1 << 20) != ptr
    assert held[0].data_ptr() == ptr and held[0].numel() == 1 << 16
    with _build.frozen("another") as none:
        pass
    assert none == []
    del _build._workspaces[(owner, dev)], _build._tickets[(owner, dev)]


def test_jax_state_dict_continues_in_the_port():
    """Two JAX updates (schedule, clip, fp32 masters), its
    ``state_dict()`` loaded into a fresh port step (params, moments,
    masters, the count and the schedule), then one more update on each:
    the parameters within 2e-5; the JAX key is not a torch generator
    state and is left alone."""
    jm, _ = _pair(9)
    _, tm = _pair(10)           # other weights: the state must replace them
    jstep = _jax_step(jm)
    for i in range(2):
        jstep(_batch(90 + i))
    state = jstep.state_dict()
    assert {"params", "opt_state", "step", "rng_key",
            "lr_scheduler"} <= set(state)
    step = TrainStep(tm, AdamW(**_adamw(tlr, tnn)))
    step.set_state_dict(state)
    assert step.step_count == 2
    assert step.optimizer.get_lr() == jstep.optimizer.get_lr()
    batch = _batch(95)
    np.testing.assert_allclose(float(step(batch)), float(_raw(jstep(batch))),
                               rtol=1e-5)
    _close_params(step.params, jstep.params, 2e-5)


def test_state_dict_round_trip_is_bitwise():
    """Three updates, ``state_dict()`` (a snapshot: the step that made it
    goes on), a fresh step (other weights) loaded with it, two more
    updates: losses and parameters bitwise equal to five uninterrupted
    updates.  The state holds numpy arrays and the
    device generator's state as ``rng_key``."""
    batches = [_batch(100 + i) for i in range(5)]
    _, ta = _pair(11)
    a = TrainStep(ta, AdamW(**_adamw(tlr, tnn)))
    ref = [a(b) for b in batches]
    _, tb = _pair(11)
    b1 = TrainStep(tb, AdamW(**_adamw(tlr, tnn)))
    got = [b1(b) for b in batches[:3]]
    state = b1.state_dict()
    b1(batches[3])                      # the state dict is a snapshot
    assert state["step"] == 3 and state["rng_key"].dtype == np.uint8
    assert all(isinstance(v, np.ndarray) for v in state["params"].values())
    # fp32 parameters keep no master under multi_precision
    assert sorted(state["opt_state"]["lm_head.weight"]) == \
        ["moment1", "moment2"]
    _, tc = _pair(12)
    c = TrainStep(tc, AdamW(**_adamw(tlr, tnn)))
    c.set_state_dict(state)
    got += [c(b) for b in batches[3:]]
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    for n, p in a.params.items():
        assert torch.equal(c.params[n], p), n
    with pytest.raises(ValueError, match="missing"):
        c.set_state_dict({**state, "params": {}})


def test_device_prefetch_order_and_placement():
    """Batches come back in order, as tensors of their own shapes and
    dtypes on the device asked for; a source that raises hands its error
    to the consumer; stopping early joins the thread; sharded placement
    names queue 1, item 8."""
    src = [{"ids": np.arange(6).reshape(2, 3) + i, "w": (np.float32(i), i)}
           for i in range(7)]
    with device_prefetch(src, depth=2, device="cpu") as it:
        out = list(it)
    assert len(out) == 7
    for i, b in enumerate(out):
        assert b["ids"].device.type == "cpu" and b["ids"].dtype == \
            torch.int64
        assert torch.equal(b["ids"], torch.arange(6).reshape(2, 3) + i)
        assert float(b["w"][0]) == i and b["w"][0].shape == ()

    def bad():
        yield {"x": np.zeros(2)}
        raise KeyError("source failed")
    it = device_prefetch(bad(), device="cpu")
    assert torch.equal(next(it)["x"], torch.zeros(2, dtype=torch.float64))
    with pytest.raises(KeyError, match="source failed"):
        next(it)
    it.close()
    early = device_prefetch(iter(src * 10), depth=1, device="cpu")
    next(early)
    early.close()
    assert not early._thread.is_alive()
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        device_prefetch(src, sharding=object(), device="cpu")
