"""AMP and the op hook of the port against the JAX package's.

``amp.maybe_cast_args`` casts as JAX's does at O1 and O2 with custom
lists; a small network of named ops (Linear, ``matmul``, ``rms_norm``,
``softmax``, ``exp``, ``cross_entropy``) gives the same operator stats
and outputs within 1e-2 under O1 and O2 in both packages; a tiny Llama
under O1 / O2 matches JAX's run on its fused route
(``PADDLE_TPU_FUSED_BLOCK=1``, the route JAX takes on a TPU, its Pallas
kernels in interpret mode): loss within 1e-2, equal stats over the ops
the port names.  JAX also counts ``add`` and ``reshape``: its tensor
operators and methods are ops, torch's are not (ROADMAP.md queue 3);
the residual stream's dtype, where those operators act, is the same in
both packages.  Then ``decorate``'s bf16 parameters and fp32 masters,
``GradScaler``'s float16 protocol step for step, ``FLAGS_check_nan_inf``
levels 0 and 1, and the hook's fast path (no cast, no stats call, no op
added to a traced program)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jp
import paddle_tpu.amp.debugging  # noqa: F401
import paddle_tpu.nn.functional as JF
from paddle_tpu import amp as jamp
from paddle_tpu import flags as jflags
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import Linear as TLinear
from paddle_tpu_torch.optimizer import SGD as TSGD
from paddle_tpu_torch.optimizer import AdamW as TAdamW

LLAMA = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
             num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _cpu_default():
    tp.set_device("cpu")
    yield
    from paddle_tpu_torch.core import state
    state.set_default_device("cuda")


def _dt(a):
    return str(a.dtype).replace("torch.", "")


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op", ["matmul", "exp", "add", "layer_norm",
                                "my_white", "my_black"])
def test_maybe_cast_args_matches_jax(level, op):
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal((2, 3)).astype(np.float32),
            np.arange(3, dtype=np.int32), 1.5,
            rng.standard_normal(3).astype(np.float32)]
    jargs = [jnp.asarray(vals[0]), jnp.asarray(vals[1]), vals[2],
             jnp.asarray(vals[3], jnp.bfloat16)]
    targs = [torch.from_numpy(vals[0]), torch.from_numpy(vals[1]), vals[2],
             torch.from_numpy(vals[3]).bfloat16()]
    kw = dict(level=level, dtype="float16", custom_white_list=["my_white"],
              custom_black_list=["my_black", "matmul"])
    with jamp.auto_cast(**kw):
        jout = jamp.maybe_cast_args(op, jargs)
    with tamp.auto_cast(**kw):
        tout = tamp.maybe_cast_args(op, targs)
    assert tamp.maybe_cast_args(op, targs) is targs   # off outside
    for j, t in zip(jout, tout):
        if isinstance(t, torch.Tensor):
            assert _dt(t) == str(j.dtype), (op, level)
        else:
            assert t == j


def _small_pair():
    rng = np.random.default_rng(3)
    w1 = rng.standard_normal((16, 32)).astype(np.float32) * 0.2
    b1 = rng.standard_normal(32).astype(np.float32) * 0.1
    w2 = rng.standard_normal((32, 10)).astype(np.float32) * 0.2
    x = rng.standard_normal((8, 16)).astype(np.float32)
    lab = rng.integers(0, 10, (8,)).astype(np.int64)
    jlin = jp.nn.Linear(16, 32)
    jlin.set_state_dict({"weight": w1, "bias": b1})
    tlin = TLinear(16, 32, device="cpu")
    tlin.set_state_dict({"weight": w1, "bias": b1})

    def jnet():
        h = jp.matmul(jlin(jp.to_tensor(x)), jp.to_tensor(w2))
        p = JF.softmax(JF.rms_norm(h))
        return JF.cross_entropy(jp.exp(p), jp.to_tensor(lab))

    def tnet():
        h = tp.matmul(tlin(torch.from_numpy(x)), torch.from_numpy(w2))
        p = TF.softmax(TF.rms_norm(h))
        return TF.cross_entropy(tp.exp(p), torch.from_numpy(lab))

    return jnet, tnet


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_small_network_stats_and_outputs_match_jax(level):
    jnet, tnet = _small_pair()
    with jamp.debugging.collect_operator_stats():
        with jamp.auto_cast(level=level):
            jl = jnet()
    jcounts = dict(jamp.debugging._OP_STATS["counts"])
    with tamp.debugging.collect_operator_stats() as s:
        with tamp.auto_cast(level=level):
            tl = tnet()
    assert s.counts == jcounts
    assert s.counts == {"linear": 1, "matmul": 1, "rms_norm": 1,
                        "softmax": 1, "exp": 1, "cross_entropy": 1}
    want = "bfloat16"
    assert s.dtypes["linear"] == {want: 1}
    assert s.dtypes["matmul"] == {want: 1}
    for black in ("rms_norm", "softmax", "exp", "cross_entropy"):
        assert s.dtypes[black] == {"float32": 1}
    np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=1e-2,
                               atol=1e-2)
    with tamp.auto_cast(enable=False):
        tl_off = tnet()
    np.testing.assert_allclose(float(tl_off), float(jnet().numpy()),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def llama_pair():
    jp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**LLAMA))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, (2, 16))
    lab = rng.integers(0, 256, (2, 16))
    return jm, tm, ids, lab


# the ops the port's Llama names; JAX adds its operators' ``add`` (the
# two residual sums) and its ``reshape`` calls
NAMED = {"embedding": 1, "fused_rmsnorm_qkv": 1, "apply_rotary_emb": 2,
         "scaled_dot_product_attention": 1, "linear": 1, "rms_norm": 2,
         "fused_mlp": 1, "fused_linear_cross_entropy": 1}


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_tiny_llama_matches_jax_fused_route(llama_pair, level, monkeypatch):
    jm, tm, ids, lab = llama_pair
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "1")
    with jamp.debugging.collect_operator_stats():
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            jl = jm.loss(jp.to_tensor(ids.astype(np.int32)),
                         jp.to_tensor(lab.astype(np.int32)))
    jcounts = dict(jamp.debugging._OP_STATS["counts"])
    with tamp.debugging.collect_operator_stats() as s:
        with tamp.auto_cast(level=level, dtype="bfloat16"):
            tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(lab))
    np.testing.assert_allclose(float(tl.detach()), float(jl.numpy()),
                               rtol=1e-2, atol=1e-2)
    assert s.counts == NAMED
    assert {k: v for k, v in jcounts.items() if k in NAMED} == NAMED
    assert set(jcounts) - set(NAMED) == {"add", "reshape"}
    # O1: the fused QKV / MLP are gray (fp32 in an fp32 model), flash's
    # sdpa and linear white, the norms black; O2: all but the norms bf16
    low = {"scaled_dot_product_attention", "linear"}
    if level == "O2":
        low |= set(NAMED) - {"rms_norm", "embedding"}
    for op in NAMED:
        got = s.dtypes[op]
        if op == "embedding" and level == "O1":
            assert got == {"float32": 1}
        elif op == "embedding":
            assert got == {"bfloat16": 1}
        else:
            assert got == {("bfloat16" if op in low else "float32"):
                           NAMED[op]}, (op, got)


@pytest.mark.parametrize("level,want", [("O1", "float32"),
                                        ("O2", "bfloat16")])
def test_residual_stream_dtype_matches_jax(llama_pair, level, want,
                                           monkeypatch):
    """Where the port's ``x + h`` (a torch operator, off the hook) meets
    a black op's neighbours, its dtype is JAX's ``add``'s: fp32 + bf16
    promotes to fp32 at O1 in both; at O2 both operands are bf16."""
    jm, tm, ids, _ = llama_pair
    monkeypatch.setenv("PADDLE_TPU_FUSED_BLOCK", "1")
    x = np.random.default_rng(1).standard_normal((2, 16, 128)).astype(
        np.float32)
    jl, tl = jm.model.layers[0], tm.model.layers[0]
    with jamp.auto_cast(level=level):
        jx = jp.to_tensor(x)
        jout = jl(jx if level == "O1" else jx.astype("bfloat16"),
                  jm.model.rope_cos, jm.model.rope_sin)
    with tamp.auto_cast(level=level):
        tx = torch.from_numpy(x)
        tout = tl(tx if level == "O1" else tx.bfloat16(),
                  tm.model.rope_cos, tm.model.rope_sin)
    assert str(jout.dtype) == want and _dt(tout) == want
    np.testing.assert_allclose(tout.detach().float().numpy(),
                               np.asarray(jout.numpy(), np.float32),
                               rtol=3e-2, atol=3e-2)


def test_decorate_gives_bf16_params_and_fp32_masters():
    model = LlamaForCausalLM(LlamaConfig.tiny(**LLAMA), device="cpu")
    opt = TAdamW(learning_rate=1e-3, parameters=model.parameters())
    # a state made before decorate (as TrainStep makes them) gets its
    # master there
    early = next(iter(model.parameters()))
    opt._state_of(early, "early")
    model, opt = tamp.decorate(model, opt, level="O2", dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.model.rope_cos.dtype == torch.float32
    assert opt._multi_precision
    assert opt._accumulators[id(early)]["_master"].dtype == torch.float32
    scaler = tamp.GradScaler()
    ids = torch.randint(0, 256, (2, 16))
    with tamp.auto_cast(level="O2"):
        loss = model.loss(ids, ids)
    scaler.scale(loss).backward()
    scaler.step(opt)
    opt.clear_grad()
    for p in model.parameters():
        st = opt._accumulators[id(p)]
        assert st["_master"].dtype == torch.float32
        assert p.dtype == torch.bfloat16
        assert torch.equal(st["_master"].bfloat16(), p.detach())
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**LLAMA))
    jopt = jp.optimizer.AdamW(learning_rate=1e-3,
                              parameters=jm.parameters())
    jm2, jopt2 = jamp.decorate(jm, jopt, level="O2")
    assert jopt2._multi_precision and all(
        str(p.dtype) == "bfloat16" for p in jm2.parameters())


def _scaler_pair(**kw):
    rng = np.random.default_rng(11)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    jlin = jp.nn.Linear(4, 3)
    jlin.set_state_dict({"weight": w, "bias": b})
    tlin = TLinear(4, 3, device="cpu")
    tlin.set_state_dict({"weight": w, "bias": b})
    jopt = jp.optimizer.SGD(learning_rate=0.1, parameters=jlin.parameters())
    topt = TSGD(learning_rate=0.1, parameters=list(tlin.parameters()))
    return (jlin, jopt, jamp.GradScaler(**kw)), \
        (tlin, topt, tamp.GradScaler(**kw))


def test_grad_scaler_fp16_protocol_matches_jax():
    """Scale, one unscale, skip on a non-finite gradient, back off, grow
    after ``incr_every_n_steps`` good steps, ``state_dict`` — step for
    step with JAX's, under ``auto_cast(dtype="float16")``."""
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2,
              decr_ratio=0.5, incr_ratio=2.0)
    (jlin, jopt, js), (tlin, topt, ts) = _scaler_pair(**kw)
    x = np.random.default_rng(12).standard_normal((5, 4)).astype(np.float32)
    for step, blow in enumerate([False, True, False, False, True, False]):
        mult = 1e38 if blow else 1.0
        with jamp.auto_cast(dtype="float16"):
            jloss = jp.mean(jp.square(jlin(jp.to_tensor(x)))) * mult
        js.scale(jloss).backward()
        with tamp.auto_cast(dtype="float16"):
            tloss = tp.mean(tp.square(tlin(torch.from_numpy(x)))) * mult
        ts.scale(tloss).backward()
        before = [p.detach().clone() for p in tlin.parameters()]
        js.step(jopt)
        ts.step(topt)
        jopt.clear_grad()
        topt.clear_grad()
        assert ts._found_inf == js._found_inf == blow, step
        assert ts.state_dict() == js.state_dict(), step
        if blow:
            assert all(torch.equal(a, p.detach())
                       for a, p in zip(before, tlin.parameters()))
        for (n, jpar), tpar in zip(jlin.named_parameters(),
                                   tlin.parameters()):
            # the products run in float16: gradients agree to its 1e-3
            np.testing.assert_allclose(tpar.detach().numpy(),
                                       np.asarray(jpar.numpy()), rtol=1e-3,
                                       atol=1e-4, err_msg=f"{step} {n}")
    assert ts.get_loss_scaling() == 512.0   # x2 at step 3, x0.5 at 1 and 4
    fresh = tamp.GradScaler()
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict() == ts.state_dict()


@pytest.mark.parametrize("level", [0, 1])
def test_check_nan_inf_levels_match_jax(level, capsys):
    x = np.array([0.0, 1.0], np.float32)
    try:
        for fl, log, arr in ((jflags, jp.log, jp.to_tensor),
                             (tflags, tp.log, torch.from_numpy)):
            fl.set_flags({"check_nan_inf": True,
                          "check_nan_inf_level": level})
            if level == 0:
                with pytest.raises(FloatingPointError,
                                   match="op 'log' produced 1 non-finite"):
                    log(arr(x))
            else:
                log(arr(x))
                out = capsys.readouterr().out
                assert "[check_nan_inf] op 'log' produced 1 non-finite" \
                    in out
            fl.set_flags({"check_nan_inf": False})
            log(arr(x))            # off: no sweep
    finally:
        jflags.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0})
        tflags.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0})
    assert not dispatch._watch


def test_tensor_checker_and_numerics():
    cfg = tamp.debugging.TensorCheckerConfig(
        debug_mode=tamp.debugging.DebugMode.CHECK_NAN_INF)
    tamp.debugging.enable_tensor_checker(cfg)
    try:
        assert tflags.get("check_nan_inf") and \
            tflags.get("check_nan_inf_level") == 1
    finally:
        tamp.debugging.disable_tensor_checker()
    assert not dispatch._watch
    t = torch.tensor([0.0, float("nan"), float("inf"), 2.0])
    assert tamp.debugging.check_numerics(
        t, debug_mode=1) == jamp.debugging.check_numerics(
            t.numpy(), debug_mode=1) == (1, 1, 1)
    rep = tamp.debugging.compare_accuracy({"a": torch.ones(3)},
                                          {"a": torch.ones(3) + 1e-2})
    assert rep[0]["status"] == "mismatch"


def test_fast_path_calls_no_cast_and_no_stats(monkeypatch):
    """AMP, stats and the flag off: the wrapper reads the AMP context
    and one flag, then calls the op — no cast, no stats call."""
    calls = []
    monkeypatch.setattr(tamp, "maybe_cast_args",
                        lambda *a: calls.append("cast") or a[1])
    monkeypatch.setattr(tamp.debugging, "record_op",
                        lambda *a: calls.append("stats"))
    x = torch.randn(4, 8)
    w = torch.randn(8, 8)
    tp.matmul(x, w)
    TF.linear(x, w)
    TF.rms_norm(x)
    tp.add(x, x)
    tp.reshape(x, [8, 4])
    assert calls == []
    with tamp.auto_cast():
        TF.linear(x, w)
    assert calls == ["cast"]
    with tamp.debugging.collect_operator_stats():
        TF.linear(x, w)
    assert calls == ["cast", "stats"]


def test_fast_path_adds_no_op_to_a_traced_program():
    from torch.fx.experimental.proxy_tensor import make_fx

    def hooked(x, w):
        return tp.exp(TF.rms_norm(TF.linear(x, w)))

    def pure(x, w):
        return tp.exp.__wrapped_pure__(
            TF.rms_norm.__wrapped_pure__(TF.linear.__wrapped_pure__(x, w)))

    args = (torch.randn(4, 8), torch.randn(8, 8))
    g1 = make_fx(hooked)(*args)
    g2 = make_fx(pure)(*args)
    ops1 = [n.target for n in g1.graph.nodes if n.op == "call_function"]
    ops2 = [n.target for n in g2.graph.nodes if n.op == "call_function"]
    assert ops1 == ops2 and ops1
