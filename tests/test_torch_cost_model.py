"""The port's cost model (``paddle_tpu_torch/analysis``) against the JAX
package's on the CPU, and every kernel wrapper's charge against the
bound inputs of ``chip_smoke.py``.

Products cost exactly 2 M N K in both packages, so their FLOPs must be
equal: for a linear chain and for the tiny Llama's forward segments
(the same weights through ``set_state_dict``, the same activation).
Totals differ where the two count other operations: JAX charges an
unfused reference lowering (every intermediate, every reshape), the
port a fused kernel's inputs and outputs, and a view moves nothing.
Limits, stated here: total FLOPs within 5% of JAX's (elementwise
decompositions: JAX writes silu as logistic and a multiply, the port's
fused MLP charges its products only); bytes between a third of JAX's
and 1.25 times it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pp
import paddle_tpu.analysis as janalysis
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.observability import device_profiler as JDP

import chip_smoke
import paddle_tpu_torch.analysis as analysis
from paddle_tpu_torch.analysis import CostCounter
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import device_profiler as DP
from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import quant_matmul as QM

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
FLOPS_REL = 0.05
BYTES_RANGE = (1 / 3, 1.25)


def _jax_cost(fn, *args, **kwargs):
    return janalysis.check(fn, *args, passes=["cost-model"],
                           **kwargs).extras["cost"]


def _cost(fn, *args, **kwargs):
    return analysis.check(fn, *args, passes=["cost-model"],
                          **kwargs).extras["cost"]


def test_linear_chain_products_equal_jax():
    rng = np.random.default_rng(0)
    x, w1, w2 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((8, 32), (32, 64), (64, 16)))
    b1 = rng.standard_normal(64).astype(np.float32)
    j = _jax_cost(lambda x, w1, b1, w2: jnp.maximum(x @ w1 + b1, 0) @ w2,
                  *map(jnp.asarray, (x, w1, b1, w2)))
    t = _cost(lambda x, w1, b1, w2: torch.relu(x @ w1 + b1) @ w2,
              *map(torch.from_numpy, (x, w1, b1, w2)))
    assert t.product_flops == j.by_prim["dot_general"][0] == \
        2 * 8 * 32 * 64 + 2 * 8 * 64 * 16
    assert abs(t.total_flops - j.total_flops) <= FLOPS_REL * j.total_flops
    lo, hi = BYTES_RANGE        # JAX also charges b1's broadcast
    assert lo * j.total_bytes <= t.total_bytes <= hi * j.total_bytes


@pytest.fixture(scope="module")
def segments():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**TINY))
    tm = LlamaForCausalLM(LlamaConfig.tiny(**TINY), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    ids = np.random.default_rng(1).integers(0, 256, (2, 17))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    js = JDP.llama_step_segments(jm, batch)
    x = torch.from_numpy(np.asarray(js[1].args[1]))
    ts = DP.llama_step_segments(tm, batch, x=x)
    return {j.name: (j, t) for j, t in zip(js, ts)}


@pytest.mark.parametrize("name", ["rmsnorm", "rmsnorm_qkv", "attention",
                                  "mlp", "decoder_block", "lm_head_ce"])
def test_segment_costs_against_jax(segments, name):
    """Each forward segment of the tiny Llama: product FLOPs exactly
    JAX's; total FLOPs and bytes within the stated limits."""
    js, ts = segments[name]
    j = _jax_cost(js.fn, *js.args, **js.kwargs)
    t = _cost(ts.fn, *ts.args, **ts.kwargs)
    assert t.product_flops == j.by_prim.get("dot_general", (0,))[0]
    assert abs(t.total_flops - j.total_flops) <= FLOPS_REL * j.total_flops
    lo, hi = BYTES_RANGE
    assert lo * j.total_bytes <= t.total_bytes <= hi * j.total_bytes
    assert t.roofline_seconds() == max(t.total_flops / t.peak_flops,
                                       t.total_bytes / t.hbm_bw)


def test_summary_surface_and_h100_defaults():
    t = _cost(lambda a, b: (a @ b).sum(), torch.ones(4, 8),
              torch.ones(8, 2))
    assert (t.peak_flops, t.hbm_bw) == (989e12, 3.35e12)
    assert t.ridge == 989e12 / 3.35e12 and not t.compute_bound
    assert "aten.mm" in t.table() and t.to_diagnostics()
    r = analysis.check(lambda a: a * 2, torch.ones(3), passes=["cost-model"],
                       options={"peak_flops": 1e12, "hbm_bw": 1e9})
    assert r.extras["cost"].peak_flops == 1e12
    assert r.passes_run == ["cost-model"]


@pytest.mark.parametrize("pass_id", ["dead-code", "recompile-hazard",
                                     "autoshard", "no-such-pass"])
def test_other_passes_name_item_10(pass_id):
    ran = []
    with pytest.raises(NotImplementedError, match="item 10"):
        analysis.check(lambda a: ran.append(a), torch.ones(1),
                       passes=["cost-model", pass_id])
    assert not ran       # refused before anything ran


def test_views_are_free_and_ptt_ops_count_once():
    """A view moves nothing; the MLP under autograd (its forward the
    ``ptt::fused_mlp`` op) is counted by the wrapper inside it, once,
    and none of its plain version's operators again."""
    x = torch.randn(16, 64)
    run = CostCounter()
    with run:
        x.reshape(4, 4, 64).transpose(0, 1)
    assert run.total_bytes == 0 and run.total_flops == 0
    wg, wu, wd = (torch.randn(s, requires_grad=True)
                  for s in ((64, 128), (64, 128), (128, 64)))
    run = CostCounter()
    with run:
        FB.FusedMLP.apply(x, wg, wu, wd)
    assert set(run.by_prim) == {"fused_mlp"}
    assert run.by_prim["fused_mlp"][2] == 1


def test_counter_refuses_nesting_and_clears():
    with CostCounter():
        with pytest.raises(RuntimeError, match="already running"):
            with CostCounter():
                pass
    assert _build.COUNTER is None


# -- each wrapper's charge against chip_smoke.py's bound inputs --------------

def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(torch.bfloat16)


def _charge(fn, *args, **kwargs):
    run = CostCounter()
    with run:
        fn(*args, **kwargs)
    return run


def _case(name, monkeypatch):
    """(the wrapper's call, chip_smoke's (bytes, flops)) at a small
    bf16 shape."""
    rng = np.random.default_rng(7)
    T, d, dq, dkv, f = 32, 256, 256, 128, 512
    if name in ("fused_rmsnorm_qkv", "qkv_train"):
        x, wn = _bf16(rng, T, d), _bf16(rng, d)
        ws = _bf16(rng, d, dq), _bf16(rng, d, dkv), _bf16(rng, d, dkv)
        train = name == "qkv_train"
        return (lambda: K.fused_rmsnorm_qkv(x, wn, *ws, 1e-5,
                                            residuals=train),
                chip_smoke.qkv_io(T, train=train, d=d, dq=dq, dkv=dkv))
    if name == "fused_mlp":
        x = _bf16(rng, T, d)
        ws = _bf16(rng, d, f), _bf16(rng, d, f), _bf16(rng, f, d)
        return (lambda: K.fused_mlp(x, *ws), chip_smoke.mlp_io(T, d=d, f=f))
    if name == "fused_ffn":
        x = _bf16(rng, T, d)
        w1, w2 = _bf16(rng, d, f), _bf16(rng, f, d)
        b1, b2 = _bf16(rng, f), _bf16(rng, d)
        return (lambda: K.fused_ffn(x, w1, w2, b1, b2, "gelu"),
                chip_smoke.ffn_io(T, 2, d, f))
    if name in ("paged_decode_attention", "paged_decode_attention_int8"):
        B, h, kvh, hd, bs, mb = 4, 4, 2, 128, 16, 4
        nb = 1 + B * mb
        q = _bf16(rng, B, h, hd)
        bt = torch.arange(1, nb, dtype=torch.int32).reshape(B, mb)
        lengths = torch.tensor([1, 17, 40, 64], dtype=torch.int32)
        int8 = name.endswith("int8")
        if int8:
            kp = torch.from_numpy(rng.integers(-127, 128, (nb, bs, kvh, hd),
                                               dtype=np.int8))
            vp = kp.clone()
            ks, vs = torch.rand(nb, bs, kvh), torch.rand(nb, bs, kvh)
            call = (lambda: K.paged_decode_attention_int8(
                q, kp, vp, bt, lengths, ks, vs))
        else:
            kp, vp = _bf16(rng, nb, bs, kvh, hd), _bf16(rng, nb, bs, kvh, hd)
            call = (lambda: K.paged_decode_attention(q, kp, vp, bt, lengths))
        return call, chip_smoke.paged_io(B, h, kvh, hd, mb,
                                         int(lengths.sum()), int8=int8)
    if name == "quant_matmul":
        x = _bf16(rng, T, d)
        qw = torch.from_numpy(rng.integers(-127, 128, (d, f), dtype=np.int8))
        scale = torch.rand(f)
        return (lambda: QM.quant_matmul(x, qw, scale),
                chip_smoke.quant_io(T, d, f, 2))
    if name.startswith("flash"):
        b, s, h, hk, hd = 1, 64, 2, 1, 128
        q, k, v, do = (_bf16(rng, b, s, n, hd) for n in (h, hk, hk, h))
        lse, delta = torch.zeros(b, h, s), torch.zeros(b, h, s)
        fwd, dq_, dkv_ = chip_smoke.flash_bounds(b, s, h, hk)
        return {"flash_attention_fwd": (
                    lambda: K.flash_attention_fwd(q, k, v, True), fwd),
                "flash_attention_bwd_dq": (
                    lambda: K.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                     True), dq_),
                "flash_attention_bwd_dkv": (
                    lambda: K.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, True), dkv_),
                }[name]
    if name.startswith("cross_entropy"):
        V = 512
        x = _bf16(rng, T, V)
        lbl = torch.from_numpy(rng.integers(0, V, T))
        fwd, bwd = chip_smoke.ce_io(T, V, 2)
        if name.endswith("fwd"):
            return (lambda: K.cross_entropy_fwd(x, lbl)), fwd
        lse, g = torch.zeros(T), torch.ones(T)
        return (lambda: K.cross_entropy_bwd(x, lbl, lse, g)), bwd
    if name == "fused_rmsnorm":
        x, r, w = _bf16(rng, T, d), _bf16(rng, T, d), _bf16(rng, d)
        return (lambda: K.fused_rmsnorm(x, w, r),
                chip_smoke.rmsnorm_io(T, d, 2, True))
    if name == "grouped_expert_ffn":
        E, G, C, dm, hm = 2, 4, 8, 128, 128
        x = _bf16(rng, G, C, dm)
        w1, w2 = _bf16(rng, E, dm, hm), _bf16(rng, E, hm, dm)
        b1, b2 = _bf16(rng, E, hm), _bf16(rng, E, dm)
        counts = torch.tensor([8, 3, 0, 5], dtype=torch.int32)
        return (lambda: K.grouped_expert_ffn(x, w1, b1, w2, b2,
                                             counts=counts),
                chip_smoke.grouped_io(int(counts.sum()), G, C, 2, E, dm, hm))
    if name == "fused_decoder_block":
        for attr, val in dict(D=d, DQ=dq, DKV=dkv, F=f, DEC_H=2,
                              DEC_HD=128).items():
            monkeypatch.setattr(chip_smoke, attr, val)
        b, s = 1, 64
        args = (_bf16(rng, b, s, d), _bf16(rng, d), _bf16(rng, d, dq),
                _bf16(rng, d, dkv), _bf16(rng, d, dkv))
        cos, sin = torch.ones(128, 64), torch.zeros(128, 64)
        rest = (_bf16(rng, dq, d), _bf16(rng, d), _bf16(rng, d, f),
                _bf16(rng, d, f), _bf16(rng, f, d))
        nbytes, flops, _ = chip_smoke.decoder_bound(b, s, torch.bfloat16)
        return (lambda: K.fused_decoder_block(*args, cos, sin, *rest, 2, 1),
                (nbytes, flops))
    if name in ("multi_tensor_norm", "multi_tensor_adam"):
        ps = [_bf16(rng, 64, 32), _bf16(rng, 100)]
        gs = [_bf16(rng, *p.shape) for p in ps]
        if name == "multi_tensor_norm":
            return (lambda: K.multi_tensor_norm(gs), chip_smoke.norm_io(gs))
        ms = [torch.zeros(p.shape) for p in ps]
        vs = [torch.zeros(p.shape) for p in ps]
        masters = [p.float() for p in ps]
        return (lambda: K.multi_tensor_adam(ps, gs, ms, vs, masters, lr=1e-3,
                                            step=1, multi_precision=True),
                chip_smoke.adam_io(ps, gs, masters))
    if name == "multi_tensor_digest":
        ts = [_bf16(rng, 64, 32), torch.ones(100),
              torch.zeros(7, dtype=torch.int8)]
        return (lambda: K.multi_tensor_digest(ts), chip_smoke.digest_io(ts))
    raise KeyError(name)


WRAPPERS = [fn.__name__ for fn in K.KERNELS]


def test_every_wrapper_is_charged_here():
    assert len(WRAPPERS) == 17 and len(set(WRAPPERS)) == 17


@pytest.mark.parametrize("name", WRAPPERS + ["qkv_train"])
def test_kernel_charge_equals_chip_smoke_bound(name, monkeypatch):
    """The wrapper on the CPU (its plain version) charges its kernel's
    operations and bytes, the numbers chip_smoke.py's bound_ms is
    computed from, and nothing of the plain version's operators."""
    call, (nbytes, flops) = _case(name, monkeypatch)
    run = _charge(call)
    what = "fused_rmsnorm_qkv" if name == "qkv_train" else name
    assert tuple(run.by_prim[what]) == (flops, nbytes, 1)
    counted = {k for k, v in run.by_prim.items() if v[0] or v[1]}
    assert counted == {what}, counted
    products = what not in ("cross_entropy_fwd", "cross_entropy_bwd",
                            "fused_rmsnorm", "multi_tensor_norm",
                            "multi_tensor_adam", "multi_tensor_digest")
    assert run.product_flops == (flops if products else 0)


def test_no_counter_no_charge(monkeypatch):
    """With no count running the hook is one None check: a wrapper call
    leaves nothing behind."""
    assert _build.COUNTER is None
    call, _ = _case("fused_mlp", monkeypatch)
    call()
    assert _build.COUNTER is None
