"""The kernel path counters and the MoE router metrics against the JAX
package's, on the CPU: the same calls through both packages move the
same series by the same amounts under the same label sets (each package
writes its own process-wide registry; the tests compare deltas).  On the
CPU every path is the plain one: ``reference`` / ``fallback``, as JAX's
off the TPU; the card's labels (``fused`` / ``pallas`` / ``grouped``
where a CUDA kernel launched) are held by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pp
from paddle_tpu import observability as JO
from paddle_tpu.core.dispatch import unwrap
from paddle_tpu.distributed import moe as JM
from paddle_tpu.inference.kv_cache import PagedCache as JPagedCache
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.nn import TransformerEncoderLayer as JEncoderLayer
from paddle_tpu.quantization import serving as JQS

from paddle_tpu_torch import observability as TO
from paddle_tpu_torch.distributed import moe as TM
from paddle_tpu_torch.inference.kv_cache import PagedCache
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import TransformerEncoderLayer
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.quantization import serving as TQS

PATHS = ("paddle_tpu_fused_block_path_total",
         "paddle_tpu_quant_kernel_path_total",
         "paddle_tpu_paged_attention_path_total",
         "paddle_tpu_grouped_moe_path_total")
ROUTER = ("paddle_tpu_moe_dropped_tokens_total",
          "paddle_tpu_moe_capacity_overflow_total",
          "paddle_tpu_moe_aux_loss", "paddle_tpu_moe_expert_load",
          "paddle_tpu_moe_expert_imbalance")


def _snap(mod, names):
    """{series name: {label values: value}} of one package's registry."""
    reg = mod.default_registry()
    out = {}
    for name in names:
        m = reg.get(name)
        if m is not None:
            out[name] = {k: c.value() for k, c in m.series()}
    return out


def _delta(after, before):
    out = {}
    for name, series in after.items():
        d = {k: v - before.get(name, {}).get(k, 0.0)
             for k, v in series.items()
             if v != before.get(name, {}).get(k, 0.0)}
        if d:
            out[name] = d
    return out


def _moved(fn_j, fn_t, names=PATHS):
    """Run both calls; each package's moved series."""
    jb, tb = _snap(JO, names), _snap(TO, names)
    fn_j()
    fn_t()
    return _delta(_snap(JO, names), jb), _delta(_snap(TO, names), tb)


@pytest.fixture(scope="module")
def pair():
    pp.seed(0)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny())
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _labels(mod, name):
    m = mod.default_registry().get(name)
    return m.kind, tuple(m.labelnames)


def test_llama_forward_moves_the_fused_block_series_like_jax(pair):
    """One cache-free forward: ``rmsnorm_qkv`` and ``mlp`` once a layer,
    path ``reference`` off the card, in both packages."""
    jm, tm = pair
    ids = np.random.default_rng(0).integers(0, 256, (2, 9))
    dj, dt = _moved(lambda: jm(pp.to_tensor(ids.astype(np.int32))),
                    lambda: tm(torch.as_tensor(ids)))
    assert dt == dj
    assert dt["paddle_tpu_fused_block_path_total"] == {
        ("rmsnorm_qkv", "reference"): 2.0, ("mlp", "reference"): 2.0}
    name = "paddle_tpu_fused_block_path_total"
    assert _labels(TO, name) == _labels(JO, name)


def test_quantized_forward_moves_the_quant_series_like_jax(pair):
    """A weight-only int8 model's forward: each converted projection (11
    of the tiny model's 15 pass ``min_size``) once in
    ``{kernel="matmul_int8", path="fallback"}``, the fused
    block's layers on ``reference``, in both packages."""
    jm, tm = pair
    JQS.quantize_for_serving(jm, "int8")
    TQS.quantize_for_serving(tm, "int8")
    try:
        tm.set_state_dict({k: v.numpy() for k, v in
                           jm.state_dict().items()})
        ids = np.random.default_rng(1).integers(0, 256, (1, 5))
        dj, dt = _moved(lambda: jm(pp.to_tensor(ids.astype(np.int32))),
                        lambda: tm(torch.as_tensor(ids)))
    finally:
        JQS.restore_from_serving(jm)
        TQS.restore_from_serving(tm)
    assert dt == dj
    assert dt["paddle_tpu_quant_kernel_path_total"] == {
        ("matmul_int8", "fallback"): 11.0}
    name = "paddle_tpu_quant_kernel_path_total"
    assert _labels(TO, name) == _labels(JO, name)


def test_paged_forward_moves_the_paged_series_like_jax(pair):
    """A chunk and a decode step through paged caches: every layer's
    attention once in ``{path="fallback"}`` off the card."""
    jm, tm = pair
    B, bs, mb, kvh, hd = 1, 4, 4, 2, 16
    nb = 1 + B * mb
    bt = np.arange(1, nb, dtype=np.int32).reshape(B, mb)
    shape = (nb, bs, kvh, hd)
    jk = [jnp.zeros(shape) for _ in range(2)]
    jv = [jnp.zeros(shape) for _ in range(2)]
    tk = [torch.zeros(shape) for _ in range(2)]
    tv = [torch.zeros(shape) for _ in range(2)]
    for S, pos in ((5, 0), (1, 5)):
        ids = np.random.default_rng(S).integers(0, 256, (B, S))
        p = np.asarray([pos], np.int32)

        def jrun():
            caches = [JPagedCache(k, v, jnp.asarray(bt))
                      for k, v in zip(jk, jv)]
            _, new = jm(pp.to_tensor(ids.astype(np.int32)), None, caches,
                        jnp.asarray(p))
            jk[:] = [unwrap(c.k) for c in new]
            jv[:] = [unwrap(c.v) for c in new]

        def trun():
            caches = [PagedCache(k, v, torch.from_numpy(bt))
                      for k, v in zip(tk, tv)]
            with torch.inference_mode():
                tm(torch.as_tensor(ids), None, caches, torch.from_numpy(p))

        dj, dt = _moved(jrun, trun)
        assert dt == dj
        assert dt["paddle_tpu_paged_attention_path_total"] == {
            ("fallback",): 2.0}
    name = "paddle_tpu_paged_attention_path_total"
    assert _labels(TO, name) == _labels(JO, name)


def test_transformer_ffn_moves_the_fused_block_series_like_jax():
    """nn.Transformer's feed-forward: ``{kernel="ffn", path=
    "reference"}`` once a layer call off the card, in both packages."""
    pp.seed(2)
    jl = JEncoderLayer(64, 4, 128, dropout=0.0)
    tl = TransformerEncoderLayer(64, 4, 128, dropout=0.0, device="cpu")
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    jl.eval()
    tl.eval()
    x = np.random.default_rng(3).standard_normal((2, 6, 64)).astype(
        np.float32)
    dj, dt = _moved(lambda: jl(pp.to_tensor(x)),
                    lambda: tl(torch.from_numpy(x)))
    assert dt == dj == {"paddle_tpu_fused_block_path_total": {
        ("ffn", "reference"): 1.0}}


def _moe_pair(mode):
    pp.seed(4)
    kw = dict(d_model=16, num_experts=4, d_hidden=32, top_k=2,
              capacity_factor=0.5, dispatch_mode=mode)
    jl = JM.MoELayer(**kw)
    tl = TM.MoELayer(**kw, device="cpu")
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


@pytest.mark.parametrize("mode", ["einsum", "index"])
def test_router_metrics_equal_jax(mode):
    """One routed forward: the dropped-token and overflow counters move
    by the same amounts, the aux-loss gauge (and, in the einsum mode, the
    per-expert load and imbalance gauges) read the same values (1e-6);
    the grouped counter moves in neither package off the card.  Gauges
    are compared by value, not by delta: other tests in the process may
    have set them to other values in each package's registry."""
    jl, tl = _moe_pair(mode)
    x = np.random.default_rng(5).standard_normal((2, 8, 16)).astype(
        np.float32)
    counters = PATHS + ROUTER[:2]
    dj, dt = _moved(lambda: jl(pp.to_tensor(x)),
                    lambda: tl(torch.from_numpy(x)), counters)
    assert "paddle_tpu_grouped_moe_path_total" not in dt
    assert set(dt) == set(dj) == set(ROUTER[:2])
    for name in dj:
        assert set(dt[name]) == set(dj[name]), name
        for k in dj[name]:
            assert dt[name][k] == pytest.approx(dj[name][k], rel=1e-6,
                                                abs=1e-6), (name, k)
    gauges = _snap(TO, ROUTER)
    jg = _snap(JO, ROUTER)
    assert gauges["paddle_tpu_moe_aux_loss"][()] == pytest.approx(
        jg["paddle_tpu_moe_aux_loss"][()], rel=1e-6)
    if mode == "einsum":
        for e in range(tl.num_experts):
            assert gauges["paddle_tpu_moe_expert_load"][(str(e),)] == \
                jg["paddle_tpu_moe_expert_load"][(str(e),)]
        assert gauges["paddle_tpu_moe_expert_imbalance"][()] == \
            pytest.approx(jg["paddle_tpu_moe_expert_imbalance"][()])
    for name in ROUTER:
        assert _labels(TO, name) == _labels(JO, name)


def test_router_metrics_record_nothing_inside_a_train_step():
    """TrainStep's body records no router metric (JAX skips them under
    its trace); the same layer's eager forward outside it does."""
    _, tl = _moe_pair("einsum")
    step = TrainStep(tl, SGD(learning_rate=0.1, parameters=tl.parameters()),
                     loss_fn=lambda out, y: ((out - y) ** 2).mean())
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 8, 16)).astype(np.float32))
    before = _snap(TO, ROUTER)
    step((x, torch.zeros_like(x)))
    assert _delta(_snap(TO, ROUTER), before) == {}
    with TM.router_metrics_paused():
        tl(x)
    assert _delta(_snap(TO, ROUTER), before) == {}
    tl(x)
    assert _delta(_snap(TO, ROUTER), before)
