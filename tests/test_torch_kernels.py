"""The PyTorch port's kernel modules and the functions around them,
against the JAX package on the same inputs (CPU).

Each port module that holds a kernel is held to its JAX counterpart:
the port's wrapper takes its plain version on CPU tensors, the JAX
function runs its Pallas kernel in interpret mode.  Inputs are made with
``numpy.random.default_rng`` and handed to both; everything is fp32 and
must agree within 1e-5 (summation order only), unless a test states
otherwise.  The same kernels on the card are tested in
``test_torch_cuda.py``."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import fused_block as JFB
from paddle_tpu.ops.pallas import paged_attention as JPA

from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import paged_attention as PA

ATOL = 1e-5


def _both(rng, shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, ref, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("T,d,dq,dkv", [(16, 128, 128, 128),
                                        (32, 128, 256, 128)])
def test_fused_rmsnorm_qkv_matches_pallas(T, d, dq, dkv):
    rng = np.random.default_rng(T + dq)
    jx, tx = _both(rng, (T, d))
    jn, tn = _both(rng, (d,))
    jq, tq = _both(rng, (d, dq), 0.05)
    jk, tk = _both(rng, (d, dkv), 0.05)
    jv, tv = _both(rng, (d, dkv), 0.05)
    ref = JFB.fused_rmsnorm_qkv(jx, jn, jq, jk, jv, epsilon=1e-5,
                                use_pallas=True, interpret=True)
    got = FB.fused_rmsnorm_qkv(tx, tn, tq, tk, tv, epsilon=1e-5)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        _close(g, r)


@pytest.mark.parametrize("T,d,f", [(16, 128, 256), (32, 128, 512)])
def test_fused_mlp_matches_pallas(T, d, f):
    rng = np.random.default_rng(T + f)
    jx, tx = _both(rng, (T, d))
    jg, tg = _both(rng, (d, f), d ** -0.5)
    ju, tu = _both(rng, (d, f), d ** -0.5)
    jd, td = _both(rng, (f, d), f ** -0.5)
    ref = JFB.fused_mlp(jx, jg, ju, jd, use_pallas=True, interpret=True)
    got = FB.fused_mlp(tx, tg, tu, td)
    assert tuple(got.shape) == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("B,h,kvh,hd,bs,lengths", [
    (3, 4, 2, 16, 4, [5, 9, 16]),
    (4, 8, 2, 32, 8, [1, 8, 17, 32]),     # 1 = an inactive row's scratch read
])
def test_paged_decode_matches_pallas(B, h, kvh, hd, bs, lengths):
    rng = np.random.default_rng(B * h)
    nb, mb = 9, 4
    jq, tq = _both(rng, (B, h, hd))
    jk, tk = _both(rng, (nb, bs, kvh, hd))
    jv, tv = _both(rng, (nb, bs, kvh, hd))
    bt = rng.integers(1, nb, size=(B, mb)).astype(np.int32)
    bt[0] = 0
    ln = np.asarray(lengths, np.int32)
    ref = JPA.paged_decode_attention(jq, jk, jv, jnp.asarray(bt),
                                     jnp.asarray(ln), interpret=True)
    got = PA.paged_decode_attention(tq, tk, tv, torch.from_numpy(bt),
                                    torch.from_numpy(ln))
    _close(got, ref)


def test_wrappers_count_only_kernel_launches():
    """A CPU tensor takes the plain version, which is not a launch."""
    x = torch.randn(4, 64)
    w = torch.randn(64, 64)
    before = (FB.fused_rmsnorm_qkv.launches, FB.fused_mlp.launches)
    FB.fused_rmsnorm_qkv(x, torch.ones(64), w, w, w)
    FB.fused_mlp(x, w, w, w)
    assert (FB.fused_rmsnorm_qkv.launches, FB.fused_mlp.launches) == before


# -- functionals around the kernels ------------------------------------------

def test_rms_norm_matches_jax():
    from paddle_tpu.nn import functional as JF
    rng = np.random.default_rng(1)
    jx, tx = _both(rng, (3, 5, 64))
    jw, tw = _both(rng, (64,))
    _close(TF.rms_norm(tx, tw, 1e-5),
           np.asarray(JF.rms_norm(jx, jw, 1e-5)))


def test_rotary_freqs_match_jax():
    from paddle_tpu.nn.functional.attention import rotary_freqs
    jc, js = rotary_freqs(32, 64, base=500000.0)
    tc, ts = TF.rotary_freqs(32, 64, base=500000.0)
    # fp32 pow and cos/sin of angles up to 63 rad: a few ulp of 63
    _close(tc, np.asarray(jc), atol=2e-5)
    _close(ts, np.asarray(js), atol=2e-5)


@pytest.mark.parametrize("offset", [0, 5, "rows"])
def test_apply_rotary_emb_matches_jax(offset):
    from paddle_tpu.nn.functional.attention import (apply_rotary_emb,
                                                    rotary_freqs)
    rng = np.random.default_rng(2)
    jx, tx = _both(rng, (3, 4, 2, 16))
    cos, sin = rotary_freqs(16, 32)
    tcos, tsin = torch.from_numpy(np.array(cos)), \
        torch.from_numpy(np.array(sin))
    if offset == "rows":
        off = np.asarray([0, 7, 28], np.int32)
        joff, toff = jnp.asarray(off), torch.from_numpy(off)
    else:
        joff = toff = offset
    ref = apply_rotary_emb(jx, cos, sin, joff)
    got = TF.apply_rotary_emb(tx, tcos, tsin, toff)
    _close(got, np.asarray(ref))


@pytest.mark.parametrize("offset", [29, "rows"])
def test_apply_rotary_emb_raises_past_the_table(offset):
    """The JAX package clamps per-row positions past the table
    (attention.py:246); the port refuses them, like the scalar form."""
    x = torch.zeros(2, 4, 1, 8)
    cos, sin = TF.rotary_freqs(8, 32)
    off = torch.tensor([0, 29], dtype=torch.int32) if offset == "rows" \
        else offset
    with pytest.raises(ValueError, match="RoPE table overflow"):
        TF.apply_rotary_emb(x, cos, sin, off)


@pytest.mark.parametrize("case", ["causal", "gqa_causal", "bool_mask",
                                  "additive_mask"])
def test_sdpa_matches_jax_reference(case):
    from paddle_tpu.nn.functional.attention import _sdpa_reference
    rng = np.random.default_rng(3)
    kvh = 2 if case == "gqa_causal" else 4
    jq, tq = _both(rng, (2, 5, 4, 16))
    jk, tk = _both(rng, (2, 7, kvh, 16))
    jv, tv = _both(rng, (2, 7, kvh, 16))
    jm = tm = None
    if case == "bool_mask":
        m = rng.random((2, 1, 5, 7)) > 0.3
        m[..., 0] = True
        jm, tm = jnp.asarray(m), torch.from_numpy(m)
    elif case == "additive_mask":
        jm, tm = _both(rng, (2, 1, 5, 7))
    causal = case in ("causal", "gqa_causal")
    ref = _sdpa_reference(jq, jk, jv, jm, is_causal=causal)
    got = TF.scaled_dot_product_attention(tq, tk, tv, attn_mask=tm,
                                          is_causal=causal)
    _close(got, np.asarray(ref))


# -- the package boundary -----------------------------------------------------

def test_package_imports_neither_jax_nor_paddle_tpu():
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.models, paddle_tpu_torch.inference\n"
        "import paddle_tpu_torch.ops.kernels\n"
        "import paddle_tpu_torch.optimizer, paddle_tpu_torch.jit\n"
        "import paddle_tpu_torch.quantization\n"
        "import paddle_tpu_torch.quantization.serving\n"
        "import paddle_tpu_torch.ops.kernels.quant_matmul\n"
        "import paddle_tpu_torch.ops.kernels.cross_entropy\n"
        "import paddle_tpu_torch.nn.transformer\n"
        "import paddle_tpu_torch.nn.loss_layers\n"
        "import paddle_tpu_torch.nn.functional.common\n"
        "import paddle_tpu_torch.models.gpt\n"
        "import paddle_tpu_torch.ops.kernels.rmsnorm\n"
        "import paddle_tpu_torch.nn.functional.norm\n"
        "import paddle_tpu_torch.nn.functional.fused\n"
        "import paddle_tpu_torch.inference.kv_tier\n"
        "import paddle_tpu_torch.inference.router\n"
        "import paddle_tpu_torch.robustness\n"
        "import paddle_tpu_torch.robustness.faults\n"
        "import paddle_tpu_torch.observability\n"
        "import paddle_tpu_torch.observability.metrics\n"
        "import paddle_tpu_torch.observability.recorder\n"
        "import paddle_tpu_torch.observability.exposition\n"
        "import paddle_tpu_torch.observability.tracing\n"
        "import paddle_tpu_torch.observability.forensics\n"
        "import paddle_tpu_torch.observability.goodput\n"
        "import paddle_tpu_torch.observability.watchdog\n"
        "import paddle_tpu_torch.observability.fleet\n"
        "import paddle_tpu_torch.observability.device_profiler\n"
        "import paddle_tpu_torch.observability.calibration\n"
        "import paddle_tpu_torch.observability.demo\n"
        "import paddle_tpu_torch.analysis\n"
        "import paddle_tpu_torch.analysis.diagnostics\n"
        "import paddle_tpu_torch.analysis.recompile\n"
        "import paddle_tpu_torch.analysis.passes\n"
        "import paddle_tpu_torch.analysis.passes.cost_model\n"
        "import paddle_tpu_torch.profiler\n"
        "import paddle_tpu_torch.ops.kernels.costs\n"
        "import paddle_tpu_torch.jit.train_step\n"
        "import paddle_tpu_torch.generation\n"
        "import paddle_tpu_torch.compile_cache\n"
        "import paddle_tpu_torch.distributed.checkpoint\n"
        "import paddle_tpu_torch.distributed.tcp_store\n"
        "import paddle_tpu_torch.distributed.elastic\n"
        "import paddle_tpu_torch.robustness.recovery\n"
        "import paddle_tpu_torch.utils.cpp_extension\n"
        "import paddle_tpu_torch.ops.gen.generate\n"
        "import paddle_tpu_torch.amp.debugging, paddle_tpu_torch.fft\n"
        "import paddle_tpu_torch.device, paddle_tpu_torch.core.dispatch\n"
        "import paddle_tpu_torch.framework, paddle_tpu_torch.framework.io_\n"
        "import paddle_tpu_torch.io.dataset, paddle_tpu_torch.io.dataloader\n"
        "import paddle_tpu_torch.io.token_dataset, paddle_tpu_torch.metric\n"
        "import paddle_tpu_torch.hapi, paddle_tpu_torch.hapi.model\n"
        "import paddle_tpu_torch.hapi.callbacks, paddle_tpu_torch.hapi.summary\n"
        "import paddle_tpu_torch.nn.functional.loss\n"
        "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu') or\n"
        "       m.startswith(('jax.', 'jaxlib', 'paddle_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# -- the training slice: flash attention, the fused blocks' VJPs -------------

def _bhsd(t):
    return jnp.swapaxes(t, 1, 2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hk", [(1, 4), (1, 2), (2, 4), (2, 2)])
def test_flash_fwd_matches_pallas(b, hk, causal):
    """Plain out and lse against ``_fwd_pallas`` in interpret mode (s=256,
    4 query heads, d=128).  fp32 sums of 128 products in another order
    and another blocking of the softmax: 2e-5."""
    rng = np.random.default_rng(10 * b + hk)
    s, h, d = 256, 4, 128
    jq, tq = _both(rng, (b, s, h, d))
    jk, tk = _both(rng, (b, s, hk, d))
    jv, tv = _both(rng, (b, s, hk, d))
    ref, ref_lse = JFA._fwd_pallas(_bhsd(jq), _bhsd(jk), _bhsd(jv),
                                   scale=d ** -0.5, causal=causal,
                                   block_q=128, block_k=128, interpret=True)
    out, lse = FA.flash_attention_fwd(tq, tk, tv, causal)
    _close(out, np.asarray(_bhsd(ref)), atol=2e-5, rtol=2e-5)
    _close(lse, np.asarray(ref_lse), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pallas_bwd", [True, False])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hk", [(1, 4), (2, 2)])
def test_flash_bwd_matches_jax(b, hk, causal, pallas_bwd):
    """dq/dk/dv through the port's autograd Function against jax.grad of
    the JAX flash attention with its Pallas dq/dkv kernels
    (``pallas_bwd=True``) and with its in-model blockwise recompute
    (``False``).  fp32; sums over 256 keys and a GQA group in another
    order: 5e-5 of values of order one."""
    rng = np.random.default_rng(20 * b + hk)
    s, h, d = 256, 4, 128
    jq, tq = _both(rng, (b, s, h, d))
    jk, tk = _both(rng, (b, s, hk, d))
    jv, tv = _both(rng, (b, s, hk, d))
    jg, tg = _both(rng, (b, s, h, d))
    _, vjp = jax.vjp(lambda q, k, v: JFA.flash_attention(
        q, k, v, causal=causal, interpret=True, pallas_bwd=pallas_bwd),
        jq, jk, jv)
    refs = vjp(jg)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    FA.flash_attention(*leaves, causal=causal).backward(tg)
    for t, r in zip(leaves, refs):
        _close(t.grad, np.asarray(r), atol=5e-5, rtol=5e-5)


def test_sdpa_on_cpu_takes_the_reference_at_flash_shapes():
    """A flash-eligible shape (s=128, d=128, no mask) on the CPU equals
    JAX's ``_sdpa_reference`` and never reaches the flash wrappers."""
    from paddle_tpu.nn.functional.attention import _sdpa_reference
    rng = np.random.default_rng(4)
    jq, tq = _both(rng, (1, 128, 4, 128))
    jk, tk = _both(rng, (1, 128, 2, 128))
    jv, tv = _both(rng, (1, 128, 2, 128))
    before = [fn.launches for fn in (FA.flash_attention_fwd,
                                     FA.flash_attention_bwd_dq,
                                     FA.flash_attention_bwd_dkv)]
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    got = TF.scaled_dot_product_attention(*leaves, is_causal=True)
    got.sum().backward()
    _close(got.detach(), np.asarray(_sdpa_reference(jq, jk, jv,
                                                    is_causal=True)))
    assert [fn.launches for fn in (FA.flash_attention_fwd,
                                   FA.flash_attention_bwd_dq,
                                   FA.flash_attention_bwd_dkv)] == before


def test_flash_wrapper_on_cpu_takes_any_head_dim_and_checks_groups():
    """On the CPU the wrapper is the plain version, which takes any
    head_dim (the kernels take 128 only); heads that are not a multiple
    of kv heads are refused on every device."""
    q = torch.zeros(1, 64, 2, 64)
    out, lse = FA.flash_attention_fwd(q, q, q, True)
    assert out.shape == q.shape and lse.shape == (1, 2, 64)
    with pytest.raises(ValueError, match="kv heads"):
        FA.flash_attention_fwd(q, q[:, :, :1].expand(1, 64, 3, 64)
                               .contiguous(), q[:, :, :1].expand(
                                   1, 64, 3, 64).contiguous())


def test_qkv_residuals_match_pallas_training_variant():
    """The residual outputs (q, k, v, xn, inv) against ``_qkv_pallas``
    with ``residuals=True`` in interpret mode."""
    rng = np.random.default_rng(8)
    T, d, dq, dkv = 32, 128, 256, 128
    jx, tx = _both(rng, (T, d))
    jn, tn = _both(rng, (d,))
    jq, tq = _both(rng, (d, dq), 0.05)
    jk, tk = _both(rng, (d, dkv), 0.05)
    jv, tv = _both(rng, (d, dkv), 0.05)
    ref = JFB._qkv_pallas(jx, jn, jq, jk, jv, eps=1e-5, block_t=16,
                          block_o=128, interpret=True, residuals=True)
    got = FB.fused_rmsnorm_qkv(tx, tn, tq, tk, tv, 1e-5, residuals=True)
    assert len(got) == 5 and tuple(got[4].shape) == (T, 1)
    for g, r in zip(got, ref):
        _close(g, np.asarray(r))


def test_fused_rmsnorm_qkv_grads_match_pallas_vjp():
    """Grads of every input through ``FusedRMSNormQKV`` against the JAX
    custom VJP around the Pallas kernel (interpret mode), for the same
    random cotangents.  fp32: 2e-5."""
    rng = np.random.default_rng(9)
    T, d, dq, dkv = 32, 128, 256, 128
    arrs = [_both(rng, sh, sc) for sh, sc in (((2, 16, d), 1.0), ((d,), 1.0),
                                              ((d, dq), 0.05),
                                              ((d, dkv), 0.05),
                                              ((d, dkv), 0.05))]
    cts = [_both(rng, (2, 16, n)) for n in (dq, dkv, dkv)]
    _, vjp = jax.vjp(lambda *a: JFB.fused_rmsnorm_qkv(
        *a, epsilon=1e-5, use_pallas=True, interpret=True),
        *[a for a, _ in arrs])
    refs = vjp(tuple(c for c, _ in cts))
    leaves = [t.clone().requires_grad_(True) for _, t in arrs]
    outs = TF.fused_rmsnorm_qkv(*leaves, epsilon=1e-5)
    torch.autograd.backward(outs, [t for _, t in cts])
    for t, r in zip(leaves, refs):
        _close(t.grad, np.asarray(r), atol=2e-5, rtol=2e-5)


def test_fused_mlp_grads_match_pallas_vjp():
    """Grads through ``FusedMLP`` (kernel pair forward, recompute
    backward) against the JAX custom VJP around the Pallas MLP kernel.
    fp32: 2e-5."""
    rng = np.random.default_rng(11)
    d, f = 128, 256
    arrs = [_both(rng, (2, 16, d)), _both(rng, (d, f), d ** -0.5),
            _both(rng, (d, f), d ** -0.5), _both(rng, (f, d), f ** -0.5)]
    jct, tct = _both(rng, (2, 16, d))
    _, vjp = jax.vjp(lambda *a: JFB.fused_mlp(*a, use_pallas=True,
                                              interpret=True),
                     *[a for a, _ in arrs])
    refs = vjp(jct)
    leaves = [t.clone().requires_grad_(True) for _, t in arrs]
    TF.fused_mlp(*leaves).backward(tct)
    for t, r in zip(leaves, refs):
        _close(t.grad, np.asarray(r), atol=2e-5, rtol=2e-5)


def test_fused_functionals_take_the_forward_only_launch_without_grad():
    """Under ``no_grad`` the functionals call the kernel wrappers
    directly (the forward-only variant), not the custom VJPs."""
    x = torch.randn(4, 64, requires_grad=True)
    w = torch.randn(64, 64, requires_grad=True)
    with torch.no_grad():
        q, _, _ = TF.fused_rmsnorm_qkv(x, torch.ones(64), w, w, w)
        y = TF.fused_mlp(x, w, w, w)
    assert q.grad_fn is None and y.grad_fn is None
    q, _, _ = TF.fused_rmsnorm_qkv(x, torch.ones(64), w, w, w)
    node = q.grad_fn.next_functions[0][0]       # under the reshape's view
    assert type(node).__name__.startswith("FusedRMSNormQKV")
