"""The fp32 flash forward on 3xTF32 wgmma (``csrc/flash_tf32x3.cuh``), on
the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py -k
'fp32_tf32x3 or fp32_ernie or fp32_head_dim_64'``).  Here a model of its
arithmetic — ``cvt.rna`` by bit operations, the split of q, k and v^T,
the three products of each k8 step small terms first, each 32-deep
slice summed from zero and added to the fp32 totals, the online softmax
per key block in the exp2 domain, P split after it, the permutation of
P's and v^T's key columns, and the 64-row consumers of a 128-row tile
(one in a last tile of 64 rows) — is held against the JAX package's
``_fwd_pallas`` (interpret mode) and against float64; the key
permutation against the fragment layouts; the shared memory, the
instantiations and the workspace against the kernel source; and
``scaled_dot_product_attention``'s route by head_dim and dtype.  Inputs
come from numpy with fixed seeds."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA

from paddle_tpu_torch.nn.functional import attention as ATT
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_block as FB

CSRC = Path(FA.__file__).resolve().parent / "csrc"
# (atol, rtol) of the model against _fwd_pallas in fp32: the sums' order,
# the split's residual (2^-22 of each operand), exp2 in place of exp
TOL = (2e-5, 2e-5)
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
MAX_SMEM = 232448               # the shared memory a block may use
UNIT = 32768                    # a ring unit (flash_tf32x3.cuh)
# pi: the key each logical column c of a group of 8 holds in v^T
PI = (0, 2, 4, 6, 1, 3, 5, 7)


def _src(name):
    return (CSRC / name).read_text()


def tf32_round(x):
    """fp32 `x` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: half
    an ulp of the 10-bit mantissa (bit 12) added to the magnitude's
    bits, then the 13 low bits cleared (ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32).reshape(x.shape)


def split(x):
    """``(hi, lo)``: hi = tf32(x), lo = tf32(x - hi) (``tf32_split``)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def plan(hd):
    """``fwd32::Plan<HD>``: keys a block, S's slices over d, P V's over
    keys, the ring's units, the dynamic shared memory."""
    bk = 64 if hd == 64 else 32
    qhalf = (hd // 32) * 128 * 128
    nu = (MAX_SMEM - 2048 - 2 * qhalf) // UNIT
    return {"BK": bk, "SD": hd // 32, "SK": bk // 32, "NU": nu,
            "SMEM": 1024 + 2 * qhalf + nu * UNIT}


def permute_keys(x):
    """x's last dimension (keys, a multiple of 8) in v^T's order: logical
    column 8 g + c holds key 8 g + pi(c)."""
    idx = torch.tensor([8 * g + PI[c] for g in range(x.shape[-1] // 8)
                        for c in range(8)])
    return x[..., idx]


def slices(ah, al, bh, bl):
    """Sum over the last dim of A [..., m, K] and B [..., n, K] (both
    split, K a multiple of 32) as the kernel sums it: each 32-deep slice
    from zero, a k8 step at a time ``part += a_lo b_hi``, ``+= a_hi
    b_lo``, ``+= a_hi b_hi`` (fp32; each product of TF32 values exact),
    the slices' sums added to the total in order."""
    tot = None
    for k0 in range(0, ah.shape[-1], 32):
        part = None
        for k in range(k0, k0 + 32, 8):
            s = slice(k, k + 8)
            for a, b in ((al, bh), (ah, bl), (ah, bh)):
                t = a[..., s] @ b[..., s].transpose(-1, -2)
                part = t if part is None else part + t
        tot = part if tot is None else tot + part
    return tot


def flash_tf32x3_model(q, k, v, causal, scale=None):
    """``(out, lse)`` of the kernel's arithmetic.  q ``[b, s, h, d]``,
    k / v ``[b, s, hk, d]`` fp32, s a multiple of 64.  The pre-pass
    splits q and k, and v^T with its keys permuted; a 128-row tile runs
    two consumers of 64 rows (a last tile of 64 rows one), each walking
    its key blocks of BK up to its diagonal: S by :func:`slices`, scores
    times fp32 scale * log2 e, the running max and sum, corr = 2^(m_old -
    m_new) on O and l, P = 2^(s2 - m) split into hi and lo, its key
    columns read in v^T's order (the fragment's (t, t + 4) is the
    accumulator's (2t, 2t + 1)), O = O corr + each P V slice; out = O /
    l, lse = (m + log2 l) ln 2."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    bk = plan(d)["BK"]
    scale = scale if scale is not None else d ** -0.5
    scale2 = torch.tensor(scale, dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    kh_of = torch.arange(h) // (h // hk)
    qh, ql = (t.permute(0, 2, 1, 3) for t in split(q))          # b h s d
    kh, kl = (t.permute(0, 2, 1, 3)[:, kh_of] for t in split(k))
    vt = permute_keys(v.float().permute(0, 2, 3, 1))[:, kh_of]   # b h d s
    vth, vtl = split(vt)
    out = torch.empty((b, h, s, d), dtype=torch.float32)
    lse = torch.empty((b, h, s), dtype=torch.float32)
    for r0 in range(0, s, 64):           # a consumer's 64 rows
        rows = torch.arange(r0, r0 + 64)
        nkc = min(s, r0 + 64) // bk if causal else s // bk
        m = torch.full((b, h, 64), -torch.inf)
        l = torch.zeros((b, h, 64))
        o = torch.zeros((b, h, 64, d))
        for j in range(nkc):
            ks = slice(j * bk, j * bk + bk)
            sc = slices(qh[:, :, r0:r0 + 64], ql[:, :, r0:r0 + 64],
                        kh[:, :, ks], kl[:, :, ks])
            s2 = sc * scale2
            if causal:
                keys = torch.arange(j * bk, j * bk + bk)
                s2 = s2.masked_fill(keys[None, :] > rows[:, None],
                                    -torch.inf)
            mx = torch.maximum(m, s2.amax(-1))
            base = torch.where(mx == -torch.inf, 0.0, mx)
            corr = torch.exp2(m - base)
            p = torch.exp2(s2 - base[..., None])
            l = l * corr + p.sum(-1)
            m = mx
            ph, pl = split(permute_keys(p))
            o = o * corr[..., None]
            for k0 in range(0, bk, 32):     # P V's slices, one sum each
                ss, vs = slice(k0, k0 + 32), slice(j * bk + k0,
                                                   j * bk + k0 + 32)
                o = o + slices(ph[..., ss], pl[..., ss], vth[..., vs],
                               vtl[..., vs])
        safe = torch.where(l > 0, l, 1.0)
        out[:, :, r0:r0 + 64] = o / safe[..., None]
        lse[:, :, r0:r0 + 64] = (m + torch.log2(safe)) * LN2
    return out.permute(0, 2, 1, 3), lse


def _inputs(rng, b, s, h, hk, d):
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
    return t(b, s, h, d), t(b, s, hk, d), t(b, s, hk, d)


def _f64(q, k, v, causal, scale):
    b, s, h, d = q.shape
    hk = k.shape[2]
    qd = q.double().reshape(b, s, hk, h // hk, d)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qd, k.double()) * scale
    if causal:
        sc = sc.masked_fill(~torch.ones((s, s), dtype=torch.bool).tril(),
                            -torch.inf)
    lse = torch.logsumexp(sc, -1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", torch.exp(sc - lse[..., None]),
                       v.double())
    return out.reshape(b, s, h, d), lse.reshape(b, h, s)


# -- the model against JAX and float64 ----------------------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h,hk", [(192, 4, 1), (320, 4, 4)])
def test_model_matches_pallas(d, causal, s, h, hk):
    """s % 128 == 64 (a last tile of 64 rows, one consumer), GQA and MHA:
    the model against ``_fwd_pallas`` in interpret mode (its own 64-row
    blocks, fp32 dots), out and lse within TOL, and against the port's
    plain version."""
    rng = np.random.default_rng(s + d + 10 * hk + causal)
    q, k, v = _inputs(rng, 1, s, h, hk, d)
    scale = d ** -0.5
    out, lse = flash_tf32x3_model(q, k, v, causal, scale)
    jq, jk, jv = (jnp.swapaxes(jnp.asarray(t.numpy()), 1, 2)
                  for t in (q, k, v))
    ref, ref_lse = JFA._fwd_pallas(jq, jk, jv, scale=scale, causal=causal,
                                   block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(out.numpy(),
                               np.swapaxes(np.asarray(ref), 1, 2),
                               atol=TOL[0], rtol=TOL[1])
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               atol=TOL[0], rtol=TOL[1])
    plain, plain_lse = FA.flash_attention_fwd(q, k, v, causal, scale)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=TOL[0],
                               rtol=TOL[1])
    np.testing.assert_allclose(lse.numpy(), plain_lse.numpy(), atol=TOL[0],
                               rtol=TOL[1])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_model_within_the_factor_of_float64(d, causal, scale):
    """Against the same attention in float64 the model errs at most
    ``TF32X3_F64_FACTOR`` times the plain fp32 version's own error, out
    and lse; one TF32 pass (both operands of every product rounded once)
    errs far more, which is why the kernel takes three."""
    rng = np.random.default_rng(7 * d + causal + (scale is not None))
    q, k, v = _inputs(rng, 2, 256, 4, 2, d)
    sc = scale if scale is not None else d ** -0.5
    o64, l64 = _f64(q, k, v, causal, sc)
    out, lse = flash_tf32x3_model(q, k, v, causal, scale)
    plain, plain_lse = FA.flash_fwd_reference(q, k, v, causal, scale)
    for got, ref, r64 in ((out, plain, o64), (lse, plain_lse, l64)):
        e = float((got.double() - r64).abs().max())
        e32 = float((ref.double() - r64).abs().max())
        assert e <= FB.TF32X3_F64_FACTOR * e32, (e, e32)
    one = FA.flash_fwd_reference(tf32_round(q), tf32_round(k),
                                 tf32_round(v), causal, scale)[0]
    assert float((one.double() - o64).abs().max()) > \
        FB.TF32X3_F64_FACTOR * float((plain.double() - o64).abs().max())


def test_split_is_exact_to_two_pieces():
    """hi + lo recovers x to 2^-22 of |x|; both halves are TF32 values
    (13 low bits zero); ties round away from zero."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = split(x)
    for t in (hi, lo):
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    assert bool(((hi + lo - x).abs() <= x.abs() * 2 ** -22).all())
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)], dtype=torch.float32)
    assert tf32_round(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


# -- the key permutation ------------------------------------------------------

def test_fragment_pairs_are_the_accumulator_pairs():
    """Thread t's accumulator holds key columns (2t, 2t + 1) of an n8
    block; its tf32 A fragment columns (t, t + 4).  Under pi they are
    the same keys, so P goes from the S registers to wgmma's A with no
    shuffle; and P V over the permuted columns is P V."""
    for t in range(4):
        assert (PI[t], PI[t + 4]) == (2 * t, 2 * t + 1)
    assert sorted(PI) == list(range(8))
    rng = np.random.default_rng(8)
    p = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float64))
    vt = torch.from_numpy(rng.standard_normal((32, 64)).astype(np.float64))
    torch.testing.assert_close(permute_keys(p) @ permute_keys(vt).T,
                               p @ vt.T, rtol=1e-12, atol=1e-12)


def test_pre_pass_permutes_v_transposed_as_the_model():
    """flash_split_vt_kernel's thread (d row r, logical columns 4 q ..
    4 q + 3) reads keys kb + 2 e, kb = 8 (q / 2) + q % 2: pi of each
    column; the source's lines say so."""
    for q in range(8):
        kb = 8 * (q // 2) + q % 2
        for e in range(4):
            c = 4 * q + e
            assert kb + 2 * e == 8 * (c // 8) + PI[c % 8]
    src = _src("flash_tf32x3.cuh")
    assert "const int kb = 8 * (q / 2) + q % 2;" in src
    assert "tf32_split(t[kb + 6][r], h.w, l.w);" in src
    frags = src[src.index("__device__ __forceinline__ void p_frags("):]
    assert "const float v[4] = {sc[n], sc[n + 2], sc[n + 1], sc[n + 3]};" \
        in frags


# -- the kernel source ---------------------------------------------------------

@pytest.mark.parametrize("hd", [64, 128])
def test_ring_fits_shared_memory(hd):
    """Plan<HD>: a unit (one key block's K or v^T, hi and lo) is 32 KB at
    both head dims (64 keys at 64, 32 at 128); Q's halves and five or
    three units fill 225 KB, within 227 KB with the barriers; every box
    starts on a 1024-byte boundary."""
    p = plan(hd)
    assert (p["BK"], p["NU"]) == ((64, 5) if hd == 64 else (32, 3))
    assert p["SD"] * p["BK"] * 128 == UNIT // 2
    assert p["SK"] * hd * 128 == UNIT // 2
    assert p["SMEM"] == 230400
    barriers = 8 * (1 + 2 * p["NU"])
    assert p["SMEM"] + barriers <= MAX_SMEM
    assert (128 * 128) % 1024 == 0 and (p["BK"] * 128) % 1024 == 0
    src = _src("flash_tf32x3.cuh")
    assert "constexpr uint32_t UNIT = 32768;" in src
    assert "static constexpr int BK = HD == 64 ? 64 : 32;" in src
    assert ("static constexpr int NU = (232448 - 2048 - 2 * QHALF) / UNIT;"
            in src)


def test_instantiations_and_dispatch_agree_with_the_wrappers():
    """fp32 at head_dim 64 and 128 (the 3xTF32 forward, the first-design
    dq and dk/dv), bf16 and fp16 at 128 only; the first design's forward
    is gone;
    the three products of each k8 step small terms first, the slices in
    one group, summed after the wait."""
    src = _src("flash_attention.cu")
    assert "flash_fwd_kernel" not in src
    assert "if (dtype == ptt::DT_BFLOAT16 && D == 128) {" in src
    assert "if (dtype == ptt::DT_FLOAT16 && D == 128) {" in src
    assert "if (dtype == ptt::DT_FLOAT32 && (D == 64 || D == 128)) {" in src
    assert "launch<float, 64, W>(a, B, s)" in src
    assert "launch<float, 128, W>(a, B, s)" in src
    hdr = _src("flash_tf32x3.cuh")
    assert "D == 64 ? launch<64>(a, B, work, stream)" in hdr
    assert ": launch<128>(a, B, work, stream);" in hdr
    assert re.search(r"constexpr int HD = 128;", _src("flash_hopper.cuh"))
    assert FA.KERNEL_HEAD_DIMS == {torch.float32: (64, 128),
                                   torch.bfloat16: (128,),
                                   torch.float16: (128,)}
    assert FA.KERNEL_HEAD_DIM == 128
    body = hdr[hdr.index("__device__ __forceinline__ void consume("):]
    assert [ln.strip() for ln in body.splitlines()
            if ln.strip().startswith("wgmma_tf32")] == [
        "wgmma_tf32<BK>(sl[s], dql, dkh, kk > 0);",
        "wgmma_tf32<BK>(sl[s], dqh, dkl);",
        "wgmma_tf32<BK>(sl[s], dqh, dkh);",
        "wgmma_tf32_rs<HD>(ol[s], pl[s][kk], dvh, kk > 0);",
        "wgmma_tf32_rs<HD>(ol[s], ph[s][kk], dvl);",
        "wgmma_tf32_rs<HD>(ol[s], ph[s][kk], dvh);"]
    assert body.index("wgmma_wait<0>();") < \
        body.index("sl[0][i] += sl[s][i];")
    assert body.rindex("wgmma_wait<0>();") < body.index("o[i] += ol[s][i];")


def test_workspace_agrees_with_the_kernel_source():
    """The wrapper allocates q's and k's hi and lo and v^T's for each fp32
    call: 2 b s d (h + 2 hk) values, 151 MB at ERNIE's shape."""
    assert "return 2LL * B * S * D * (H + 2LL * HK);" in \
        _src("flash_tf32x3.cuh")
    assert FA.flash_fp32_floats(8, 1024, 12, 12, 64) * 4 == 150994944
    assert FA.flash_fp32_floats(1, 64, 4, 1, 128) == 2 * 64 * 128 * 6
    wrapper = Path(FA.__file__).read_text()
    assert "floats = flash_fp32_floats(b, s, h, hk, d) \\" in wrapper
    assert "work = torch.empty(floats, dtype=torch.float32" in wrapper


# -- the route -------------------------------------------------------------------

@pytest.mark.parametrize("dtype,hd,want", [
    (torch.float32, 64, 64), (torch.bfloat16, 64, 128),
    (torch.float32, 32, 128), (torch.float32, 128, 128)])
def test_sdpa_routes_by_dtype_and_head_dim(monkeypatch, dtype, hd, want):
    """On an eligible shape (seq >= 1024, seq % 128 == 0, no mask, no
    dropout) fp32 at head_dim 64 reaches the flash kernel as it is; bf16
    at 64 and any dtype at 32 through the pad to 128; the output is the
    kernel's, sliced back; below seq 1024 only head_dim 128 goes.  (The
    card's eligibility rule is taken without its device test here: on
    the CPU every call is plain.)"""
    seen = []

    def kernel(q, k, v, causal=False, scale=None):
        seen.append((tuple(q.shape), scale))
        return q
    monkeypatch.setattr(ATT, "_flash_eligible", lambda q, hd: (
        hd % 128 == 0 and q.shape[1] >= 128 and q.shape[1] % 128 == 0))
    monkeypatch.setattr(ATT, "_flash_kernel", kernel)
    q = torch.ones((1, 1024, 2, hd), dtype=dtype)
    out = ATT.scaled_dot_product_attention(q, q, q)
    assert seen[0][0] == (1, 1024, 2, want) and out.shape == q.shape
    assert seen[0][1] == (None if want == hd else hd ** -0.5)
    seen.clear()
    ATT.scaled_dot_product_attention(q[:, :512], q[:, :512], q[:, :512])
    assert [s[0][-1] for s in seen] == ([] if hd in (32, 64) else [hd])


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper returns the plain version exactly at head_dim
    64 and counts no launch."""
    rng = np.random.default_rng(1)
    q, k, v = _inputs(rng, 1, 128, 2, 1, 64)
    n = FA.flash_attention_fwd.launches
    for g, r in zip(FA.flash_attention_fwd(q, k, v, True),
                    FA.flash_fwd_reference(q, k, v, True)):
        assert torch.equal(g, r)
    assert FA.flash_attention_fwd.launches == n
