"""The arithmetic of the Hopper kernels' tiles, on the CPU, against the
JAX package on the same inputs.

The bf16 flash forward (``csrc/flash_attention.cu``, flash_fwd_hopper)
and the bf16 RMSNorm+QKV at T > 16 (``csrc/fused_block.cu``: a row pass,
then a wgmma GEMM) run only on the card.  What they compute is modelled
here blockwise, at the edge shapes their tiles create (a last q or key
tile of 64 rows where tiles are 128, a column part narrower than its
tile), and the model is held against the Pallas kernels in interpret
mode and against the port's plain versions.  Inputs come from numpy with
a fixed seed.  fp32 cases agree within 1e-5 (sums in another order, exp2
in place of exp); bf16 cases within one bf16 step of the output, 2^-7 of
its value (both sides round the same fp32 values to bf16 once, and the P
or xn roundings that another summation order flips move an output by far
less), plus 1e-3 for outputs near 0."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as JFA
from paddle_tpu.ops.pallas import fused_block as JFB

from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import rmsnorm as RN

CSRC = Path(FB.__file__).resolve().parent / "csrc"
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _both(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    t = torch.from_numpy(a).to(dtype)
    return jnp.asarray(t.float().numpy()).astype(JDT[dtype]), t


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, dtype):
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32), atol=atol,
                               rtol=rtol)


# -- flash forward -------------------------------------------------------------

LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def hopper_flash_model(q, k, v, causal, scale, bq=128, bk=64):
    """flash_fwd_hopper's arithmetic, tile by tile: q tiles of `bq` rows
    in the kernel's order (the last, heaviest, first), key blocks of `bk`
    walked up to the diagonal; scores times scale * log2 e; the running
    max m2 and p = exp2(s2 - m2) in fp32, the running sum of fp32 p, P
    cast to v's dtype for the product; out = acc / l cast to q's dtype,
    lse = (m2 + log2 l) ln 2.  Rows and keys past s (a ragged last tile)
    are the kernel's zero-filled rows: keys past s are masked, rows past
    s are not written.  q ``[b, s, h, d]``, k/v ``[b, s, hk, d]``; the
    tests also walk 128-key blocks, where the last one is ragged."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32)
    nq = -(-s // bq)
    for qi in reversed(range(nq)):
        q0 = qi * bq
        rows = torch.arange(q0, q0 + bq)
        nk = -(-s // bk)
        if causal:   # blocks wholly above the diagonal are skipped
            nk = min(nk, -(-(q0 + bq) // bk))
        for bi in range(b):
            for hi in range(h):
                kh = hi // (h // hk)
                qt = torch.zeros((bq, d))
                qt[:min(bq, s - q0)] = q[bi, q0:q0 + bq, hi].float()
                m2 = torch.full((bq,), -torch.inf)
                l = torch.zeros(bq)
                acc = torch.zeros((bq, d))
                for j in range(nk):
                    k0 = j * bk
                    kt = torch.zeros((bk, d))
                    vt = torch.zeros((bk, d))
                    n = min(bk, s - k0)
                    kt[:n] = k[bi, k0:k0 + n, kh].float()
                    vt[:n] = v[bi, k0:k0 + n, kh].float()
                    s2 = (qt @ kt.T) * (scale * LOG2E)
                    keys = torch.arange(k0, k0 + bk)
                    mask = keys[None, :] >= s
                    if causal:
                        mask = mask | (keys[None, :] > rows[:, None])
                    s2 = s2.masked_fill(mask, -torch.inf)
                    mx = torch.maximum(m2, s2.amax(1))
                    base = torch.where(mx == -torch.inf, 0.0, mx)
                    corr = torch.exp2(m2 - base)
                    p = torch.exp2(s2 - base[:, None])
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + \
                        p.to(v.dtype).float() @ vt
                    m2 = mx
                n = min(bq, s - q0)
                safe = torch.where(l > 0, l, 1.0)
                out[bi, q0:q0 + n, hi] = (acc / safe[:, None])[:n] \
                    .to(q.dtype)
                lse[bi, hi, q0:q0 + n] = ((m2 + torch.log2(safe)) * LN2)[:n]
    return out, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hk,bk", [(192, 1, 64), (192, 4, 128),
                                     (320, 1, 128), (320, 4, 64)])
def test_flash_hopper_tiles_match_pallas(dtype, causal, s, hk, bk):
    """s % 128 == 64: the last q tile holds 64 rows (and, with 128-key
    blocks, the last key block).  The blockwise model against
    ``_fwd_pallas`` (interpret mode, its own 64-row blocks) and against
    the port's plain version, out and lse."""
    rng = np.random.default_rng(s + 10 * hk + causal)
    h, d = 4, 128
    jq, tq = _both(rng, (1, s, h, d), dtype)
    jk, tk = _both(rng, (1, s, hk, d), dtype)
    jv, tv = _both(rng, (1, s, hk, d), dtype)
    scale = d ** -0.5
    out, lse = hopper_flash_model(tq, tk, tv, causal, scale, bk=bk)
    ref, ref_lse = JFA._fwd_pallas(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), scale=scale, causal=causal, block_q=64,
        block_k=64, interpret=True)
    _close(out.float(), np.swapaxes(_np(ref), 1, 2), dtype)
    _close(lse, _np(ref_lse), torch.float32)
    plain, plain_lse = FA.flash_attention_fwd(tq, tk, tv, causal)
    _close(out.float(), plain.float(), dtype)
    _close(lse, plain_lse, torch.float32)


# -- flash backward: dq and dk/dv ---------------------------------------------

def _p_exp2(s, lse, scale):
    """P = 2^(S scale log2 e - lse log2 e): the kernels' recompute of the
    softmax from the forward's natural-log lse."""
    return torch.exp2(s * (scale * LOG2E) - lse * LOG2E)


def hopper_flash_bwd_model(q, k, v, dout, lse, delta, causal, scale,
                           rounded=True, bt=128, bb=64):
    """flash_dq_hopper's and flash_dkv_hopper's arithmetic, tile by tile.
    Both cut their tiles of `bt` rows into two consumers of `bb` rows; a
    last tile of 64 rows (s % 128 == 64) has one.  dq: per q tile and
    query head, key blocks of `bb` up to the consumer's diagonal, S and dP
    in fp32, P from the natural lse in the exp2 domain, dS = P (dP -
    delta) scale cast to q's dtype, dQ += dS K in fp32.  dk/dv: per key
    tile and kv head, in transposed score space, every (group head, q
    block) pair in the kernel's order (heads outer, q blocks from the
    first that reaches the tile under the causal mask), P^T and dS^T cast
    to the input dtype, dV += P^T dO and dK += dS^T Q summed in fp32
    inside the tile; q blocks wholly before a consumer's keys skipped.
    Masked scores give P = 0.  With ``rounded=False`` P and dS stay fp32,
    as the Pallas kernels keep them (:277-288).  q/dout ``[b, s, h, d]``,
    k/v ``[b, s, hk, d]``, lse/delta ``[b, h, s]`` fp32."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    rep = h // hk
    dt = q.dtype
    pdt = dt if rounded else torch.float32   # P and dS for the products
    f = {n: t.float() for n, t in (("q", q), ("k", k), ("v", v),
                                   ("g", dout))}
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    nt = -(-s // bt)
    for bi in range(b):
        for t0 in range(0, nt * bt, bt):
            for c0 in range(t0, min(t0 + bt, s), bb):   # active consumers
                rows = torch.arange(c0, c0 + bb)
                # dq of query rows c0.. for each query head
                nk = s // bb
                if causal:
                    nk = min(nk, (c0 + bb) // bb)
                for hi in range(h):
                    kh = hi // rep
                    qc, gc = f["q"][bi, c0:c0 + bb, hi], f["g"][bi, c0:c0 + bb,
                                                             hi]
                    l_, dl = lse[bi, hi, c0:c0 + bb], delta[bi, hi,
                                                           c0:c0 + bb]
                    acc = torch.zeros((bb, d))
                    for k0 in range(0, nk * bb, bb):
                        kt = f["k"][bi, k0:k0 + bb, kh]
                        vt = f["v"][bi, k0:k0 + bb, kh]
                        p = _p_exp2(qc @ kt.T, l_[:, None], scale)
                        if causal:
                            keys = torch.arange(k0, k0 + bb)
                            p = p.masked_fill(keys[None, :] > rows[:, None],
                                              0.0)
                        ds = p * (gc @ vt.T - dl[:, None]) * scale
                        acc = acc + ds.to(pdt).float() @ kt
                    dq[bi, c0:c0 + bb, hi] = acc.to(dt)
                # dk / dv of key rows c0.. for each kv head
                qb0 = (t0 // bb) if causal else 0
                for kh in range(hk):
                    kc, vc = f["k"][bi, c0:c0 + bb, kh], f["v"][bi, c0:c0 + bb,
                                                             kh]
                    ak = torch.zeros((bb, d))
                    av = torch.zeros((bb, d))
                    for hi in range(kh * rep, (kh + 1) * rep):
                        for q0 in range(qb0 * bb, s, bb):
                            if causal and q0 + bb - 1 < c0:
                                continue    # every key after every query
                            qt = f["q"][bi, q0:q0 + bb, hi]
                            gt = f["g"][bi, q0:q0 + bb, hi]
                            pt = _p_exp2(kc @ qt.T,
                                         lse[bi, hi, q0:q0 + bb][None, :],
                                         scale)
                            if causal:
                                qs = torch.arange(q0, q0 + bb)
                                pt = pt.masked_fill(
                                    rows[:, None] > qs[None, :], 0.0)
                            dst = pt * (vc @ gt.T -
                                        delta[bi, hi, q0:q0 + bb][None, :]) \
                                * scale
                            av = av + pt.to(pdt).float() @ gt
                            ak = ak + dst.to(pdt).float() @ qt
                    dk[bi, c0:c0 + bb, kh] = ak.to(dt)
                    dv[bi, c0:c0 + bb, kh] = av.to(dt)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hk", [(192, 1), (192, 4), (320, 1), (320, 4)])
def test_flash_bwd_hopper_tiles_match_pallas(dtype, causal, s, hk):
    """s % 128 == 64: the last q tile and the last key tile hold 64 rows
    (one consumer).  hk = 1 sums a group of 4 heads in one key tile, hk =
    4 is MHA.  The blockwise model of the two backward kernels against
    ``_bwd_pallas`` (interpret mode, its own 64-row blocks, P and dS in
    fp32) and against the port's plain version (P and dS rounded as the
    kernels round them), from the plain forward's out and lse.  Against
    Pallas the model keeps P and dS in fp32 as Pallas does: rounded, as
    the kernels round them, bf16 dv moves by up to six times the limit
    (the rounding choice of ROADMAP.md queue 3, held by the plain
    version)."""
    rng = np.random.default_rng(2 * s + 3 * hk + causal)
    h, d = 4, 128
    jq, tq = _both(rng, (1, s, h, d), dtype)
    jk, tk = _both(rng, (1, s, hk, d), dtype)
    jv, tv = _both(rng, (1, s, hk, d), dtype)
    jg, tg = _both(rng, (1, s, h, d), dtype)
    scale = d ** -0.5
    out, lse = FA.flash_attention_fwd(tq, tk, tv, causal)
    delta = FA.flash_delta(out, tg)
    got = hopper_flash_bwd_model(tq, tk, tv, tg, lse, delta, causal, scale)
    unrounded = hopper_flash_bwd_model(tq, tk, tv, tg, lse, delta, causal,
                                       scale, rounded=False)
    jout = jnp.asarray(out.float().numpy()).astype(JDT[dtype])
    sw = lambda t: jnp.swapaxes(t, 1, 2)
    ref = JFA._bwd_pallas(
        (sw(jq), sw(jk), sw(jv), sw(jout), jnp.asarray(lse.numpy())),
        sw(jg), scale=scale, causal=causal, block_q=64, block_k=64,
        interpret=True)
    plain = FA.flash_bwd_reference(tq, tk, tv, tg, lse, delta, causal)
    for g, u, r, p in zip(got, unrounded, ref, plain):
        assert g.dtype == dtype and tuple(g.shape) == tuple(p.shape)
        _close(u.float(), np.swapaxes(_np(r), 1, 2), dtype)
        _close(g.float(), p.float(), dtype)


# -- RMSNorm + QKV: row pass, then the GEMM over xn ---------------------------

def hopper_qkv_model(x, wn, wq, wk, wv, eps, bn):
    """The bf16 path at T > 16 as two steps: the row pass is the rmsnorm
    kernel's row (``rmsnorm_reference`` without a residual: xn = ((x *
    inv) * wn) cast to x's dtype, inv fp32), then each part of
    [q | k | v] = xn @ [wq | wk | wv] in column tiles of `bn`, a part's
    last tile zero-padded as TMA fills it, fp32 sums cast once."""
    xn, _, inv = RN.rmsnorm_reference(x, wn, None, eps)
    outs = []
    for w in (wq, wk, wv):
        n = w.shape[1]
        wp = torch.zeros((w.shape[0], -(-n // bn) * bn), dtype=w.dtype)
        wp[:, :n] = w
        tiles = [xn.float() @ wp[:, c:c + bn].float()
                 for c in range(0, wp.shape[1], bn)]
        outs.append(torch.cat(tiles, 1)[:, :n].to(x.dtype))
    return (*outs, xn, inv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residuals", [True, False])
@pytest.mark.parametrize("T", [17, 150])
@pytest.mark.parametrize("bn", [128, 256])
def test_qkv_row_pass_then_gemm_matches_pallas(dtype, residuals, T, bn):
    """dq = 192, dkv = 64: each part's last column tile is partial in both
    tile widths the GEMM uses.  The decomposition against ``_qkv_pallas``
    (interpret mode, the fused form, forward and training variants) and
    against the port's plain version."""
    rng = np.random.default_rng(T + bn + residuals)
    d, dq, dkv, eps = 128, 192, 64, 1e-5
    jx, tx = _both(rng, (T, d), dtype)
    jn, tn = _both(rng, (d,), dtype, 0.5)
    jq, tq = _both(rng, (d, dq), dtype, d ** -0.5)
    jk, tk = _both(rng, (d, dkv), dtype, d ** -0.5)
    jv, tv = _both(rng, (d, dkv), dtype, d ** -0.5)
    got = hopper_qkv_model(tx, tn, tq, tk, tv, eps, bn)
    ref = JFB._qkv_pallas(jx, jn, jq, jk, jv, eps=eps, block_t=T,
                          block_o=64, interpret=True, residuals=residuals)
    plain = FB.fused_rmsnorm_qkv(tx, tn, tq, tk, tv, eps,
                                 residuals=residuals)
    assert len(ref) == len(plain) == (5 if residuals else 3)
    for g, r, p in zip(got, ref, plain):
        assert tuple(g.shape) == r.shape == tuple(p.shape)
        _close(g.float(), _np(r), dtype if g.dtype != torch.float32
               else torch.float32)
        _close(g.float(), p.float(), dtype if g.dtype != torch.float32
               else torch.float32)


def test_row_pass_threshold_agrees_with_the_kernel_source():
    """The wrapper allocates the forward variant's xn workspace by the
    rule the C entry routes by (kRowPassMinT in csrc/fused_block.cu)."""
    src = (CSRC / "fused_block.cu").read_text()
    m = re.search(r"constexpr int kRowPassMinT = (\d+);", src)
    assert m and int(m.group(1)) == FB.ROW_PASS_MIN_T


def test_ptxas_report_reads_registers_spills_and_serialisation():
    """_build.parse_ptxas on a -Xptxas -v log: each matching kernel by its
    mangled name, with its registers, shared memory, spills and the
    performance notes; other kernels left out."""
    log = """\
ptxas info    : Compiling entry function '_ZN3hop16flash_fwd_hopperENS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN3hop16flash_fwd_hopperENS_6ParamsE
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 128 bytes smem, 1000 bytes cmem[0]
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to the presence of Extern calls
ptxas info    : Compiling entry function '_Z15flash_dq_kernelv' for 'sm_90a'
ptxas info    : Used 128 registers, 0 bytes smem
"""
    rep = _build.parse_ptxas(log, ("flash_fwd_hopper", "qkv_gemm_kernel"),
                             "flash_attention.cu", {})
    assert list(rep) == ["_ZN3hop16flash_fwd_hopperENS_6ParamsE"]
    r = rep["_ZN3hop16flash_fwd_hopperENS_6ParamsE"]
    assert (r["kernel"], r["registers"], r["smem_static"], r["stack_bytes"],
            r["spill_stores"], r["spill_loads"]) == (
                "flash_fwd_hopper", 168, 128, 8, 4, 12)
    assert len(r["notes"]) == 1 and "serialized" in r["notes"][0]
