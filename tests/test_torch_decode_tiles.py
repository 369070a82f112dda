"""The arithmetic of the split paged decode, of QKV's split-K at decode
rows and of the chunked cross-entropy's matmul precision, on the CPU,
against the JAX package on the same inputs.

The kernels run only on the card: the paged decode split across the
sequence (``csrc/paged_attention.cu``, paged_split_kernel: fp and int8
pools) and RMSNorm+QKV split-K (``csrc/fused_block.cu``,
qkv_splitk_kernel: bf16, T <= 16).  What they compute is modelled here
blockwise, at the edge shapes their splits create (lengths one token
either side of a split, a row of one token, an inactive row, a permuted
block table; a K of one 64-deep slice, a part whose last column tile is
partial), and held against the Pallas kernels in interpret mode and
against the port's plain versions.  The split rules and the constants
are read from the sources.  Inputs come from numpy with a fixed seed.
fp32 cases agree within 1e-5 (sums in another order); bf16 cases within
one bf16 step of the output, 2^-7 of its value (both sides round the same
fp32 values once; a probability or an xn element that another order
rounds to the other side of a bf16 step moves an output by far less),
plus an absolute floor for outputs near 0 (paged: chip_smoke.py's
PAGED_TOL floor, 4e-3, since each p is rounded against its split's
running max, not the row's)."""

import importlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused_block as JFB
from paddle_tpu.ops.pallas import paged_attention as JPA

from paddle_tpu_torch import flags
from paddle_tpu_torch.inference.kv_cache import _quantize_kv
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.ops.kernels import splitk as SK

CSRC = Path(PA.__file__).resolve().parent / "csrc"
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
QKV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}
PAGED_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (4e-3, 2 ** -7)}


def _t(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        JDT.get(t.dtype, jnp.float32))


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32),
                               atol=tol[0], rtol=tol[1])


# -- paged decode split across the sequence ----------------------------------

def paged_split_model(q, kp, vp, bt, lengths, scale=None, k_scale=None,
                      v_scale=None):
    """paged_split_kernel's arithmetic.  Split s of a row takes tokens
    ``[s * ST, (s + 1) * ST)`` (ST: ``SPLIT_TOKENS`` rounded down to
    whole blocks), the splits counted from the table's width alone; a
    split at or past the row's length does nothing.  A split's fp32
    scores, its max m, p = exp(s - m) rounded to q's dtype for the
    product, its sum l of the unrounded p and its fp32 sum of p V; a row
    of one split is that sum over l, else the partials merge in split
    order: sum e^(m_s - M) acc_s / sum e^(m_s - M) l_s.  Int8 pools
    dequantize each element to q's dtype first.  Returns the output and
    each row's live split count."""
    B, h, hd = q.shape
    _, bs, kvh, _ = kp.shape
    mb = bt.shape[1]
    G = h // kvh
    scale = scale if scale is not None else hd ** -0.5
    per = 1 if bs >= PA.SPLIT_TOKENS else PA.SPLIT_TOKENS // bs
    st = per * bs
    splits = PA.paged_splits(mb, bs)
    out = torch.zeros((B, h, hd))
    lives = []
    for b in range(B):
        n = min(max(int(lengths[b]), 0), mb * bs)
        live = max(1, -(-n // st))
        assert live <= splits
        lives.append(live)
        blocks = bt[b].long()
        for kh in range(kvh):
            qg = q[b, kh * G:(kh + 1) * G].float()               # [G, hd]
            parts = []
            for s in range(live):
                tok = torch.arange(s * st, min((s + 1) * st, n))
                blk, slot = blocks[tok // bs], tok % bs
                k, v = kp[blk, slot, kh], vp[blk, slot, kh]
                if k_scale is not None:
                    k = (k.float() * k_scale[blk, slot, kh][:, None]).to(
                        q.dtype)
                    v = (v.float() * v_scale[blk, slot, kh][:, None]).to(
                        q.dtype)
                sc = qg @ k.float().t() * scale                  # [G, n_s]
                m = sc.max(dim=1).values if len(tok) else \
                    torch.full((G,), -1e30)
                p = torch.exp(sc - m[:, None])
                parts.append((m, p.sum(dim=1),
                              p.to(q.dtype).float() @ v.float()))
            if live == 1:
                m, l, acc = parts[0]
                o = acc / torch.clamp(l, min=1e-30)[:, None]
            else:
                mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
                num = torch.zeros((G, hd))
                den = torch.zeros((G,))
                for m, l, acc in parts:
                    w = torch.exp(m - mx)
                    num = num + w[:, None] * acc
                    den = den + w * l
                o = num / torch.clamp(den, min=1e-30)[:, None]
            out[b, kh * G:(kh + 1) * G] = o
    return out.to(q.dtype), lives


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd", [(1, 64), (8, 256)])
def test_paged_split_model_matches_the_plain_version(quant, dtype, G, hd):
    """Blocks of 16 (128-token splits), a table of 20 blocks (3 splits):
    lengths 1, one block, a split less one, a split, a split plus one,
    the whole table, and an inactive row (table row 0, length 1); the
    block table a permutation of the pool.  The model against
    ``paged_decode_reference``, with the live split count of each row."""
    rng = np.random.default_rng(G + hd + quant)
    bs, mb, kvh = 16, 20, 2
    lengths = [1, bs, 127, 128, 129, mb * bs, 1]
    B, nb = len(lengths), 1 + len(lengths) * mb
    q = _t(rng, (B, G * kvh, hd), dtype)
    kp = _t(rng, (nb, bs, kvh, hd), dtype)
    vp = _t(rng, (nb, bs, kvh, hd), dtype)
    ks = vs = None
    if quant:
        kp, ks = _quantize_kv(kp)
        vp, vs = _quantize_kv(vp)
    bt = torch.from_numpy(rng.permutation(nb - 1)[:B * mb].reshape(B, mb)
                          .astype(np.int32) + 1)
    bt[-1] = 0                    # inactive: scratch block 0, length 1
    ln = torch.tensor(lengths, dtype=torch.int32)
    got, lives = paged_split_model(q, kp, vp, bt, ln, k_scale=ks,
                                   v_scale=vs)
    assert PA.paged_splits(mb, bs) == 3
    assert lives == [1, 1, 1, 1, 2, 3, 1]
    ref = PA.paged_decode_reference(q, kp, vp, bt, ln, k_scale=ks,
                                    v_scale=vs)
    _close(got.float(), ref.float(), PAGED_TOL[dtype])


@pytest.mark.parametrize("quant", [False, True])
def test_paged_split_model_matches_pallas(quant):
    """fp32, 4 query heads per kv head, blocks of 32 (4 a split), a
    table of 10 blocks (3 splits), lengths across the split edges: the
    model against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(40 + quant)
    B, h, kvh, hd, bs, mb = 4, 8, 2, 32, 32, 10
    nb = 1 + B * mb
    q = _t(rng, (B, h, hd), torch.float32)
    kp = _t(rng, (nb, bs, kvh, hd), torch.float32)
    vp = _t(rng, (nb, bs, kvh, hd), torch.float32)
    ks = vs = None
    if quant:
        kp, ks = _quantize_kv(kp)
        vp, vs = _quantize_kv(vp)
    bt = torch.from_numpy(rng.permutation(nb - 1).reshape(B, mb)
                          .astype(np.int32) + 1)
    ln = torch.tensor([1, 128, 129, 320], dtype=torch.int32)
    got, lives = paged_split_model(q, kp, vp, bt, ln, k_scale=ks,
                                   v_scale=vs)
    assert lives == [1, 1, 2, 3]
    ref = JPA.paged_decode_attention(
        _j(q), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        jnp.asarray(bt.numpy()), jnp.asarray(ln.numpy()), interpret=True,
        k_scale=None if ks is None else jnp.asarray(ks.numpy()),
        v_scale=None if vs is None else jnp.asarray(vs.numpy()))
    _close(got, np.asarray(ref), PAGED_TOL[torch.float32])


def test_paged_splits_come_from_the_table_width_alone():
    """The split count is a function of the table's width and the block
    size, nothing else (the lengths stay on the device): 8 splits of 128
    tokens at the serving shape (64 blocks of 16), which gives B = 8 x
    kv_heads = 8 x 8 = 512 blocks, at least twice the H100's 132 SMs; a
    block of 128 tokens or more is a split of its own."""
    assert list(inspect.signature(PA.paged_splits).parameters) == [
        "max_blocks", "block_size"]
    assert PA.paged_splits(64, 16) == 8
    assert 8 * 8 * PA.paged_splits(64, 16) >= 2 * 132
    assert [PA.paged_splits(mb, 16) for mb in (1, 8, 9, 16, 17)] == \
        [1, 1, 2, 2, 3]
    assert [PA.paged_splits(12, bs) for bs in (4, 12, 128, 256)] == \
        [1, 2, 12, 12]


def test_paged_split_rule_agrees_with_the_kernel_source():
    """The wrapper's constants and design names are the source's, and the
    source's split rule, evaluated with C's integer division, gives
    ``paged_splits`` at every size tried."""
    src = (CSRC / "paged_attention.cu").read_text()
    assert int(re.search(r"constexpr int kSplitTokens = (\d+);",
                         src).group(1)) == PA.SPLIT_TOKENS
    enum = re.search(r"enum PagedDesign \{([^}]*)\}", src).group(1)
    names = dict(re.findall(r"PAGED_(\w+) = (\d+)", enum))
    assert {n.lower(): int(v) for n, v in names.items()} == \
        {p: i for i, p in enumerate(PA.PAGED_PATHS)}
    blocks = re.search(r"int split_blocks\(int bs\) \{\s*return ([^;]*);",
                       src).group(1)
    assert blocks == "bs >= kSplitTokens ? 1 : kSplitTokens / bs"
    for mb in (1, 7, 64, 1000):
        for bs in (1, 4, 12, 16, 127, 128, 256):
            cb = 1 if bs >= PA.SPLIT_TOKENS else PA.SPLIT_TOKENS // bs
            assert -(-mb // cb) == PA.paged_splits(mb, bs)
    assert "return (mb + cb - 1) / cb;" in src


# -- RMSNorm+QKV split-K at decode rows ---------------------------------------

def splitk_ranges(K, splits):
    """The kernels' K partition: split j takes the 64-deep slices
    ``j * n // splits`` to ``(j + 1) * n // splits`` of ``n = K // 64``."""
    n = K // 64
    return [(j * n // splits, (j + 1) * n // splits) for j in range(splits)]


def qkv_splitk_model(x, wn, wq, wk, wv, splits, eps=1e-5):
    """The row pass and qkv_splitk_kernel's arithmetic: the inverse RMS
    of each row in fp32, xn = ((x * inv) * wn) cast to x's dtype; over
    ``qkv_column_tiles``, split j of ``splitk_ranges`` sums its slices,
    warp w (0..3) taking k16 step w of every slice and the block adding
    its warps in order; the splits' partials added in split order and one
    cast.  Returns q, k, v and the slices each column tile took."""
    T, d = x.shape
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(dim=1, keepdim=True) + eps)
    xn = ((xf * inv) * wn.float()).to(x.dtype).float()
    ws = (wq, wk, wv)
    outs = [torch.zeros((T, w.shape[1])) for w in ws]
    taken = []
    for part, c0, width in FB.qkv_column_tiles(wq.shape[1], wk.shape[1]):
        wf = ws[part][:, c0:c0 + width].float()
        total, took = None, []
        for lo, hi in splitk_ranges(d, splits):
            took += list(range(lo, hi))
            warps = []
            for w in range(4):
                acc = torch.zeros((T, width))
                for sl in range(lo, hi):
                    k = 64 * sl + 16 * w
                    acc = acc + xn[:, k:k + 16] @ wf[k:k + 16]
                warps.append(acc)
            p = ((warps[0] + warps[1]) + warps[2]) + warps[3]
            total = p if total is None else total + p
        outs[part][:, c0:c0 + width] = total
        taken.append(took)
    return tuple(o.to(x.dtype) for o in outs), taken


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [8, 16])
@pytest.mark.parametrize("d,splits", [(64, 1), (256, 3)])
def test_qkv_splitk_model_matches_pallas(dtype, T, d, splits):
    """d = 64 is one slice; d = 256 takes 3 splits of its 4 slices (one
    split of two).  q 256 wide (two tiles), k and v 128 (one each): the
    model against ``_qkv_kernel`` in interpret mode and the port's plain
    version."""
    rng = np.random.default_rng(T + d + splits)
    dq, dkv = 256, 128
    x = _t(rng, (T, d), dtype)
    wn = _t(rng, (d,), dtype, 0.1) + 1
    w = [_t(rng, (d, n), dtype, d ** -0.5) for n in (dq, dkv, dkv)]
    got, taken = qkv_splitk_model(x, wn, *w, splits)
    assert all(t == list(range(d // 64)) for t in taken)
    ref = JFB.fused_rmsnorm_qkv(_j(x), _j(wn), *(_j(t) for t in w),
                                epsilon=1e-5, block_t=T, block_o=128,
                                use_pallas=True, interpret=True)
    plain = FB.qkv_reference(x, wn, *w, 1e-5)
    for g, r, p in zip(got, ref, plain):
        _close(g.float(), np.asarray(jnp.asarray(r).astype(jnp.float32)),
               QKV_TOL[dtype])
        _close(g.float(), p.float(), QKV_TOL[dtype])


def test_qkv_splitk_model_with_partial_tiles():
    """q 192 and k / v 64 wide: every part's last tile is partial, and
    no tile reaches into the next part; the model against the plain
    version in bf16 at T = 1."""
    rng = np.random.default_rng(3)
    x = _t(rng, (1, 128), torch.bfloat16)
    wn = _t(rng, (128,), torch.bfloat16, 0.1) + 1
    w = [_t(rng, (128, n), torch.bfloat16, 128 ** -0.5) for n in (192, 64,
                                                                   64)]
    assert FB.qkv_column_tiles(192, 64) == [(0, 0, 128), (0, 128, 64),
                                            (1, 0, 64), (2, 0, 64)]
    got, _ = qkv_splitk_model(x, wn, *w, 2)
    for g, p in zip(got, FB.qkv_reference(x, wn, *w, 1e-5)):
        _close(g.float(), p.float(), QKV_TOL[torch.bfloat16])


def test_qkv_splitk_partition_covers_d_and_keeps_tiles_in_their_part():
    """For every split count the rule chooses (d up to 14336, dq / dkv
    from 64 to Llama-3-8B's and a width off the 128 grid, 1 to 132 SMs),
    the splits cover the 64-deep slices exactly once, in order, none
    empty; the column tiles cover q, k and v exactly once, each inside
    its part; the rule gives the Llama-3-8B decode launch 48 tiles x 11
    splits on 132 SMs, four blocks a SM."""
    seen = set()
    for d in (64, 128, 256, 4096, 14336):
        for dq, dkv in ((64, 64), (192, 64), (4096, 1024), (4160, 1088)):
            tiles = FB.qkv_column_tiles(dq, dkv)
            for part, n in enumerate((dq, dkv, dkv)):
                cols = [c for p, c0, w in tiles if p == part
                        for c in range(c0, c0 + w)]
                assert cols == list(range(n))
            assert all(0 < w <= SK.SPLITK_BN for _, _, w in tiles)
            for sms in (1, 16, 132):
                s = FB.qkv_splits(d, dq, dkv, sms)
                seen.add(s)
                r = splitk_ranges(d, s)
                assert [lo for lo, _ in r] == [0] + [hi for _, hi in r[:-1]]
                assert r[-1][1] == d // 64
                assert min(hi - lo for lo, hi in r) >= 1
    assert len(seen) > 4
    assert len(FB.qkv_column_tiles(4096, 1024)) == 48
    assert FB.qkv_splits(4096, 4096, 1024, 132) == 11


def test_qkv_splitk_agrees_with_the_kernel_source():
    """The wrapper's threshold, tile width and tile count are the
    source's; the kernel partitions K as ``splitk_ranges`` does and
    takes splitk.cuh's split rule over its tiles at kQkvSplitFactor
    blocks a SM (the rule itself is read from the source by
    test_torch_quant_tiles.py); bf16 forward variants at 16 rows or
    fewer report ``splitk``, which indexes GEMM_PATHS."""
    src = (CSRC / "fused_block.cu").read_text()
    hdr = (CSRC / "splitk.cuh").read_text()
    consts = {n: int(v) for n, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", hdr)}
    assert (consts["kSplitKMaxT"], consts["kSkBN"]) == (SK.SPLITK_MAX_T,
                                                        SK.SPLITK_BN)
    assert "const int s0 = split * slices / p.splits;" in src
    assert "const int steps = (split + 1) * slices / p.splits - s0;" in src
    assert ("return (dq + kSkBN - 1) / kSkBN + 2 * ((dkv + kSkBN - 1) / "
            "kSkBN);") in src
    assert ("return splitk_splits(d, qkv_tiles(dq, dkv) * kSkBN, sms, "
            "kQkvSplitFactor);") in src
    assert int(re.search(r"constexpr int kQkvSplitFactor = (\d+);",
                         src).group(1)) == FB.QKV_SPLIT_FACTOR
    for d in (64, 256, 4096, 14336):
        for dq, dkv in ((64, 64), (4096, 1024), (4160, 1088)):
            tiles = len(FB.qkv_column_tiles(dq, dkv))
            for sms in (1, 16, 132):
                assert FB.qkv_splits(d, dq, dkv, sms) == SK.splitk_splits(
                    d, tiles * SK.SPLITK_BN, sms, FB.QKV_SPLIT_FACTOR)
    entry = src[src.index("int ptt_rmsnorm_qkv("):]
    entry = entry[:entry.index("\n}\n")]
    assert "T <= kSplitKMaxT &&\n      xn != nullptr && inv == nullptr" \
        in entry
    assert "ptt::DESIGN_SPLITK" in entry
    assert FB.GEMM_PATHS.index("splitk") == int(re.search(
        r"DESIGN_SPLITK = (\d+)", (CSRC / "common.cuh").read_text()).group(1))
    bf = torch.bfloat16
    assert [FB.qkv_path(t, bf) for t in (1, 16, 17)] == \
        ["splitk", "splitk", "wgmma"]
    assert FB.qkv_path(8, bf, residuals=True) == "tile"
    assert FB.qkv_path(8, torch.float32) == "tile"


# -- the chunked cross-entropy's matmul precision (F1) ------------------------

CE_T, CE_D, CE_V = 24, 64, 1000


@pytest.fixture(scope="module")
def ce_case():
    """V=1000 over chunks of 256, ignored labels: inputs and JAX's loss,
    dh and dW (its flag is read by nothing; XLA's CPU dots are fp32)."""
    rng = np.random.default_rng(0)
    h = rng.standard_normal((CE_T, CE_D)).astype(np.float32)
    w = (rng.standard_normal((CE_D, CE_V)) * 0.1).astype(np.float32)
    lbl = rng.integers(0, CE_V, CE_T)
    lbl[[3, 10]] = -100

    def jloss(hh, ww):
        out = JF.fused_linear_cross_entropy(hh, ww, jnp.asarray(lbl),
                                            chunk_size=256)
        return out._data if hasattr(out, "_data") else out

    ref, (rdh, rdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    return h, w, lbl, (float(ref), np.asarray(rdh), np.asarray(rdw))


def _ce_against_jax(case):
    h, w, lbl, (ref, rdh, rdw) = case
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = TF.fused_linear_cross_entropy(th, tw, torch.from_numpy(lbl),
                                         chunk_size=256)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref, rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), rdh, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), rdw, atol=1e-5, rtol=1e-5)


@pytest.fixture
def precision_flag():
    """Restores FLAGS_default_matmul_precision after the test."""
    saved = flags.get("default_matmul_precision")
    yield
    flags.set_flags({"default_matmul_precision": saved})


@pytest.mark.parametrize("mode", flags.MATMUL_PRECISIONS)
def test_chunked_ce_on_the_cpu_is_exact_fp32_at_every_precision(
        ce_case, precision_flag, mode):
    """On the CPU the chunk products stay exact fp32 at every value of
    the flag: loss, dh and dW within 1e-5 of JAX's, as
    test_torch_train.py holds them, and TF32 is never switched on."""
    flags.set_flags({"FLAGS_default_matmul_precision": mode})
    assert flags.get("default_matmul_precision") == mode
    tf32 = torch.backends.cuda.matmul.allow_tf32
    _ce_against_jax(ce_case)
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


def test_chunked_ce_reads_the_flag_from_the_environment(ce_case,
                                                        monkeypatch):
    """``FLAGS_default_matmul_precision`` in the environment sets the
    flag's default when the module is imported; the CE still equals
    JAX's on the CPU; an unknown value raises."""
    monkeypatch.setenv("FLAGS_default_matmul_precision", "highest")
    try:
        importlib.reload(flags)
        assert flags.get("default_matmul_precision") == "highest"
        _ce_against_jax(ce_case)
        flags.set_flags({"default_matmul_precision": "bf16"})
        with pytest.raises(ValueError, match="default_matmul_precision"):
            TF.fused_linear_cross_entropy(torch.zeros((2, 4)),
                                          torch.zeros((4, 8)),
                                          torch.zeros(2, dtype=torch.long))
    finally:
        monkeypatch.delenv("FLAGS_default_matmul_precision")
        importlib.reload(flags)
    assert flags.get("default_matmul_precision") == "default"


@pytest.mark.parametrize("name", ["use_deterministic_ops",
                                  "FLAGS_benchmark", "log_level"])
def test_set_flags_refuses_a_flag_that_nothing_reads(name):
    """Only flags with a reader are defined: setting any other raises
    rather than passing in silence, and the defined flags are untouched
    (the op hook reads the two NaN/Inf flags, the chunked CE the matmul
    precision)."""
    before = flags.get_flags()
    with pytest.raises(KeyError, match="Unknown flag"):
        flags.set_flags({name: 1})
    with pytest.raises(KeyError, match="Unknown flag"):
        flags.get(name)
    assert flags.get_flags() == before == {
        "FLAGS_check_nan_inf": flags.get("check_nan_inf"),
        "FLAGS_check_nan_inf_level": flags.get("check_nan_inf_level"),
        "FLAGS_default_matmul_precision":
            flags.get("default_matmul_precision")}
