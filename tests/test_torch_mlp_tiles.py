"""The arithmetic of the MLP's split-K at decode rows and of the rmsnorm
redesign, on the CPU, against the JAX package on the same inputs.

The kernels run only on the card: the MLP's and fused_ffn's two products
at T <= 16 in bf16 (``csrc/fused_block.cu``, mlp_splitk_kernel on
``csrc/splitk.cuh``'s strip stream) and the rmsnorm's register design
(``csrc/rmsnorm.cu``, rmsnorm_regs_kernel).  What they compute is
modelled here: the strip stream lane by lane (the swizzled weight and
token boxes, the relabelled fragments, the shared-memory banks each read
touches), and the launches blockwise at the edge shapes
their splits create (T = 1, 8 and 16; a K of one 64-deep slice; a column
tile that is partial; the split rule at Llama-3-8B width on 132 SMs),
held against the Pallas kernel in interpret mode and against the port's
plain versions.  The split rule, the tile width and the entry's routing
are read from the sources.  Inputs come from numpy with a fixed seed.
fp32 cases agree within 1e-5 (sums in another order); bf16 cases within
one bf16 step of the output, 2^-7 of its value, plus 1e-3 for outputs
near 0 (both sides round the same fp32 sums once; an h that another
summation order rounds to the other side of a bf16 step moves an output
by far less)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_block as JFB
from paddle_tpu.ops.pallas import rmsnorm as JRN

from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import rmsnorm as RN
from paddle_tpu_torch.ops.kernels import splitk as SK

CSRC = Path(FB.__file__).resolve().parent / "csrc"
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2 ** -7)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
EPS = 1e-5


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


def _body(src, head):
    """The text of the C function whose definition starts with `head`."""
    body = src[src.index(head):]
    return body[:body.index("\n}\n")]


# -- the strip stream, lane by lane -------------------------------------------

def _c(expr):
    """A C integer expression of non-negative ints as Python's."""
    return expr.replace("/", "//")


def _unit_rule():
    """strip_unit's and strip_offsets' expressions and strip_box's token
    address, read from the source and evaluated as C integer arithmetic:
    (sv(lane), the byte offset of the lane's weight row i in k16 step 0,
    the byte offset in its token row of element i of step kk)."""
    hdr = (CSRC / "splitk.cuh").read_text()
    unit = re.search(r"return (g / 2 \+ 4 \* \(g % 2\));",
                     _body(hdr, "__device__ __forceinline__ int strip_unit("))
    off = re.search(r"off\[i\] = (\(q \+ 4 \* i\) \* 128 \+ 16 \* \(sv \^ "
                    r"\(q \+ 4 \* \(i % 2\)\)\));", hdr)
    box = _body(hdr, "__device__ __forceinline__ void strip_box(")
    k = re.search(r"const int k = (16 \* kk \+ q \+ 4 \* i);", box)
    at = re.search(r"row \+ (16 \* \(\(k / 8\) \^ g\) \+ 2 \* \(k % 8\))\);",
                   box)
    assert unit and off and k and at

    def sv(lane):
        return eval(_c(unit.group(1)), {"g": lane // 4})

    def offset(lane, i):
        return eval(off.group(1), {"q": lane % 4, "i": i, "sv": sv(lane)})

    def token(lane, kk, i):
        kv = eval(k.group(1), {"kk": kk, "q": lane % 4, "i": i})
        return eval(_c(at.group(1)), {"k": kv, "g": lane // 4})
    return sv, offset, token


def _swizzled(box):
    """A [rows][64] box as TMA's 128-byte swizzle lays it out, in 2-byte
    elements: row r at r * 128 bytes, its 16-byte unit v at v ^ (r % 8)."""
    out = np.zeros(box.size, np.float32)
    for r in range(box.shape[0]):
        for c in range(64):
            out[(r * 128 + 16 * ((c // 8) ^ (r % 8)) + 2 * (c % 8)) // 2] = \
                box[r, c]
    return out


def strip_lane_model(box, x, nt8):
    """One [64][64] weight box and its [8 nt8][64] token box through
    strip_box, lane by lane: each lane's A words from the swizzled weight
    box at the source's offsets, its B pairs from the swizzled token box
    at the source's addresses, the product by mma.m16n8k16's fragment
    semantics (A rows g / g + 8 and reduction pairs 2 q, 2 q + 8; B
    reduction pairs, column g; C rows g / g + 8, columns 2 q, 2 q + 1).
    Returns d [lane][m][nt][4] and the strip columns / tokens each
    accumulator stands for (splitk.cuh's map)."""
    sv, offset, token = _unit_rule()
    smem = _swizzled(box)
    ntok = 8 * nt8
    xs = _swizzled(x[:ntok])
    d = np.zeros((32, 4, nt8, 4))
    for kk in range(4):
        rows = {}
        for lane in range(32):
            rows[lane] = [smem[(kk * 2048 + offset(lane, i)) // 2:][:8]
                          for i in range(4)]
        for m in range(4):
            for nt in range(nt8):
                A, B = np.zeros((16, 16)), np.zeros((16, 8))
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    r = rows[lane]
                    for i in range(2):
                        # a0 / a1 (i = 0): rows 0 and 1 of the lane;
                        # a2 / a3 (i = 1): rows 2 and 3
                        A[g, 2 * q + 8 * i] = r[2 * i][2 * m]
                        A[g, 2 * q + 8 * i + 1] = r[2 * i + 1][2 * m]
                        A[g + 8, 2 * q + 8 * i] = r[2 * i][2 * m + 1]
                        A[g + 8, 2 * q + 8 * i + 1] = r[2 * i + 1][2 * m + 1]
                    b = [xs[(8 * nt + g) * 64 + token(lane, kk, i) // 2]
                         for i in range(4)]
                    B[2 * q, g], B[2 * q + 1, g] = b[0], b[1]
                    B[2 * q + 8, g], B[2 * q + 9, g] = b[2], b[3]
                D = A @ B
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    d[lane, m, nt] += (D[g, 2 * q], D[g, 2 * q + 1],
                                       D[g + 8, 2 * q], D[g + 8, 2 * q + 1])
    cols = {lane: [8 * sv(lane) + 2 * m for m in range(4)]
            for lane in range(32)}
    return d, cols


@pytest.mark.parametrize("nt8", [1, 2])
def test_strip_fragments_make_the_product(nt8):
    """Every accumulator of the lane model is its column's and token's
    sum over the box's 64 rows: d[m][nt][2 h + e] is column 8 sv + 2 m +
    h of the strip, token 8 nt + 2 q + e.  fp32, 1e-5."""
    rng = np.random.default_rng(nt8)
    box = rng.standard_normal((64, 64)).astype(np.float32)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    d, cols = strip_lane_model(box, x, nt8)
    ref = x @ box
    seen = set()
    for lane in range(32):
        q = lane % 4
        for m in range(4):
            for nt in range(nt8):
                for h in range(2):
                    for e in range(2):
                        c, t = cols[lane][m] + h, 8 * nt + 2 * q + e
                        seen.add((c, t))
                        assert abs(d[lane, m, nt, 2 * h + e] - ref[t, c]) \
                            < 1e-5
    assert seen == {(c, t) for c in range(64) for t in range(8 * nt8)}


def test_strip_reads_have_no_bank_conflict():
    """Each 16-byte weight read (step kk, row i) serves its quarter warps
    from eight distinct 16-byte units of the 128-byte bank line; each
    2-byte token read (step kk, element i, n-tile nt) puts the warp's 32
    lanes on distinct banks or on one word of a bank.  The [16][128]
    boxes of the quant and QKV rings, read as they read them, put four
    lanes on one unit."""
    _, offset, token = _unit_rule()
    for kk in range(4):
        for i in range(4):
            for p in range(4):
                units = {((kk * 2048 + offset(lane, i)) // 16) % 8
                         for lane in range(8 * p, 8 * p + 8)}
                assert len(units) == 8
            for nt in range(2):
                words = {}
                for lane in range(32):
                    a = (8 * nt + lane // 4) * 128 + token(lane, kk, i)
                    words.setdefault(a // 4 % 32, set()).add(a // 4)
                assert all(len(w) == 1 for w in words.values())
    old = {((4 * (lane % 4)) * 256 + 32 * (lane // 4)) // 16 % 8
           for lane in range(8)}
    assert len(old) == 2            # 8 lanes on 2 units: 4-way


# -- the launches, blockwise ----------------------------------------------------

def splitk_ranges(K, splits):
    """The kernel's K partition: split j takes the 64-deep slices ``j * n
    // splits`` to ``(j + 1) * n // splits`` of ``n = K // 64``."""
    n = K // 64
    return [(j * n // splits, (j + 1) * n // splits) for j in range(splits)]


def _product(a, w, sms):
    """One mlp_splitk_kernel launch's fp32 sums: split j of mlp_splits
    sums its 64-deep slices in order, each four k16 steps in order (a
    column's sum is its strip's, whatever tile holds it); the splits'
    partials added in split order.  Returns the sums and the split
    count."""
    K, N = w.shape
    splits = SK.mlp_splits(K, N, sms)
    af, wf = a.float(), w.float()
    total = None
    for lo, hi in splitk_ranges(K, splits):
        p = torch.zeros((a.shape[0], N))
        for k in range(64 * lo, 64 * hi, 16):
            p = p + af[:, k:k + 16] @ wf[k:k + 16]
        total = p if total is None else total + p
    return total, splits


def mlp_splitk_model(x, w1, wu, w2, b1=None, b2=None, act="relu", sms=132):
    """ptt_mlp's two split-K launches: gate/up (or fused_ffn's up), the
    epilogue on the merged fp32 sums (silu(g) * u, or act(u + b1)), h
    cast once to x's dtype; the down product, + b2 on its merged sum, one
    cast.  Returns y and each launch's split count."""
    g, s_up = _product(x, w1, sms)
    if wu is not None:
        u, _ = _product(x, wu, sms)
        h = ((g * (1 / (1 + torch.exp(-g)))) * u).to(x.dtype)
    else:
        h = FB._act(act, g + b1.float()).to(x.dtype)
    y, s_down = _product(h, w2, sms)
    if b2 is not None:
        y = y + b2.float()
    return y.to(x.dtype), (s_up, s_down)


# (T, d, f, sms): d = 64 is one slice for gate/up; f = 320 a partial last
# 256-column tile there and 5 slices for the down product, whose N = 64
# is one partial tile; 132 SMs split the down product 5 ways, 4 SMs
# split d = 256 in 2
MLP_CASES = [(1, 64, 320, 132), (8, 64, 320, 132), (16, 64, 320, 132),
             (8, 256, 192, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,f,sms", MLP_CASES)
def test_mlp_splitk_model_matches_pallas(dtype, T, d, f, sms):
    """The gated model against ``_mlp_pallas`` (interpret mode, silu) and
    ``fused_mlp``'s plain version."""
    rng = np.random.default_rng(T + d + f)
    jx, tx = _both(rng, (T, d), dtype)
    jg, tg = _both(rng, (d, f), dtype, d ** -0.5)
    ju, tu = _both(rng, (d, f), dtype, d ** -0.5)
    jd, td = _both(rng, (f, d), dtype, f ** -0.5)
    got, splits = mlp_splitk_model(tx, tg, tu, td, sms=sms)
    assert splits == (SK.mlp_splits(d, f, sms), SK.mlp_splits(f, d, sms))
    ref = JFB._mlp_pallas(jx, (jg, ju, jd), None, act="silu", gated=True,
                          block_t=T, block_f=64, interpret=True)
    _close(got.float(), _np(ref), dtype)
    _close(got.float(), FB.fused_mlp(tx, tg, tu, td).float(), dtype)


@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("T", [1, 8, 16])
def test_ffn_splitk_model_matches_pallas(act, T):
    """bf16, d = 64 (one slice), f = 320 (a partial tile), both biases:
    the non-gated model against ``_mlp_pallas`` (interpret mode) and
    ``fused_ffn``'s plain version."""
    rng = np.random.default_rng(T + len(act))
    d, f, dt = 64, 320, torch.bfloat16
    jx, tx = _both(rng, (T, d), dt)
    j1, t1 = _both(rng, (d, f), dt, d ** -0.5)
    j2, t2 = _both(rng, (f, d), dt, f ** -0.5)
    jb1, tb1 = _both(rng, (f,), dt, 0.5)
    jb2, tb2 = _both(rng, (d,), dt, 0.5)
    got, _ = mlp_splitk_model(tx, t1, None, t2, tb1, tb2, act)
    ref = JFB._mlp_pallas(jx, (j1, j2), (jb1, jb2), act=act, gated=False,
                          block_t=T, block_f=64, interpret=True)
    _close(got.float(), _np(ref), dt)
    _close(got.float(), FB.fused_ffn(tx, t1, t2, tb1, tb2, act).float(), dt)


def test_mlp_split_rule_fills_one_wave_at_llama_width():
    """On 132 SMs the gate/up (K 4096, two weights of N 14336) takes 56
    tiles x 2 splits and the down product (K 14336, N 4096) 16 x 8: one
    block a SM, one wave.  For every width tried (K to 14336, N from 64,
    1 to 132 SMs) the splits cover the slices once, in order, none empty,
    and fill one wave where the slices allow; the workspace holds the
    larger launch's partials."""
    assert (SK.mlp_splits(4096, 14336, 132), SK.mlp_splits(14336, 4096,
                                                           132)) == (2, 8)
    assert -(-14336 // SK.MLP_BN) * 2 == 112 <= 132
    assert -(-4096 // SK.MLP_BN) * 8 == 128 <= 132
    for K in (64, 320, 4096, 14336):
        for N in (64, 320, 2048, 4096, 14336):
            for sms in (1, 16, 132):
                s = SK.mlp_splits(K, N, sms)
                r = splitk_ranges(K, s)
                assert [lo for lo, _ in r] == [0] + [hi for _, hi in r[:-1]]
                assert r[-1][1] == K // 64
                assert all(hi - lo >= 1 for lo, hi in r)
                tiles = -(-N // SK.MLP_BN)
                assert tiles * s <= max(sms, tiles)
    floats, tickets = FB.mlp_workspace(8, 4096, 14336, True, 132)
    assert floats == max(2 * 2 * 56, 8 * 16) * 256 * 8
    assert FB.mlp_workspace(9, 4096, 14336, True, 132)[0] == 2 * floats
    assert tickets == 56


def test_mlp_splitk_agrees_with_the_kernel_source():
    """The tile width and split rule are the source's (the rule evaluated
    with C's integer division gives ``mlp_splits`` at every size tried);
    the kernel partitions K as ``splitk_ranges`` does and its workspace
    check is ``mlp_workspace``'s size; ``ptt_mlp`` sends bf16 at
    kRowPassMinT rows or more to the wgmma ring, at kSplitKMaxT or fewer
    to split-K and fp32 to the tile, and reports each design, which
    ``gemm_path`` names."""
    src = (CSRC / "fused_block.cu").read_text()
    assert int(re.search(r"constexpr int kMlpBN = (\d+);",
                         src).group(1)) == SK.MLP_BN
    rule = _body(src, "inline int mlp_splits(int K, int N, int sms) {")
    assert rule.split("{", 1)[1].split() == """
      const int tiles = (N + kMlpBN - 1) / kMlpBN;
      return min(max(1, sms / tiles), K / 64);""".split()
    for K in (64, 320, 4096, 14336):
        for N in (64, 320, 4096, 14336):
            for sms in (1, 7, 132):
                tiles = (N + SK.MLP_BN - 1) // SK.MLP_BN
                assert min(max(1, sms // tiles), K // 64) == \
                    SK.mlp_splits(K, N, sms)
    kern = _body(src, "mlp_splitk_kernel(const __grid_constant__")
    assert "const int s0 = split * slices / p.splits;" in kern
    assert "n0 < p.N ? (split + 1) * slices / p.splits - s0 : 0;" in kern
    host = _body(src, "int mlp_splitk(const void* x,")
    assert "const int ntok = T <= 8 ? 8 : 16;" in host
    assert "(long long)a.splits * NB * tiles * kMlpBN * ntok > ws_floats" \
        in host
    entry = _body(src, "int ptt_mlp(int dtype,")
    assert ("if ((dtype == ptt::DT_BFLOAT16 || dtype == ptt::DT_FLOAT16) &&"
            "\n      T >= kRowPassMinT) {") in entry
    assert ("} else if (dtype == ptt::DT_BFLOAT16 && T <= kSplitKMaxT) {"
            in entry)
    for design, call in (("WGMMA", "mlp_hopper_pair<"),
                         ("SPLITK", "mlp_splitk<"),
                         ("TILE", "launch<MODE_PLAIN>")):
        assert f"used = ptt::DESIGN_{design};" in entry and call in entry
    assert FB.ROW_PASS_MIN_T == SK.SPLITK_MAX_T + 1
    bf = torch.bfloat16
    for dt in (bf, torch.float16):
        assert [FB.gemm_path(t, dt) for t in (1, 16, 17)] == \
            ["splitk", "splitk", "wgmma"]
    assert FB.gemm_path(8, torch.float32) == "tile"


# -- rmsnorm ---------------------------------------------------------------------

def rmsnorm_plan(d, itemsize):
    """rmsnorm.cu's launch plan for rows on the 16-byte grid: (W warps a
    row, KV vectors a thread), or None where the row takes the
    two-pass design (more than kMaxVecs vectors a thread)."""
    vecs = d // (16 // itemsize)
    W = 1
    while W < 8 and vecs > 2 * 32 * W:
        W *= 2
    kv = -(-vecs // (32 * W))
    return (W, kv) if kv <= 4 else None


def test_rmsnorm_register_plan_agrees_with_the_kernel_source():
    """The source's plan, read from it: at Llama-3-8B width a row is
    eight warps holding two bf16 vectors (four fp32) a thread; thread t
    of a row takes vectors t, t + 32 W, ..., which cover the row once;
    rows past 8192 bf16 / 4096 fp32 elements take the two-pass design."""
    src = (CSRC / "rmsnorm.cu").read_text()
    assert "constexpr int kMaxVecs = 4;" in src
    assert "while (W < 8 && vecs > 2 * 32 * W) W *= 2;" in src
    assert "const int kv = (vecs + 32 * W - 1) / (32 * W);" in src
    assert "const int c = (k * per + t) * V;" in src
    assert rmsnorm_plan(4096, 2) == (8, 2)
    assert rmsnorm_plan(4096, 4) == (8, 4)
    assert rmsnorm_plan(8192, 2) == (8, 4) and rmsnorm_plan(8200, 2) is None
    assert rmsnorm_plan(4104, 4) is None and rmsnorm_plan(512, 2) == (1, 2)
    for d in (8, 64, 512, 1000, 4096, 8192):
        for item in (2, 4):
            plan = rmsnorm_plan(d, item)
            if plan is None or d % (16 // item):
                continue
            W, kv = plan
            V = 16 // item
            cells = sorted((k * 32 * W + t) * V for k in range(kv)
                           for t in range(32 * W) if (k * 32 * W + t) * V < d)
            assert cells == list(range(0, d, V))


@pytest.mark.parametrize("shape", [(16, 256), (2, 8, 256)])
def test_rmsnorm_without_a_residual_returns_x_as_h(shape):
    """No residual: ``fused_rmsnorm``'s h is x itself (the same storage,
    x's shape), and equals JAX's h; with one, h is a new tensor."""
    rng = np.random.default_rng(len(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(shape[-1:]).astype(
        np.float32)).to(torch.bfloat16)
    y, h, inv = RN.fused_rmsnorm(x, w, None, EPS)
    assert h.data_ptr() == x.data_ptr() and h.shape == x.shape
    jy, jh, _ = JRN._ref_fwd(jnp.asarray(x.float().numpy()).reshape(
        -1, shape[-1]).astype(jnp.bfloat16), None,
        jnp.asarray(w.float().numpy()).astype(jnp.bfloat16), EPS)
    assert np.array_equal(h.float().numpy().reshape(-1, shape[-1]), _np(jh))
    _close(y.float().numpy().reshape(-1, shape[-1]), _np(jy), torch.bfloat16)
    _, h2, _ = RN.fused_rmsnorm(x, w, x.clone(), EPS)
    assert h2.data_ptr() != x.data_ptr()


def test_rms_norm_residual_without_a_residual_keeps_jax_gradients():
    """F.rms_norm_residual with no residual, h now x itself: y and h
    against JAX's ``fused_rmsnorm`` (the Pallas kernel in interpret mode),
    and the gradients of x and the weight through sum(y^2) + 3 sum(h)
    against its custom VJP; fp32 within 1e-5."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 8, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal((256,))).astype(np.float32)

    def jloss(a, c):
        y, h = JRN.fused_rmsnorm(a, c, epsilon=EPS, interpret=True,
                                 use_pallas=True)
        return jnp.sum(y ** 2) + 3 * jnp.sum(h), (y, h)

    (_, (jy, jh)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(x),
                                                         jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y, h = TF.rms_norm_residual(tx, tw, None, EPS)
    assert h.data_ptr() == tx.data_ptr()
    for got, ref in ((y, jy), (h, jh)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    ((y ** 2).sum() + 3 * h.sum()).backward()
    for got, ref in ((tx.grad, jg[0]), (tw.grad, jg[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
