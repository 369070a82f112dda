"""The arithmetic of the Hopper quant matmul and of the MLP / fused_ffn
GEMMs, on the CPU, against the JAX package on the same inputs.

The bf16 kernels run only on the card: the quant matmul's split-K
(``csrc/quant_matmul.cu``, quant_splitk_kernel: T <= 16) and wgmma
(quant_wgmma_kernel: T > 16) designs, and the MLP's gate/up, fused_ffn's
up and the down product on the wgmma ring (``csrc/fused_block.cu``,
mlp_gemm_kernel: T > 16).  What they compute is modelled here blockwise,
at the edge shapes their tiles create (one 64-deep slice, more splits
asked than slices, a partial last row tile, a width not a multiple of the
column tile), and held against the Pallas kernels in interpret mode and
against the port's plain versions.  The split rule and the thresholds
are read from the sources.  Inputs come from numpy with a fixed seed;
quantized weights come from the JAX package and cross as their bits.
fp32 cases agree within 1e-5 (sums in another order); bf16 cases within
one bf16 step of the output, 2^-7 of its value (both sides round the
same fp32 values once; an h that another summation order rounds to the
other side of a bf16 step moves an output by far less), plus 1e-3 for
outputs near 0."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_block as JFB
from paddle_tpu.ops.pallas import quant_matmul as JQM
from paddle_tpu.quantization import serving as JQS

from paddle_tpu_torch.nn.layer import _from_numpy
from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import quant_matmul as QM
from paddle_tpu_torch.ops.kernels import splitk as SK

CSRC = Path(QM.__file__).resolve().parent / "csrc"
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


def _quant(rng, K, N, mode):
    """JAX's quantized weight and scale, and the same bits as tensors."""
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    jq, js = JQS.quantize_linear_weight(jnp.asarray(w), mode)
    return jq, js, _from_numpy(np.asarray(jq)), _from_numpy(np.asarray(js))


# -- the quant matmul: split-K at T <= 16 -------------------------------------

def splitk_ranges(K, splits):
    """quant_splitk_kernel's partition: split j takes the 64-deep slices
    ``j * n // splits`` to ``(j + 1) * n // splits`` of the ``n = K //
    64`` (s0 and steps in the kernel)."""
    n = K // 64
    return [(j * n // splits, (j + 1) * n // splits) for j in range(splits)]


def splitk_model(x, qw, scale, splits):
    """quant_splitk_kernel's arithmetic: split j of ``splitk_ranges``
    sums its 64-deep slices, where warp w (0..3) takes k16 step w of
    every slice and the block adds its warps in order; the splits' fp32
    partials are added in split order, the scale multiplies the total and
    one cast writes x's dtype.  Returns the output and the 64-deep slices
    each split took."""
    T, K = x.shape
    xf, wf = x.float(), qw.to(x.dtype).float()
    total, taken = None, []
    for lo, hi in splitk_ranges(K, splits):
        taken += list(range(lo, hi))
        warps = []
        for w in range(4):
            acc = torch.zeros((T, qw.shape[1]))
            for sl in range(lo, hi):
                k = 64 * sl + 16 * w
                acc = acc + xf[:, k:k + 16] @ wf[k:k + 16]
            warps.append(acc)
        part = ((warps[0] + warps[1]) + warps[2]) + warps[3]
        total = part if total is None else total + part
    return (total * scale.float()).to(x.dtype), taken


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 8, 16])
@pytest.mark.parametrize("K,N,ask", [(64, 64, 4), (192, 128, 5),
                                     (512, 64, 2)])
def test_splitk_model_matches_pallas(mode, dtype, T, K, N, ask):
    """K = 64 is one slice (one split whatever is asked); K = 192 asks
    5 splits of its 3 slices, and gets 3 (the rule's last cap, which
    splitk_splits applies after the others); N = 64 is half a 128-column
    tile.  Every slice is taken once, in order; the model against
    ``quant_matmul_pallas`` (interpret mode, K whole) and the port's
    plain version."""
    rng = np.random.default_rng(T + K + N)
    jx, tx = _both(rng, (T, K), dtype)
    jq, js, tq, ts = _quant(rng, K, N, mode)
    splits = min(ask, K // 64)
    got, taken = splitk_model(tx, tq, ts, splits)
    assert taken == list(range(K // 64))
    ref = JQM.quant_matmul_pallas(jx, jq, js, block_t=T, block_n=N,
                                  interpret=True, autotune=False)
    _close(got.float(), _np(ref), dtype)
    _close(got.float(), QM.quant_matmul_reference(tx, tq, ts).float(), dtype)


def test_splitk_ranges_take_every_slice_once():
    """The balanced partition: contiguous, in order, each split at least
    one slice and at most one more than another, for every split count
    up to the slices."""
    for K in (64, 256, 4096, 14336):
        n = K // 64
        for splits in range(1, n + 1):
            r = splitk_ranges(K, splits)
            assert [lo for lo, _ in r] == [0] + [hi for _, hi in r[:-1]]
            assert r[-1][1] == n
            sizes = [hi - lo for lo, hi in r]
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def test_splitk_rule_at_the_decode_shapes():
    """The H100's 132 SMs: every Llama-3-8B decode projection fills the
    card with at least 128 blocks, keeps 4 slices a split and no split
    deeper than 2048."""
    shapes = {(4096, 1024): 16, (4096, 4096): 9, (4096, 14336): 3,
              (14336, 4096): 9, (4096, 128256): 2}
    for (K, N), want in shapes.items():
        s = SK.splitk_splits(K, N, 132)
        assert s == want, (K, N, s)
        assert -(-N // 128) * s >= 128
        depth = max(hi - lo for lo, hi in splitk_ranges(K, s)) * 64
        assert 256 <= depth <= 2048


def _c_function(src, name):
    """The body of ``int name(...) { ... }`` in a C source."""
    m = re.search(r"int " + name + r"\([^)]*\) \{\n(.*?)\n\}", src, re.S)
    assert m, name
    return m.group(1)


def test_splitk_rule_agrees_with_the_kernel_source():
    """The wrapper's constants are the source's, the kernel partitions K
    as ``splitk_ranges`` does, and the source's splitk_splits, evaluated
    line by line with C's integer division, gives the wrapper's split
    count at every shape tried (the rule and its constants live in
    splitk.cuh, which the kernel includes)."""
    src = (CSRC / "quant_matmul.cu").read_text()
    assert '#include "splitk.cuh"' in src
    src += (CSRC / "splitk.cuh").read_text()
    consts = {n: int(v) for n, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kSplitKMaxT"], consts["kSkBN"], consts["kSplitFactor"],
            consts["kMinSlices"], consts["kMaxSplitDepth"]) == (
                SK.SPLITK_MAX_T, SK.SPLITK_BN, SK.SPLIT_FACTOR,
                SK.MIN_SLICES, SK.MAX_SPLIT_DEPTH)
    # the kernel's partition is splitk_ranges'
    assert "const int s0 = split * slices / p.splits;" in src
    assert "const int steps = (split + 1) * slices / p.splits - s0;" in src
    body = _c_function(src, "splitk_splits")
    py = []
    for line in body.splitlines():
        line = line.strip().rstrip(";")
        line = re.sub(r"^(const )?int ", "", line).replace("/", "//")
        py.append(line.replace("return ", "__r = "))
    for K in (64, 128, 192, 512, 4096, 14336, 28672):
        for N in (64, 192, 1024, 4096, 14336, 128256):
            for sms in (1, 16, 132):
                env = dict(consts, K=K, N=N, sms=sms, min=min, max=max,
                           factor=consts["kSplitFactor"])
                exec("\n".join(py), env)
                assert env["__r"] == SK.splitk_splits(K, N, sms), (K, N, sms)


# -- the quant matmul: wgmma at T > 16 ----------------------------------------

def quant_wgmma_model(x, qw, scale, bm, bn):
    """quant_wgmma_kernel's arithmetic: [bm, bn] tiles, the row and
    column tiles past the matrix zero-filled; K in 64-deep slices summed
    in fp32, the weight up-converted exactly; the scale on the fp32 sum
    and one cast; rows and columns past the matrix dropped."""
    T, K = x.shape
    N = qw.shape[1]
    tp, np_ = -(-T // bm) * bm, -(-N // bn) * bn
    xf = torch.zeros((tp, K))
    xf[:T] = x.float()
    wf = torch.zeros((K, np_))
    wf[:, :N] = qw.to(x.dtype).float()
    sf = torch.zeros(np_)
    sf[:N] = scale.float()
    out = torch.zeros((tp, np_))
    for m0 in range(0, tp, bm):
        for n0 in range(0, np_, bn):
            acc = torch.zeros((bm, bn))
            for k in range(0, K, 64):
                acc = acc + xf[m0:m0 + bm, k:k + 64] @ wf[k:k + 64,
                                                          n0:n0 + bn]
            out[m0:m0 + bm, n0:n0 + bn] = acc * sf[n0:n0 + bn]
    return out[:T, :N].to(x.dtype)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("T,N,bm,bn", [(17, 192, 64, 128),
                                       (150, 320, 128, 256)])
def test_quant_wgmma_model_matches_pallas(mode, T, N, bm, bn):
    """bf16, T = 17 (one row past split-K) and 150 (a partial last row
    tile), N not a multiple of the column tile, both tile shapes."""
    rng = np.random.default_rng(T + N + len(mode))
    K = 256
    jx, tx = _both(rng, (T, K), torch.bfloat16)
    jq, js, tq, ts = _quant(rng, K, N, mode)
    assert QM.kernel_path(T, torch.bfloat16) == "wgmma"
    got = quant_wgmma_model(tx, tq, ts, bm, bn)
    ref = JQM.quant_matmul_pallas(jx, jq, js, block_t=T, block_n=N,
                                  interpret=True, autotune=False)
    _close(got.float(), _np(ref), torch.bfloat16)
    _close(got.float(), QM.quant_matmul_reference(tx, tq, ts).float(),
           torch.bfloat16)


def test_quant_paths_agree_with_the_kernel_source():
    """bf16 takes split-K up to kSplitKMaxT rows and wgmma past it; fp32
    always takes the tile."""
    src = (CSRC / "quant_matmul.cu").read_text()
    assert "if (T_ <= kSplitKMaxT) {" in src
    assert [QM.kernel_path(T, torch.bfloat16) for T in (1, 16, 17)] == \
        ["splitk", "splitk", "wgmma"]
    assert QM.kernel_path(256, torch.float32) == "tile"


# -- the MLP and fused_ffn on the wgmma ring -----------------------------------

def _tiled(a, w, bn, bias=None):
    """a @ w in column tiles of `bn` (the last zero-padded, as TMA fills
    it), fp32 sums over 64-deep slices, plus an fp32 bias; fp32 out."""
    n = w.shape[1]
    wp = torch.zeros((w.shape[0], -(-n // bn) * bn))
    wp[:, :n] = w.float()
    out = []
    for c in range(0, wp.shape[1], bn):
        acc = torch.zeros((a.shape[0], bn))
        for k in range(0, a.shape[1], 64):
            acc = acc + a[:, k:k + 64].float() @ wp[k:k + 64, c:c + bn]
        out.append(acc)
    y = torch.cat(out, 1)[:, :n]
    return y if bias is None else y + bias.float()


def mlp_ring_model(x, wg, wu, wd, bn):
    """mlp_gemm_kernel's gate/up (two accumulators of the same column
    tile; h = silu(g) * u from fp32, cast once) then its down product."""
    g, u = _tiled(x, wg, bn), _tiled(x, wu, bn)
    h = ((g * (1 / (1 + torch.exp(-g)))) * u).to(x.dtype)
    return _tiled(h, wd, bn).to(x.dtype)


def ffn_ring_model(x, w1, b1, w2, b2, act, bn):
    """fused_ffn's up (the fp32 bias, then the activation, one cast) and
    down (its bias before the cast) on the ring."""
    h = FB._act(act, _tiled(x, w1, bn, b1)).to(x.dtype)
    return _tiled(h, w2, bn, b2).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [17, 150])
@pytest.mark.parametrize("bn", [128, 256])
def test_mlp_ring_model_matches_pallas(dtype, T, bn):
    """f = 192 and d = 128 leave a partial last column tile in both
    launches; T = 150 a partial last row tile.  Against ``_mlp_pallas``
    (interpret mode, gated silu) and ``fused_mlp``'s plain version."""
    rng = np.random.default_rng(T + bn)
    d, f = 128, 192
    jx, tx = _both(rng, (T, d), dtype)
    jg, tg = _both(rng, (d, f), dtype, d ** -0.5)
    ju, tu = _both(rng, (d, f), dtype, d ** -0.5)
    jd, td = _both(rng, (f, d), dtype, f ** -0.5)
    got = mlp_ring_model(tx, tg, tu, td, bn)
    ref = JFB._mlp_pallas(jx, (jg, ju, jd), None, act="silu", gated=True,
                          block_t=T, block_f=64, interpret=True)
    _close(got.float(), _np(ref), dtype)
    _close(got.float(), FB.fused_mlp(tx, tg, tu, td).float(), dtype)


@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("T", [17, 150])
def test_ffn_ring_model_matches_pallas(act, T):
    """bf16, f = 192 (a partial last column tile of 128), both biases:
    the non-gated ``_mlp_pallas`` (interpret mode) and ``fused_ffn``'s
    plain version."""
    rng = np.random.default_rng(T + len(act))
    d, f = 128, 192
    dt = torch.bfloat16
    jx, tx = _both(rng, (T, d), dt)
    j1, t1 = _both(rng, (d, f), dt, d ** -0.5)
    j2, t2 = _both(rng, (f, d), dt, f ** -0.5)
    jb1, tb1 = _both(rng, (f,), dt, 0.5)
    jb2, tb2 = _both(rng, (d,), dt, 0.5)
    got = ffn_ring_model(tx, t1, tb1, t2, tb2, act, 128)
    ref = JFB._mlp_pallas(jx, (j1, j2), (jb1, jb2), act=act, gated=False,
                          block_t=T, block_f=64, interpret=True)
    _close(got.float(), _np(ref), dt)
    _close(got.float(), FB.fused_ffn(tx, t1, t2, tb1, tb2, act).float(), dt)


def test_gemm_paths_agree_with_the_kernel_source():
    """The MLP / FFN entry (``ptt_mlp``, both products of a call) routes
    bf16 and fp16 at kRowPassMinT rows or more to the wgmma ring and bf16
    below it to split-K, fp32 at kRowPassMinT rows or more to 3xTF32 and
    below it to the tile; the wrapper's ``gemm_path`` by the same
    threshold."""
    src = (CSRC / "fused_block.cu").read_text()
    body = src[src.index("int ptt_mlp(int dtype,"):]
    body = body[:body.index("\n}\n")]
    assert ("if ((dtype == ptt::DT_BFLOAT16 || dtype == ptt::DT_FLOAT16) &&"
            "\n      T >= kRowPassMinT) {") in body
    assert "mlp_hopper_pair<" in body and "mlp_splitk<" in body
    t = FB.ROW_PASS_MIN_T
    for dt in (torch.bfloat16, torch.float16):
        assert [FB.gemm_path(n, dt) for n in (t - 1, t)] == \
            ["splitk", "wgmma"]
    assert "} else if (dtype == ptt::DT_FLOAT32 && T >= kRowPassMinT) {" \
        in body and "mlp_tf32x3(" in body
    assert [FB.gemm_path(n, torch.float32) for n in (t - 1, t, 8192)] == \
        ["tile", "tf32x3", "tf32x3"]
