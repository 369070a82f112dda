"""The fp32 QKV, MLP and fused_ffn at T >= 17 as 3xTF32 on wgmma
(``csrc/tf32x3.cuh``, ``csrc/fused_block.cu``), on the CPU.

The kernels run only on the card (``tests/test_torch_cuda.py -k tf32``).
Here a model of their arithmetic — ``cvt.rna`` rounding by bit
operations, the split, the three products summed in fp32 a k8 step at a
time, each 32-deep slice from zero — is held against the JAX package's
references (``_qkv_reference``, ``_mlp_gated_reference``,
``_ffn_reference``) and against float64; a model of the kernels' tiles
(the persistent walk, the parts of q | k | v, zero-filled edges, masked
stores) against the same; and the routing, the rings' shared memory and
the split operands' sizes against the kernel source.  Inputs come from
numpy with fixed seeds."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_block as JFB

from paddle_tpu_torch.ops.kernels import fused_block as FB

CSRC = Path(FB.__file__).resolve().parent / "csrc"
# (atol, rtol) against the JAX references in fp32: the sums' order and
# the split's residual (2^-22 of each operand)
TOL = {torch.float32: (1e-5, 1e-5)}
EPS = 1e-5
# a slot's depth in fp32 elements (one 128-byte swizzle row), the dynamic
# shared memory a block may use on an H100, and the bytes of slots a ring
# holds (csrc/tf32x3.cuh, Tf32Plan)
BK = 32
MAX_SMEM = 232448
RING_BYTES = 192 * 1024


class TX:
    """A model of csrc/tf32x3.cuh and its launches: the arithmetic, the
    ring's shared memory, the tile a launch takes, gate/up's rows."""

    @staticmethod
    def tf32_round(x):
        """fp32 `x` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: half
        an ulp of the 10-bit mantissa (bit 12) added to the magnitude's
        bits, then the 13 low bits cleared, so a tie rounds away from zero
        and a carry moves into the exponent."""
        bits = x.float().contiguous().view(torch.int32).to(torch.int64)
        bits = ((bits & 0xFFFFFFFF) + 0x1000) & 0xFFFFE000
        bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
        return bits.to(torch.int32).view(torch.float32).reshape(x.shape)

    @staticmethod
    def split(x):
        """``(hi, lo)``: hi = tf32(x), lo = tf32(x - hi), the remainder
        exact in fp32 (``tf32_split`` in ``csrc/common.cuh``)."""
        x = x.float()
        hi = TX.tf32_round(x)
        return hi, TX.tf32_round(x - hi)

    @staticmethod
    def products(ah, al, bh, bl):
        """The GEMM's sums over split operands (A's halves ``[M, K]``,
        B's ``[K, N]``, K a multiple of BK): each BK-deep slice summed
        from zero, for every k8 step ``part += a_lo b_hi``, then ``a_hi
        b_lo``, then ``a_hi b_hi``, and the slice's sum added to the
        total, all in fp32 (each product of TF32 values is exact in fp32;
        ``a_lo b_lo`` is dropped)."""
        acc = torch.zeros((ah.shape[0], bh.shape[1]), dtype=torch.float32)
        for k0 in range(0, ah.shape[1], BK):
            part = torch.zeros_like(acc)
            for k in range(k0, k0 + BK, 8):
                s = slice(k, k + 8)
                part = part + al[:, s] @ bh[s]
                part = part + ah[:, s] @ bl[s]
                part = part + ah[:, s] @ bh[s]
            acc = acc + part
        return acc

    @staticmethod
    def matmul(a, b):
        """``a [M, K] @ b [K, N]`` in fp32 as the 3xTF32 GEMM computes
        it: both operands split, then :meth:`products`."""
        return TX.products(*TX.split(a), *TX.split(b))

    @staticmethod
    def one_pass(a, b):
        """One TF32 product: both operands rounded to TF32, fp32 sums."""
        return TX.tf32_round(a) @ TX.tf32_round(b)

    @staticmethod
    def plan(nc):
        """``Tf32Plan<NC>``: rows (64 a consumer warpgroup), 128 columns,
        the bytes of a box and of a slot (A's hi and lo, B^T's hi and
        lo), the slots that fit RING_BYTES, and the dynamic shared memory
        (1 KB of alignment slack, the ring, two mbarriers a slot)."""
        bm, bn = 64 * nc, 128
        a_bytes, b_bytes = bm * BK * 4, bn * BK * 4
        stage = 2 * a_bytes + 2 * b_bytes
        stages = RING_BYTES // stage
        return {"A_BYTES": a_bytes, "B_BYTES": b_bytes,
                "STAGE_BYTES": stage, "STAGES": stages,
                "SMEM": 1024 + stages * stage + 16 * stages}

    @staticmethod
    def gemm_tile(T, widths, gated, sms):
        """``(NC, outputs a tile)`` of one product (``tf32x3_gemm`` in
        ``csrc/fused_block.cu``): 128 columns of B^T a tile, which are 64
        outputs for gate/up (g and u of each) and 128 otherwise; two
        consumer warpgroups (128 rows) where the 128-row tiles over the
        column tiles of every part in `widths` give each of `sms` SMs
        one, else one (64 rows)."""
        on = 64 if gated else 128
        cols = sum(-(-n // on) for n in widths)
        return (2 if -(-T // 128) * cols >= sms else 1), on

    @staticmethod
    def gate_up_rows(f):
        """The row of B^T that each of gate/up's 2 f columns takes (the
        gate's columns first, then the up's): groups of 64 every 128
        rows, the gate's at 0.., the up's at 64.. (``mlp_tf32x3``'s
        split)."""
        n = torch.arange(f)
        row = n // 64 * 128 + n % 64
        return torch.cat([row, row + 64])


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, ref, tol=TOL[torch.float32]):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(ref, dtype=np.float32),
                               atol=tol[0], rtol=tol[1])


def _src(name):
    return (CSRC / name).read_text()


def _body(src, start):
    i = src.index(start)
    return src[i:src.index("\n}\n", i)]


def _bits(x):
    return torch.tensor([x], dtype=torch.float32).view(torch.int32).item() \
        & 0xFFFFFFFF


def _float(bits):
    b = bits - 2 ** 32 if bits >= 2 ** 31 else bits
    return torch.tensor([b], dtype=torch.int32).view(torch.float32)


# -- cvt.rna and the split ---------------------------------------------------

# (fp32 bits, TF32 bits of cvt.rna): below, at and above the tie of bit
# 12, negative ties (away from zero, not up), a carry into the exponent, the
# largest finite values (rounding to inf), zero and a subnormal
RNA_CASES = [(0x3F800FFF, 0x3F800000), (0x3F801000, 0x3F802000),
             (0x3F801001, 0x3F802000), (0x3F803000, 0x3F804000),
             (0xBF801000, 0xBF802000), (0xBF800FFF, 0xBF800000),
             (0x3FFFF000, 0x40000000), (0x7F7FFFFF, 0x7F800000),
             (0xFF7FFFFF, 0xFF800000), (0x00000000, 0x00000000),
             (0x00001000, 0x00002000)]


@pytest.mark.parametrize("bits,want", RNA_CASES)
def test_tf32_round_is_cvt_rna(bits, want):
    """To nearest with ties away from zero on the 10-bit mantissa, the 13
    low bits cleared, as hopper.cuh's tf32_rna masks the instruction's
    result."""
    got = TX.tf32_round(_float(bits))
    assert _bits(got.item()) == want, (hex(bits), hex(_bits(got.item())))


@pytest.mark.parametrize("scale", [1e-30, 1e-3, 1.0, 3e4, 1e30])
def test_split_leaves_at_most_2_pow_minus_22(scale):
    """hi and lo are TF32 values, hi + lo is x to within 2^-22 |x|, and
    x - hi is exact in fp32 (lo is that remainder rounded once)."""
    x = torch.as_tensor(_np(np.random.default_rng(int(np.log2(scale) + 200)),
                            (4096,), scale))
    hi, lo = TX.split(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    r = (x.double() - hi.double() - lo.double()).abs()
    assert bool((r <= 2.0 ** -22 * x.double().abs()).all())
    assert torch.equal((x - hi).double(), x.double() - hi.double())
    assert torch.equal(lo, TX.tf32_round(x - hi))


# -- the arithmetic against JAX's references ---------------------------------

def _qkv_model(x, wn, wq, wk, wv, residuals):
    """What the 3xTF32 QKV computes: _qkv_reference's xn and inv in fp32,
    then the three products."""
    inv = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS)
    xn = (x * inv) * wn
    out = tuple(TX.matmul(xn, w) for w in (wq, wk, wv))
    return out + (xn, inv) if residuals else out


def _mlp_model(x, wg, wu, wd):
    g, u = TX.matmul(x, wg), TX.matmul(x, wu)
    return TX.matmul((g * torch.sigmoid(g)) * u, wd)


def _ffn_model(x, w1, b1, w2, b2, act):
    h = FB._act(act, TX.matmul(x, w1) + b1)
    return TX.matmul(h, w2) + b2


@pytest.mark.parametrize("residuals", [False, True])
@pytest.mark.parametrize("T,d,dq,dkv", [(17, 128, 192, 64),
                                        (150, 256, 256, 128)])
def test_qkv_arithmetic_matches_jax(T, d, dq, dkv, residuals):
    """The model of the 3xTF32 QKV within TOL of JAX's _qkv_reference in
    fp32, both variants (xn and inv in fp32, the cast point of x's
    dtype)."""
    rng = np.random.default_rng(T + d)
    x, wn = _np(rng, (T, d)), _np(rng, (d,), 0.5) + 1.0
    w = [_np(rng, (d, n), d ** -0.5) for n in (dq, dkv, dkv)]
    got = _qkv_model(*(torch.as_tensor(a) for a in (x, wn, *w)), residuals)
    ref = JFB._qkv_reference(jnp.asarray(x), jnp.asarray(wn),
                             *(jnp.asarray(a) for a in w), EPS,
                             residuals=residuals)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize("T,d,f", [(17, 128, 192), (150, 256, 320)])
def test_mlp_arithmetic_matches_jax(T, d, f):
    """The model of the 3xTF32 gated MLP (h = silu(g) u in fp32, never
    rounded further) within TOL of JAX's _mlp_gated_reference."""
    rng = np.random.default_rng(T + f)
    x = _np(rng, (T, d))
    wg, wu = (_np(rng, (d, f), d ** -0.5) for _ in range(2))
    wd = _np(rng, (f, d), f ** -0.5)
    got = _mlp_model(*(torch.as_tensor(a) for a in (x, wg, wu, wd)))
    _close(got, JFB._mlp_gated_reference(*(jnp.asarray(a) for a in
                                           (x, wg, wu, wd)), "silu"))


@pytest.mark.parametrize("act", ["relu", "gelu", "silu"])
@pytest.mark.parametrize("T,d,f", [(17, 128, 192), (150, 320, 256)])
def test_ffn_arithmetic_matches_jax(T, d, f, act):
    """The model of the 3xTF32 fused_ffn (the fp32 bias and activation on
    the up product's sums, b2 on the down product's) within TOL of JAX's
    _ffn_reference."""
    rng = np.random.default_rng(T + d + len(act))
    x = _np(rng, (T, d))
    w1, w2 = _np(rng, (d, f), d ** -0.5), _np(rng, (f, d), f ** -0.5)
    b1, b2 = _np(rng, (f,), 0.5), _np(rng, (d,), 0.5)
    got = _ffn_model(*(torch.as_tensor(a) for a in (x, w1, b1, w2, b2)), act)
    _close(got, JFB._ffn_reference(*(jnp.asarray(a) for a in
                                     (x, w1, b1, w2, b2)), act))


@pytest.mark.parametrize("M,K,N,seed", [(64, 512, 64, 0), (32, 1024, 96, 1),
                                        (48, 4096, 32, 2)])
def test_error_against_float64(M, K, N, seed):
    """Against a float64 product of the same fp32 operands: 3xTF32's
    largest error within TF32X3_F64_FACTOR times a plain fp32 product's,
    one TF32 pass's far past it."""
    rng = np.random.default_rng(seed)
    a = torch.as_tensor(_np(rng, (M, K)))
    b = torch.as_tensor(_np(rng, (K, N), K ** -0.5))
    ref = a.double() @ b.double()

    def err(c):
        return float((c.double() - ref).abs().max())
    e32, e3, e1 = err(a @ b), err(TX.matmul(a, b)), err(TX.one_pass(a, b))
    assert e3 <= FB.TF32X3_F64_FACTOR * e32, (e3, e32)
    assert e1 > FB.TF32X3_F64_FACTOR * e32, (e1, e32)
    assert e1 > 10 * e3


# -- a model of the kernels' tiles --------------------------------------------

def _band():
    """The row tiles of a band of the 3xTF32 walk (kTf32Band, which
    -DPTT_TF32_BAND may override; 4 where it does not)."""
    src = _src("fused_block.cu")
    assert "constexpr int kTf32Band = PTT_TF32_BAND;" in src
    return int(re.search(r"#define PTT_TF32_BAND (\d+)", src).group(1))


def _band_tile(t, row_tiles, col_tiles, band):
    """hopper_gemm.cuh's band_tile: column-major inside bands of `band`
    row tiles."""
    per = band * col_tiles
    first = t // per * band
    rows_in = min(band, row_tiles - first)
    return first + t % per % rows_in, t % per // rows_in


def _gemm_tiles(a, bt, T, widths, boffs, bm, on, blocks, gated=False):
    """The persistent walk of tf32x3_gemm_kernel over split A [T, K] and
    split B^T [rows, K] (each a (hi, lo) pair), 128 rows of B^T a tile:
    block b takes tiles b, b + blocks, ...; a tile's rows past T and B^T's
    rows past the end read zeros (TMA's fill), a column tile lies inside
    one part, stores are masked past T and past the part.  Gate/up: a
    tile's columns 0..63 are g and 64..127 u of its `on` = 64 outputs,
    whose h = silu(g) u it stores.  Returns each part's [T, n]."""
    K = a[0].shape[1]

    def box(m, r0, rows):
        out = torch.zeros((rows, K))
        r1 = min(r0 + rows, m.shape[0])
        if r1 > r0:
            out[:r1 - r0] = m[r0:r1]
        return out
    tiles = [-(-n // on) for n in widths]
    row_tiles, col_tiles = -(-T // bm), sum(tiles)
    outs = [torch.full((T, n), float("nan")) for n in widths]
    for b in range(blocks):
        for t in range(b, row_tiles * col_tiles, blocks):
            rt, ct = _band_tile(t, row_tiles, col_tiles, _band())
            part = 0
            while part < len(widths) - 1 and ct >= tiles[part]:
                ct -= tiles[part]
                part += 1
            m0, n0 = rt * bm, ct * on
            ah, al = (box(h, m0, bm) for h in a)
            bh, bl = (box(h, boffs[part] + ct * 128, 128).t() for h in bt)
            acc = TX.products(ah, al, bh, bl)
            if gated:
                g, u = acc[:, :64], acc[:, 64:]
                acc = (g * torch.sigmoid(g)) * u
            r, c = min(bm, T - m0), min(on, widths[part] - n0)
            outs[part][m0:m0 + r, n0:n0 + c] = acc[:r, :c]
    return outs


@pytest.mark.parametrize("blocks", [1, 3])
@pytest.mark.parametrize("T,d,dq,dkv", [(17, 64, 192, 64),
                                        (150, 128, 128, 128)])
def test_qkv_tiles_cover_every_output_once(T, d, dq, dkv, blocks):
    """QKV's GEMM over W^T split in one [dq + 2 dkv, d] workspace (q at
    row 0, k at dq, v at dq + dkv), 64-row tiles of 128 columns, a part's
    last tile partial (its columns read the next part's rows or TMA's
    zeros, and are not stored): every output written, equal to the
    model's products."""
    rng = np.random.default_rng(T + dq)
    xn = torch.as_tensor(_np(rng, (T, d)))
    w = [torch.as_tensor(_np(rng, (d, n), d ** -0.5)) for n in (dq, dkv, dkv)]
    wt = torch.cat([t.t() for t in w])
    nc, on = TX.gemm_tile(T, (dq, dkv, dkv), False, 10 ** 6)
    got = _gemm_tiles(TX.split(xn), TX.split(wt), T, (dq, dkv, dkv),
                      (0, dq, dq + dkv), 64 * nc, on, blocks)
    for g, wp in zip(got, w):
        assert not g.isnan().any()
        _close(g, TX.matmul(xn, wp), (1e-6, 1e-6))


@pytest.mark.parametrize("T,d,f", [(17, 64, 192), (150, 128, 320)])
def test_mlp_tiles_write_h_halves_and_y(T, d, f):
    """Gate/up over W1^T with the gate's and the up's rows interleaved in
    groups of 64 (gate_up_rows), a tile 64 outputs, h = silu(g) u split in
    the epilogue into the down product's operands, then the down product's
    128-column tiles (d = 320 ends in a partial one): y equal to the
    model's."""
    rng = np.random.default_rng(T + f + 1)
    x = torch.as_tensor(_np(rng, (T, d)))
    wg, wu = (torch.as_tensor(_np(rng, (d, f), d ** -0.5)) for _ in range(2))
    wd = torch.as_tensor(_np(rng, (f, d), f ** -0.5))
    wt = torch.zeros((2 * f, d))
    wt[TX.gate_up_rows(f)] = torch.cat([wg.t(), wu.t()])
    (h,) = _gemm_tiles(TX.split(x), TX.split(wt), T, (f,), (0,), 128, 64, 2,
                       gated=True)
    (y,) = _gemm_tiles(TX.split(h), TX.split(wd.t()), T, (d,), (0,), 64,
                       128, 2)
    _close(y, _mlp_model(x, wg, wu, wd), (1e-6, 1e-6))


def test_gate_up_rows_agree_with_the_kernel_source():
    """The split's row map (column n of a part to row (n / group) * stride
    + n % group) with gate/up's groups of 64 every 128 rows, the up's
    destination 64 rows on: every row of W1^T's 2 f taken once, and a
    128-row tile's first half the gate's columns, its second the up's."""
    hdr = _src("tf32x3.cuh")
    assert "((size_t)(n / p.group[part]) * p.stride[part] + n % " \
        "p.group[part]) * K +" in " ".join(hdr.split())
    src = _body(_src("fused_block.cu"), "int mlp_tf32x3(")
    for line in ("st.hi[i] = down ? w2_hi : w1_hi + (size_t)i * 64 * d;",
                 "st.group[i] = 64;", "st.stride[i] = 128;"):
        assert line in src, line
    f = 320
    rows = TX.gate_up_rows(f)
    assert sorted(rows.tolist()) == list(range(2 * f))
    for ct in range(f // 64):
        tile = rows.tolist()
        assert [tile.index(128 * ct + r) for r in range(64)] == \
            list(range(64 * ct, 64 * ct + 64))
        assert [tile.index(128 * ct + 64 + r) for r in range(64)] == \
            list(range(f + 64 * ct, f + 64 * ct + 64))


# -- routing, shared memory and workspaces against the kernel source ---------

def test_paths_route_fp32_past_16_rows_to_tf32x3():
    """fp32 at ROW_PASS_MIN_T rows or more takes tf32x3 (QKV's two
    variants, the MLP, fused_ffn) and the tile below; bf16 is unmoved;
    GEMM_PATHS names common.cuh's Design values in their order."""
    fp, bf = torch.float32, torch.bfloat16
    t = FB.ROW_PASS_MIN_T
    assert t == 17
    assert [FB.gemm_path(n, fp) for n in (1, 16, 17, 8192)] == \
        ["tile", "tile", "tf32x3", "tf32x3"]
    for res in (False, True):
        assert [FB.qkv_path(n, fp, res) for n in (16, 17, 8192)] == \
            ["tile", "tf32x3", "tf32x3"]
    assert [FB.gemm_path(n, bf) for n in (16, 17, 8192)] == \
        ["splitk", "wgmma", "wgmma"]
    assert [FB.qkv_path(n, bf, True) for n in (16, 17)] == ["tile", "wgmma"]
    codes = dict(re.findall(r"DESIGN_(\w+) = (\d+)", _src("common.cuh")))
    assert sorted(codes, key=lambda k: int(codes[k])) == \
        [p.upper() for p in FB.GEMM_PATHS]
    assert FB.GEMM_PATHS[-1] == "tf32x3"


def test_entries_route_fp32_to_the_tf32x3_kernels():
    """ptt_rmsnorm_qkv and ptt_mlp send fp32 at kRowPassMinT rows or
    more to the 3xTF32 functions and report DESIGN_TF32X3; those launch
    the weight split, the row pass with xn's halves (QKV) or x's split
    (the MLP), and the GEMM on tf32x3.cuh's ring, whose slots sum their
    products in the model's order from zero (the first product's scale-d
    0) and add the sum to the totals once the group is done; fp32 below
    keeps the tile."""
    src = _src("fused_block.cu")
    qkv = _body(src, "int ptt_rmsnorm_qkv(")
    assert ("if (dtype == ptt::DT_FLOAT32 && T >= kRowPassMinT) {"
            in qkv) and "qkv_tf32x3(" in qkv
    assert qkv.index("DT_FLOAT32 && T >= kRowPassMinT") < \
        qkv.index("launch<MODE_QKV>")
    assert "ptt::DESIGN_TF32X3" in qkv
    mlp = _body(src, "int ptt_mlp(int dtype,")
    assert ("} else if (dtype == ptt::DT_FLOAT32 && T >= kRowPassMinT) {"
            in mlp)
    assert "mlp_tf32x3(" in mlp and "used = ptt::DESIGN_TF32X3;" in mlp
    q = _body(src, "int qkv_tf32x3(")
    assert q.index("split_t(st, stream)") < \
        q.index("qkv_rows_kernel<float, true>") < \
        q.index("tf32x3_gemm<MODE_QKV, 0>")
    m = _body(src, "int mlp_tf32x3(")
    assert m.index("split_t(st, stream)") < m.index("tf32x3::split(") < \
        m.index("tf32x3_gemm<MODE_GATEUP, 0>") < \
        m.index("tf32x3_gemm<MODE_PLAIN, 0>")
    kern = _body(src, "tf32x3_gemm_kernel(const __grid_constant__")
    assert "tf32_split(v[0], hi.x, lo.x);" in kern
    hdr = _src("tf32x3.cuh")
    slot = _body(hdr, "__device__ __forceinline__ void tf32_slot(")
    assert [ln.strip() for ln in slot.splitlines()
            if ln.strip().startswith("tf32_mma")] == \
        ["tf32_mma<BN>(part, dal, dbh, kk > 0);",
         "tf32_mma<BN>(part, dah, dbl);", "tf32_mma<BN>(part, dah, dbh);"]
    consume = _body(hdr, "__device__ __forceinline__ void tf32_consume(")
    assert consume.index("wgmma_wait<0>();") < \
        consume.index("acc[i] += part[i];")


@pytest.mark.parametrize("nc", [1, 2])
def test_rings_fit_shared_memory(nc):
    """Each ring the entries instantiate (128 columns of B^T, one or two
    consumer warpgroups): 1024-byte aligned boxes, three or four slots,
    within the 227 KB a block may use; a second B operand (gate and up
    side by side) would leave two, which is why the pre-pass interleaves
    them instead."""
    p = TX.plan(nc)
    assert p["A_BYTES"] % 1024 == 0 and p["B_BYTES"] % 1024 == 0
    assert p["STAGE_BYTES"] == 2 * 64 * nc * 128 + 2 * 128 * 128
    assert p["SMEM"] <= MAX_SMEM
    assert p["STAGES"] == (4 if nc == 1 else 3)
    assert RING_BYTES // (p["STAGE_BYTES"] + 2 * 128 * 128) == 2


@pytest.mark.parametrize("T,sms", [(17, 132), (256, 132), (8192, 132),
                                   (1024, 8)])
def test_gemm_tile_agrees_with_the_kernel_source(T, sms):
    """tf32x3_gemm's choice: 64 outputs a tile for gate/up and 128
    otherwise (128 columns of B^T either way); 128-row tiles where (T +
    127) / 128 row tiles over the parts' column tiles give each SM one.
    At Llama-3-8B width and T = 8192 every product takes 128 rows; a
    down product of 4096 columns at T = 17, 64."""
    assert _band() == 4
    kern = _body(_src("fused_block.cu"), "tf32x3_gemm_kernel(const __grid")
    assert "band_tile(t, p.row_tiles, p.col_tiles, kTf32Band, rt, ct);" \
        in kern
    src = _body(_src("fused_block.cu"), "int tf32x3_gemm(Tf32Params& p,")
    assert "constexpr int ON = MODE == MODE_GATEUP ? 64 : 128;" in src
    assert "if ((p.T + 127) / 128 * cols >= ptt::hopper::sm_count())" in src
    assert "launch_tf32x3<2, MODE, ACT>" in src
    assert "launch_tf32x3<1, MODE, ACT>" in src
    for widths, gated in (((4096, 1024, 1024), False), ((14336,), True),
                          ((4096,), False)):
        nc, on = TX.gemm_tile(T, widths, gated, sms)
        cols = sum(-(-n // on) for n in widths)
        assert on == (64 if gated else 128)
        assert nc == (2 if (T + 127) // 128 * cols >= sms else 1)
        if T == 8192:
            assert nc == 2
    assert TX.gemm_tile(17, (4096,), False, 132) == (1, 128)


def test_workspaces_agree_with_the_kernel_source():
    """The split operands' buffers the wrappers allocate for a call are
    the C entries' sizes: QKV's W^T halves of q | k | v and xn's halves;
    the MLP's W1^T (and Wu^T), W2^T, x's and h's halves.  At Llama-3-8B
    width and T = 8192: 0.47 GB and 2.62 GB."""
    src = _src("fused_block.cu")
    assert "return 2LL * (dq + 2 * dkv) * d + 2LL * T * d;" in src
    assert "return 2LL * (gated ? 3 : 2) * f * d + 2LL * T * (d + f);" in src
    assert "ws_floats < mlp_tf32x3_floats(T, d, f, gated)" in src
    assert FB.tf32x3_qkv_floats(8192, 4096, 4096, 1024) * 4 == 469762048
    assert FB.tf32x3_mlp_floats(8192, 4096, 14336, True) * 4 == 2617245696
    assert FB.tf32x3_mlp_floats(16, 64, 64, False) == \
        2 * 2 * 64 * 64 + 2 * 16 * 128
    wrapper = Path(FB.__file__).read_text()
    assert "torch.empty(tf32x3_qkv_floats(T, d, dq, dkv)," in wrapper
    assert "floats = tf32x3_mlp_floats(T, d, f, wu is not None)" in wrapper


@pytest.mark.parametrize("T", [16, 17, 150])
def test_cpu_tensors_take_the_plain_versions(T):
    """On the CPU the fp32 wrappers return their plain versions exactly
    and count no launch, whatever the row count."""
    rng = np.random.default_rng(T)
    d, f = 64, 128
    x = torch.as_tensor(_np(rng, (T, d)))
    wn = torch.as_tensor(_np(rng, (d,), 0.5) + 1.0)
    w = [torch.as_tensor(_np(rng, (d, d), d ** -0.5)) for _ in range(3)]
    w1, wu = (torch.as_tensor(_np(rng, (d, f), d ** -0.5)) for _ in range(2))
    w2 = torch.as_tensor(_np(rng, (f, d), f ** -0.5))
    n = (FB.fused_rmsnorm_qkv.launches, FB.fused_mlp.launches,
         FB.fused_ffn.launches)
    for g, r in zip(FB.fused_rmsnorm_qkv(x, wn, *w, EPS, residuals=True),
                    FB.qkv_reference(x, wn, *w, EPS, residuals=True)):
        assert torch.equal(g, r)
    assert torch.equal(FB.fused_mlp(x, w1, wu, w2),
                       FB.mlp_reference(x, w1, wu, w2))
    assert torch.equal(FB.fused_ffn(x, w1, w2, activation="gelu"),
                       FB.ffn_reference(x, w1, torch.zeros(f), w2,
                                        torch.zeros(d), "gelu"))
    assert (FB.fused_rmsnorm_qkv.launches, FB.fused_mlp.launches,
            FB.fused_ffn.launches) == n
