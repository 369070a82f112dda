"""The arithmetic of the Hopper decoder block and grouped expert FFN, on
the CPU, against the JAX package on the same inputs.

In bf16 the whole-block decoder (``csrc/fused_decoder.cu``,
decoder_hopper) and the grouped expert FFN (``csrc/grouped_matmul.cu``,
grouped_hopper) run on the wgmma / TMA ring, only on the card.  What they
compute is modelled here: the q | k | v epilogue that takes RoPE in
wgmma's accumulator layout, the block's phase order tile by tile, and the
grouped walk that skips row tiles past each group's count; each model is
held against the JAX package (``_rope_ref``, ``_decoder_reference``, the
Pallas ``_grouped_kernel`` in interpret mode) and the port's plain
versions.  The tile shapes and the phase list are read from the sources.
Inputs come from numpy with a fixed seed; each test states its
tolerance."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.nn.functional.attention import rotary_freqs as jrotary
from paddle_tpu.ops.pallas import fused_block as JFB
from paddle_tpu.ops.pallas import grouped_matmul as JGM

from paddle_tpu_torch.ops.kernels import fused_block as FB
from paddle_tpu_torch.ops.kernels import grouped_matmul as GM

CSRC = Path(FB.__file__).resolve().parent / "csrc"
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
EPS = 1e-5


def _both(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    t = torch.from_numpy(a).to(dtype)
    return jnp.asarray(t.float().numpy()).astype(JDT[dtype]), t


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-6)


# -- (a) the q | k | v epilogue: RoPE in wgmma's accumulator layout ----------

def fragment_map(bn):
    """wgmma's m64nNk16 accumulator layout (``hopper.cuh``): ``[128,
    bn // 2]`` row and column of fragment entry ``4 i + 2 h + e`` of
    thread ``t`` of a warpgroup (warp ``t // 32``, lane ``t % 32``): row
    ``16 w + l // 4 + 8 h``, column ``8 i + 2 (l % 4) + e``."""
    t = np.arange(128)[:, None]
    idx = np.arange(bn // 2)[None, :]
    i, h, e = idx // 4, idx % 4 // 2, idx % 2
    w, lane = t // 32, t % 32
    return 16 * w + lane // 4 + 8 * h, 8 * i + 2 * (lane % 4) + e


@pytest.mark.parametrize("bn", [128, 256])
def test_fragment_map_pairs_each_column_with_its_rotation_partner(bn):
    """Every row and column of a 64 x bn tile is held once, and the thread
    that holds column j of a 128-column head (j < 64) holds column j + 64
    of the same row at entry + 32 (i + 8): the rotation needs no other
    thread."""
    rows, cols = fragment_map(bn)
    held = np.zeros((64, bn), int)
    np.add.at(held, (rows, cols), 1)
    assert (held == 1).all()
    first = cols % 128 < 64
    ent = np.nonzero(first)
    assert (cols[ent[0], ent[1] + 32] == cols[ent] + 64).all()
    assert (rows[ent[0], ent[1] + 32] == rows[ent]).all()


def rope_epilogue_model(acc, cos, sin, pos, dtype):
    """store_qkv of one 128-row tile (two consumer warpgroups), thread by
    thread: each thread's fp32 fragment cast to `dtype` once; for entry
    ``a`` of a head's first half and its partner ``a + 32``, RoPE in fp32
    with every product and sum rounded on its own (no fused multiply-add:
    ``__fmul_rn``, ``__fsub_rn``, ``__fadd_rn``); cast again.  acc
    ``[128, bn]`` fp32, pos ``[128]`` positions, cos / sin ``[s, 64]``
    fp32.  Returns the ``[128, bn]`` tile in `dtype`."""
    bn = acc.shape[1]
    rows, cols = fragment_map(bn)
    out = torch.empty(acc.shape, dtype=dtype)
    for c in range(2):                                # consumer warpgroups
        r = torch.from_numpy(rows + 64 * c)
        col = torch.from_numpy(cols)
        frag = acc[r, col].to(dtype).float()          # [128 threads, bn/2]
        res = frag.clone()
        for a in range(bn // 2):
            if cols[0, a] % 128 >= 64:
                continue
            x1, x2 = frag[:, a], frag[:, a + 32]
            j = col[:, a] % 128
            cs = cos[pos[r[:, a]], j]
            sn = sin[pos[r[:, a]], j]
            res[:, a] = torch.sub(torch.mul(x1, cs), torch.mul(x2, sn))
            res[:, a + 32] = torch.add(torch.mul(x2, cs), torch.mul(x1, sn))
        out[r, col] = res.to(dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bn,s", [(256, 64), (256, 384), (128, 100)])
def test_rope_epilogue_equals_rope_ref_bitwise(dtype, bn, s):
    """The epilogue model against JAX's ``_rope_ref`` of the cast product
    (``[1, 128, heads, 128]`` with the tables' rows at each row's
    position, row % s: a tile of 128 rows wraps a sequence of 64 and
    starts mid-sequence at s = 100): equal bit for bit."""
    rng = np.random.default_rng(bn + s)
    acc = torch.from_numpy(rng.standard_normal((128, bn)).astype(np.float32))
    jcos, jsin = jrotary(128, 512, base=500000.0)
    cos = torch.from_numpy(np.array(jcos))
    sin = torch.from_numpy(np.array(jsin))
    m0 = 256 if s == 100 else 0
    pos = (m0 + torch.arange(128)) % s
    got = rope_epilogue_model(acc, cos, sin, pos, dtype)
    q = jnp.asarray(acc.numpy()).astype(JDT[dtype]).reshape(128, 1, bn // 128,
                                                            128)
    ref = JFB._rope_ref(q.transpose(1, 0, 2, 3), jcos[np.asarray(pos)],
                        jsin[np.asarray(pos)])
    ref = _np(ref.transpose(1, 0, 2, 3)).reshape(128, bn)
    assert np.array_equal(got.float().numpy(), ref)
    # and the port's plain RoPE
    plain = FB._rope_ref(acc.to(dtype).reshape(1, 128, bn // 128, 128),
                         cos[pos], sin[pos])
    assert torch.equal(plain.reshape(128, bn), got)


# -- (b) the block's phase order, tile by tile --------------------------------

def _tiled(a, w, bn):
    """a @ w in column tiles of `bn` (the last zero-padded, as TMA fills
    it), fp32 sums over 64-deep slices: the ring's products; fp32 out."""
    n = w.shape[1]
    wp = torch.zeros((w.shape[0], -(-n // bn) * bn))
    wp[:, :n] = w.float()
    out = []
    for c in range(0, wp.shape[1], bn):
        acc = torch.zeros((a.shape[0], bn))
        for k in range(0, a.shape[1], 64):
            acc = acc + a[:, k:k + 64].float() @ wp[k:k + 64, c:c + bn]
        out.append(acc)
    return torch.cat(out, 1)[:, :n]


def _norm(x, w):
    """The fused-form norm of the block's row phases: fp32 statistics,
    (x * inv) * w in fp32, one cast."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + EPS)
    return ((xf * inv) * w.float()).to(x.dtype)


def _rope(t, cos, sin, pos):
    """store_qkv's RoPE on a cast [T, heads * 128] part, in fp32 (the
    epilogue model's arithmetic, vectorised)."""
    T = t.shape[0]
    x = t.float().reshape(T, -1, 128)
    x1, x2 = x[..., :64], x[..., 64:]
    c, s = cos[pos][:, None, :], sin[pos][:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).reshape(
        T, -1).to(t.dtype)


def _flash_items(q, k, v, scale):
    """flash_hopper.cuh's forward, item by item: q tiles of 128 rows,
    64-key blocks up to the diagonal, scores times scale * log2 e, the
    running max and sum in fp32, P cast to v's type, out = O / l cast."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    out = torch.zeros_like(q)
    s2 = scale * 1.4426950408889634
    for bb in range(b):
        for hh in range(h):
            kh = hh // (h // hk)
            for q0 in range(0, s, 128):
                rows = torch.arange(q0, min(q0 + 128, s))
                qt = q[bb, rows, hh].float()
                m = torch.full((len(rows),), -float("inf"))
                l = torch.zeros(len(rows))
                o = torch.zeros((len(rows), d))
                for k0 in range(0, min(q0 + 128, s), 64):
                    kt = k[bb, k0:k0 + 64, kh].float()
                    sc = (qt @ kt.T) * s2
                    keys = torch.arange(k0, k0 + 64)
                    sc = sc.masked_fill(keys[None, :] > rows[:, None],
                                        -float("inf"))
                    mn = torch.maximum(m, sc.max(1).values)
                    base = torch.where(mn == -float("inf"), 0.0, mn)
                    corr = torch.exp2(m - base)
                    p = torch.exp2(sc - base[:, None])
                    l = l * corr + p.sum(1)
                    o = o * corr[:, None] + p.to(v.dtype).float() @ \
                        v[bb, k0:k0 + 64, kh].float()
                    m = mn
                out[bb, rows, hh] = (o / torch.where(l > 0, l, 1)[:, None]
                                     ).to(q.dtype)
    return out


def block_model(x, wn1, wq, wk, wv, cos, sin, wo, wn2, wg, wu, wd, nh, nkvh):
    """decoder_hopper's phases in order: norm1; q | k | v in 256-column
    tiles, cast, RoPE, cast; attention by items; o-projection in
    256-column tiles cast, x2 = x + it in the io type; norm2; gate/up in
    128-column tiles of each weight, h = silu(g) * u from fp32, cast; the
    down product in 256-column tiles cast, y = x2 + it."""
    b, s, d = x.shape
    dt = x.dtype
    x2d = x.reshape(-1, d)
    pos = torch.arange(b * s) % s
    xn = _norm(x2d, wn1)
    q = _rope(_tiled(xn, wq, 256).to(dt), cos, sin, pos)
    k = _rope(_tiled(xn, wk, 256).to(dt), cos, sin, pos)
    v = _tiled(xn, wv, 256).to(dt)
    o = _flash_items(q.reshape(b, s, nh, 128), k.reshape(b, s, nkvh, 128),
                     v.reshape(b, s, nkvh, 128), 0.08838834764831845)
    x2 = x2d + _tiled(o.reshape(b * s, -1), wo, 256).to(dt)
    xn = _norm(x2, wn2)
    g, u = _tiled(xn, wg, 128), _tiled(xn, wu, 128)
    h = ((g * (1 / (1 + torch.exp(-g)))) * u).to(dt)
    return (x2 + _tiled(h, wd, 256).to(dt)).reshape(b, s, d)


@pytest.mark.parametrize("dtype,limit", [(torch.float32, 1e-4),
                                         (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,s,nh,nkvh", [(2, 64, 2, 2), (1, 64, 4, 1),
                                         (1, 384, 2, 2), (1, 384, 4, 1)])
def test_block_model_matches_decoder_reference(dtype, limit, b, s, nh, nkvh):
    """The phase model at s = 64 (one q tile, half of it past s) and 384
    (a last q tile of 128; the diagonal inside a tile), GQA rep 1 and 4
    (dkv = 128: a 256-column tile half past k and v), d 256, f 384 (a
    partial gate/up tile of 256 is whole at 128): against JAX's
    ``_decoder_reference`` and the port's ``decoder_reference``, as a
    share of the output's largest magnitude: fp32 sums in another order
    (1e-4); bf16 both sides round at the same cast points, and a step
    flipped by another order carries through the block (3e-2, the card
    test's limit)."""
    d, f = 256, 384
    rng = np.random.default_rng(s + 10 * nh + b)
    w = {n: _both(rng, shape, dtype, sc) for n, shape, sc in (
        ("x", (b, s, d), 1.0), ("wn1", (d,), 1.0),
        ("wq", (d, nh * 128), 0.05), ("wk", (d, nkvh * 128), 0.05),
        ("wv", (d, nkvh * 128), 0.05), ("wo", (nh * 128, d), 0.05),
        ("wn2", (d,), 1.0), ("wg", (d, f), 0.05), ("wu", (d, f), 0.05),
        ("wd", (f, d), 0.05))}
    jcos, jsin = jrotary(128, s)
    cos, sin = torch.from_numpy(np.array(jcos)), torch.from_numpy(
        np.array(jsin))
    names = ("x", "wn1", "wq", "wk", "wv", "wo", "wn2", "wg", "wu", "wd")
    j = {n: w[n][0] for n in names}
    t = {n: w[n][1] for n in names}
    got = block_model(t["x"], t["wn1"], t["wq"], t["wk"], t["wv"], cos, sin,
                      t["wo"], t["wn2"], t["wg"], t["wu"], t["wd"], nh, nkvh)
    ref = JFB._decoder_reference(j["x"], j["wn1"], j["wq"], j["wk"], j["wv"],
                                 jcos, jsin, j["wo"], j["wn2"], j["wg"],
                                 j["wu"], j["wd"], eps=EPS, nh=nh, nkvh=nkvh)
    assert got.dtype == dtype
    assert _rel(got.float().numpy(), _np(ref)) < limit
    plain = FB.decoder_reference(t["x"], t["wn1"], t["wq"], t["wk"], t["wv"],
                                 cos, sin, t["wo"], t["wn2"], t["wg"],
                                 t["wu"], t["wd"], nh, nkvh, EPS)
    assert _rel(got.float().numpy(), plain.float().numpy()) < limit


# -- (c) the grouped walk with count skips ------------------------------------

def grouped_walk(G, C, N, bn, counts, live):
    """grouped_hopper's walk: the live row tiles of each group (those
    with a routed row) or the dead ones, group after group, column-major
    inside a group's row tiles: the list of (group, first row, first
    column)."""
    rt, ct = -(-C // 128), -(-N // bn)
    tiles = []
    for g in range(G):
        n = -(-min(max(int(counts[g]), 0), C) // 128)
        first, rows = (0, n) if live else (n, rt - n)
        tiles += [(g, (first + i % rows) * 128, i // rows * bn)
                  for i in range(rows * ct)]
    return tiles


def grouped_launch(G, C, N, bn, counts, blocks, mode):
    """What each block of a persistent launch stores: the live tiles b,
    b + blocks, ... (the producer loads them, the consumers store their
    rows below C, UP only those below the count), then in DOWN the dead
    tiles b, b + blocks, ... as zeros.  Returns how often each (group,
    row, column) was stored as a computed value and as a zero, and the
    live tiles of each block."""
    hits = np.zeros((G, C, N), int)
    zeros = np.zeros((G, C, N), int)
    live = grouped_walk(G, C, N, bn, counts, True)
    dead = grouped_walk(G, C, N, bn, counts, False)
    share = [len(live[b::blocks]) for b in range(blocks)]
    for b in range(blocks):
        for tiles, computed in ((live[b::blocks], True),
                                (dead[b::blocks] if mode == "down" else [],
                                 False)):
            for g, m0, n0 in tiles:
                cnt = min(max(int(counts[g]), 0), C)
                r = np.arange(m0, min(m0 + 128, C))
                cols = slice(n0, min(n0 + bn, N))
                if computed:
                    hits[g, r[r < cnt], cols] += 1
                    if mode == "down":
                        zeros[g, r[r >= cnt], cols] += 1
                else:
                    zeros[g, r, cols] += 1
    return hits, zeros, share


@pytest.mark.parametrize("C", [100, 960])
@pytest.mark.parametrize("bn,blocks", [(128, 3), (256, 132)])
def test_grouped_walk_covers_each_routed_row_once(C, bn, blocks):
    """Counts 0, C, a partial count and C - 1, rep 2 (G = 8): UP computes
    every row below each count exactly once and stores no row past it;
    DOWN stores every row below C once, as computed below the count and
    zero past it; every block gets as many live tiles as any other, give
    or take one."""
    G, N = 8, 320
    pattern = [0, C, C // 2 + 3, C - 1]
    counts = [pattern[g % 4] for g in range(G)]
    below = np.arange(C)[None, :] < np.asarray(counts)[:, None]
    for mode in ("up", "down"):
        hits, zeros, share = grouped_launch(G, C, N, bn, counts, blocks,
                                            mode)
        assert (hits == below[..., None]).all()
        if mode == "down":
            assert (zeros == ~below[..., None]).all()
        else:
            assert not zeros.any()
        assert max(share) - min(share) <= 1


def grouped_model(x, w1, b1, w2, b2, counts, bn):
    """The two launches' arithmetic, 128-row tile by tile: a tile whose
    first row is at or past the group's count is skipped; the others are
    computed whole (rows past the count included).  UP stores h =
    cast(gelu(x @ w1 + b1)) from fp32 (the bias in fp32, the exact-erf
    gelu) for rows below the count and leaves the rest of the hidden as
    it was (NaN here: memory never written); DOWN stores y = cast(h @ w2
    + b2) below the count and zero past it.  Products in column tiles of
    `bn` over 64-deep slices."""
    G, C, d = x.shape
    E, _, hd = w1.shape
    rep = G // E
    hid = torch.full((G, C, hd), float("nan")).to(x.dtype)
    y = torch.zeros_like(x)
    for g in range(G):
        e, cnt = g // rep, min(max(int(counts[g]), 0), C)
        for m0 in range(0, cnt, 128):
            r = slice(m0, min(m0 + 128, C))
            keep = torch.arange(C)[r] < cnt
            u = _tiled(x[g, r], w1[e], bn) + b1[e].float()
            h = (0.5 * u * torch.erfc(-u * 0.70710678118654752)).to(x.dtype)
            hid[g, r][keep] = h[keep]
        for m0 in range(0, C, 128):
            r = slice(m0, min(m0 + 128, C))
            if m0 >= cnt:
                continue                       # the tile's zeros
            out = (_tiled(hid[g, r], w2[e], bn) + b2[e].float()).to(x.dtype)
            keep = (torch.arange(C)[r] < cnt)[:, None]
            y[g, r] = torch.where(keep, out, torch.zeros((), dtype=x.dtype))
    return y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [100, 960])
def test_grouped_model_matches_pallas(dtype, C):
    """G = 4, E = 2 (rep 2), d 64, h 192 (a partial last column tile of
    128), counts 0, C, partial and C - 1, a NaN in an unrouted row of x:
    the model against ``_grouped_kernel`` in interpret mode (the exact
    gelu ``ExpertFFN`` passes) and the port's plain version; rows past
    the counts exactly zero, every output finite.  fp32 within 1e-5;
    bf16 within one bf16 step (2^-7 of the value) plus 1e-2 (the
    card's GROUPED_TOL: a hidden element flipped to the other side of a
    bf16 step by another summation order)."""
    G, E, d, h = 4, 2, 64, 192
    rng = np.random.default_rng(C + len(str(dtype)))
    jx, x = _both(rng, (G, C, d), dtype)
    j1, w1 = _both(rng, (E, d, h), dtype, d ** -0.5)
    jb1, b1 = _both(rng, (E, h), dtype, 0.1)
    j2, w2 = _both(rng, (E, h, d), dtype, h ** -0.5)
    jb2, b2 = _both(rng, (E, d), dtype, 0.1)
    counts = np.asarray([0, C, C // 2 + 3, C - 1], np.int32)
    xn = x.clone()
    xn[2, C // 2 + 3:] = float("nan")       # unrouted rows reach nothing
    got = grouped_model(xn, w1, b1, w2, b2, counts, 128)
    act = functools.partial(jax.nn.gelu, approximate=False)
    ref = JGM.grouped_expert_ffn(jx, j1, jb1, j2, jb2,
                                 counts=jnp.asarray(counts), act=act,
                                 interpret=True)
    plain = GM.grouped_expert_ffn_reference(x, w1, b1, w2, b2,
                                            torch.from_numpy(counts))
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-2, 2 ** -7)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), _np(ref), atol=atol,
                               rtol=rtol)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               atol=atol, rtol=rtol)
    past = np.arange(C)[None, :] >= counts[:, None]
    assert not got.float().numpy()[past].any()


# -- (d) the tile shapes and the phase list, read from the sources -----------

def _body(src, start):
    """The text of the function whose definition starts at `start`, up
    to its closing brace at column 0."""
    i = src.index(start)
    return src[i:src.index("\n}\n", i)]


def _designs_agree_with_gemm_paths():
    """The C entries' design codes (csrc/common.cuh, enum Design) index
    GEMM_PATHS, which the wrappers count launches under."""
    src = (CSRC / "common.cuh").read_text()
    codes = dict(re.findall(r"DESIGN_(\w+) = (\d+)", src))
    assert {name.lower(): int(v) for name, v in codes.items()} == \
        {p: i for i, p in enumerate(FB.GEMM_PATHS)}


def test_block_phases_and_tiles_agree_with_the_kernel_source():
    """decoder_hopper's tiles are the models' (128 rows, 256 columns
    for q | k | v, o-proj and down, 128 of each weight for gate/up, one
    ring of 4 slots), RoPE pairs entry a with a + 32, and the consumers
    run the phases in block_model's order with a grid barrier after each
    but the last, the producer meeting the same six barriers; the flash
    phase walks items, the one-item flash kernel does not; bf16 takes
    this design and fp32 the first one, and the entry says which."""
    src = (CSRC / "fused_decoder.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert (consts["NC"], consts["WIDE"], consts["GU"], consts["STAGES"]) \
        == ("2", "256", "128", "4")
    assert "constexpr int TM = 64 * NC;" in src
    assert "const int a = 4 * (16 * hd + i) + 2 * hh, b = a + 32;" in src
    consume = _body(src, "__device__ __forceinline__ void consume(")
    steps = re.findall(r"(norm_rows<bf16>\(p\.\w+|store_qkv|ptt::fwd::consume|"
                       r"store_resid\(p, acc, p\.\w+|store_gateup|"
                       r"phase_barrier)", consume)
    assert steps == ["norm_rows<bf16>(p.x", "phase_barrier", "store_qkv",
                     "phase_barrier", "ptt::fwd::consume", "phase_barrier",
                     "store_resid(p, acc, p.x", "phase_barrier",
                     "norm_rows<bf16>(p.x2", "phase_barrier", "store_gateup",
                     "phase_barrier", "store_resid(p, acc, p.x2"]
    produce = _body(src, "__device__ __forceinline__ void produce(")
    assert produce.count("phase_barrier(grid);") == 6
    assert "return" not in produce     # every thread meets every barrier
    # the block walks flash items (WALK); the one-item flash forward
    # compiles none of the walk
    assert "ptt::fwd::consume<true>(" in consume and \
        "ptt::fwd::produce<true>(" in produce
    fa = (CSRC / "flash_attention.cu").read_text()
    assert "ptt::fwd::produce<false>(" in fa and \
        "ptt::fwd::consume<false>(" in fa
    # bf16 launches this design, fp32 the first one, and the entry
    # reports which (the wrappers' launches_by_path count it)
    entry = _body(src, "int ptt_fused_decoder(")
    assert re.sub(r"\s+", " ", entry).count(
        "if (dtype == ptt::DT_BFLOAT16) return ptt::launched(hop::launch(a, "
        "st), design, ptt::DESIGN_WGMMA); if (dtype == ptt::DT_FLOAT32) "
        "return ptt::launched(launch_fp32(a, st), design, "
        "ptt::DESIGN_TILE);") == 1
    _designs_agree_with_gemm_paths()


def test_grouped_tiles_agree_with_the_kernel_source():
    """grouped_hopper walks its tiles as grouped_walk does (the live, or
    the dead, row tiles of each group, column-major inside a group),
    picks 256 columns where every SM gets two tiles and 128 otherwise,
    and its producer and consumers walk the same live tiles; bf16 takes
    it, fp32 the first design."""
    src = (CSRC / "grouped_matmul.cu").read_text()
    assert "constexpr int TM = 64 * NC;" in src and \
        "constexpr int NC = 2;" in src
    walk = _body(src, "__device__ __forceinline__ bool walk(")
    assert "m0 = ((LIVE ? 0 : p.row_tiles - w.n) + in % w.n) * TM;" in walk
    assert "n0 = in / w.n * bn;" in walk
    assert "if (G * p.row_tiles * ((g.N + 255) / 256) >= " \
           "2 * ptt::hopper::sm_count())" in src
    # the producer and the consumers walk the same live tiles; DOWN's
    # consumers then the dead ones
    kernel = _body(src, "grouped_hopper(const __grid_constant__ Params p)")
    assert kernel.count("walk<true>(p, live, r, BN, g, m0, n0);") == 2
    assert kernel.count("walk<false>(p, dead, r, BN, g, m0, n0);") == 1
    assert re.sub(r"\s+", " ", src).count(
        "if (dtype == ptt::DT_BFLOAT16) return ptt::launched("
        "hop::launch<MODE>(g, G, s), design, ptt::DESIGN_WGMMA); if (dtype "
        "== ptt::DT_FLOAT32) return ptt::launched(launch_fp32<MODE>(g, G, "
        "s), design, ptt::DESIGN_TILE);") == 1
    _designs_agree_with_gemm_paths()
    assert grouped_walk(2, 200, 300, 128, [200, 0], True)[:3] == [
        (0, 0, 0), (0, 128, 0), (0, 0, 128)]
    assert grouped_walk(2, 200, 300, 128, [100, 0], False)[:3] == [
        (0, 128, 0), (0, 128, 128), (0, 128, 256)]
