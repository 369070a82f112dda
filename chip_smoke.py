#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. env      versions, the card, TF32 switched off for fp32 references.
2. build    nvcc builds the port's CUDA kernels from ``paddle_tpu_torch/
            ops/kernels/csrc`` (or finds them built).
3. kernels  every kernel of the serving path at the path's own shapes
            (Llama-3-8B widths: fused RMSNorm+QKV and fused SwiGLU MLP at
            T = 8 decode rows and T = 256 prefill rows; paged decode at
            B = 8, 32/8 heads, head_dim 128, block 16, lengths 1..1024)
            held against its plain PyTorch version in bf16 and fp32, and
            timed with CUDA events beside the plain version, one PyTorch
            library call computing the same function, and its bound.
4. parity   a 2-layer model at full Llama-3-8B width (bf16, seeded random
            weights) on the card against the same weights through the
            plain path (the CPU, fp32): the last prefill chunk's logits
            within a stated tolerance, and 8 greedy tokens.
5. serve    the full 32-layer Llama-3-8B in bf16 (random weights from a
            seeded generator) behind the paged ContinuousBatchingEngine:
            8 requests, prompts of 64..700 tokens, 32 new tokens each.
            Every request must end "ok" with 32 tokens, and every kernel's
            launch count must have grown during this run.  Then a short
            window under torch.profiler: device time by kernel and the
            device's busy share.

Then the kernels line, the card's name and power limit, and the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero without the last line; so it does where CUDA is
missing or the package is not beside it.  Imports nothing of JAX or of
``paddle_tpu``."""

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
D, DQ, DKV, F = 4096, 4096, 1024, 14336
EPS = 1e-5
# kernel vs plain version, (atol, rtol): fp32 differs by summation order
# only; bf16 outputs carry a final bf16 rounding (2^-8 relative) of fp32
# sums taken in another order, and bf16-rounded intermediates (xn, h)
TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (3e-2, 3e-2)}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of `fn` over `iters` launches, CUDA events around
    each launch; a 256 MB write before each evicts the 50 MB L2, so the
    weights come from device memory as they do in the model, where every
    layer reads its own."""

    def __init__(self, dev):
        self.scrub = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def __call__(self, fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.scrub.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound_ms(nbytes, flops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOP_PER_S * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def check_close(what, got, ref, dtype):
    atol, rtol = TOL[dtype]
    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    bad = (g - r).abs() > atol + rtol * r.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what} [{dtype}]: {int(bad.sum())} elements "
                             f"outside atol={atol} rtol={rtol}; max abs "
                             f"err {err}")
    return err


def rand(g, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


# -- phase 3: the kernels at the path's shapes -------------------------------

def kernel_qkv(FB, dev, timer, T):
    g = torch.Generator(device=dev).manual_seed(T)
    errs, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = rand(g, (T, D), dtype, dev)
        wn = rand(g, (D,), dtype, dev, 0.1) + 1
        s = (2.0 / (D + DQ)) ** 0.5
        wq = rand(g, (D, DQ), dtype, dev, s)
        wk = rand(g, (D, DKV), dtype, dev, s)
        wv = rand(g, (D, DKV), dtype, dev, s)
        got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS)
        ref = FB.qkv_reference(x, wn, wq, wk, wv, EPS)
        errs[str(dtype)] = max(check_close(f"fused_rmsnorm_qkv T={T} {n}",
                                           a, b, dtype)
                               for n, a, b in zip("qkv", got, ref))
    F_ = torch.nn.functional
    out["ms"] = timer(lambda: FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS))
    out["plain_ms"] = timer(lambda: FB.qkv_reference(x, wn, wq, wk, wv, EPS))

    def library():
        xn = F_.rms_norm(x, (D,), wn, EPS)
        return xn @ wq, xn @ wk, xn @ wv
    out["library_ms"] = timer(library)
    n = DQ + 2 * DKV
    out["bound_ms"], out["bound_by"] = bound_ms(
        2 * (T * D + D + D * n + T * n), 2 * T * D * n)
    out["max_abs_err"] = errs[str(torch.bfloat16)]
    out["max_abs_err_fp32"] = errs[str(torch.float32)]
    return out


def kernel_mlp(FB, dev, timer, T):
    g = torch.Generator(device=dev).manual_seed(100 + T)
    errs, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = rand(g, (T, D), dtype, dev)
        wg = rand(g, (D, F), dtype, dev, (2.0 / (D + F)) ** 0.5)
        wu = rand(g, (D, F), dtype, dev, (2.0 / (D + F)) ** 0.5)
        wd = rand(g, (F, D), dtype, dev, (2.0 / (D + F)) ** 0.5)
        got = FB.fused_mlp(x, wg, wu, wd)
        errs[str(dtype)] = check_close(f"fused_mlp T={T}", got,
                                       FB.mlp_reference(x, wg, wu, wd), dtype)
        del got
    F_ = torch.nn.functional
    out["ms"] = timer(lambda: FB.fused_mlp(x, wg, wu, wd))
    out["plain_ms"] = timer(lambda: FB.mlp_reference(x, wg, wu, wd))
    out["library_ms"] = timer(lambda: (F_.silu(x @ wg) * (x @ wu)) @ wd)
    out["bound_ms"], out["bound_by"] = bound_ms(
        2 * (2 * T * D + 3 * D * F), 6 * T * D * F)
    out["max_abs_err"] = errs[str(torch.bfloat16)]
    out["max_abs_err_fp32"] = errs[str(torch.float32)]
    # the two-launch design's extra traffic: h written, then read back
    out["workspace_bytes"] = 2 * T * F * 2
    return out


def kernel_paged(PA, dev, timer):
    B, h, kvh, hd, bs, mb = 8, 32, 8, 128, 16, 64
    nb = 1 + B * mb
    g = torch.Generator(device=dev).manual_seed(7)
    lengths = torch.linspace(1, mb * bs, B).round().to(torch.int32).to(dev)
    # each row's blocks are a random slice of a permutation of 1..nb-1
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    bt = perm.reshape(B, mb).to(torch.int32).contiguous()
    errs, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(g, (B, h, hd), dtype, dev)
        kp = rand(g, (nb, bs, kvh, hd), dtype, dev)
        vp = rand(g, (nb, bs, kvh, hd), dtype, dev)
        got = PA.paged_decode_attention(q, kp, vp, bt, lengths)
        errs[str(dtype)] = check_close(
            "paged_decode_attention", got,
            PA.paged_decode_reference(q, kp, vp, bt, lengths), dtype)
    F_ = torch.nn.functional
    out["ms"] = timer(lambda: PA.paged_decode_attention(q, kp, vp, bt,
                                                         lengths))
    out["plain_ms"] = timer(lambda: PA.paged_decode_reference(
        q, kp, vp, bt, lengths))
    live = (torch.arange(mb * bs, device=dev)[None, :]
            < lengths.long()[:, None])[:, None, None, :]

    def library():
        idx = bt.long()
        kb = kp[idx].reshape(B, mb * bs, kvh, hd).transpose(1, 2)
        vb = vp[idx].reshape(B, mb * bs, kvh, hd).transpose(1, 2)
        return F_.scaled_dot_product_attention(q[:, :, None], kb, vb,
                                               attn_mask=live,
                                               enable_gqa=True)
    out["library_ms"] = timer(library)
    tokens = int(lengths.sum())
    out["bound_ms"], out["bound_by"] = bound_ms(
        2 * (2 * B * h * hd + 2 * tokens * kvh * hd) + 4 * (B * mb + B),
        4 * tokens * h * hd)
    out["max_abs_err"] = errs[str(torch.bfloat16)]
    out["max_abs_err_fp32"] = errs[str(torch.float32)]
    out["shape"] = (f"B={B} h={h} kvh={kvh} hd={hd} bs={bs} "
                    f"lengths={lengths.tolist()}")
    return out


# -- phase 4: full-width parity against the plain path -----------------------

def drive(model, prompt, chunk, n_new):
    """Chunked prefill then greedy decode of one sequence through the
    model's paged-cache forward; returns (last chunk's fp32 logits,
    greedy tokens)."""
    from paddle_tpu_torch.inference.kv_cache import PagedCache, PagedKVPool
    cfg = model.config
    dev = model.device
    bs, mb = 16, 64
    pool = PagedKVPool(cfg.num_hidden_layers, 1 + mb, bs,
                       cfg.num_key_value_heads, cfg.head_dim,
                       next(model.parameters()).dtype, dev)
    bt = torch.arange(1, 1 + mb, dtype=torch.int32, device=dev)[None]
    caches = [PagedCache(k, v, bt) for k, v in zip(pool.kpools, pool.vpools)]

    def fwd(ids, pos):
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)[None]
        logits, _ = model(ids_t, None, caches,
                          torch.tensor([pos], dtype=torch.int32))
        return logits[0].float()

    with torch.inference_mode():
        for start in range(0, len(prompt), chunk):
            last = fwd(prompt[start:start + chunk], start)
        toks, pos = [int(last[-1].argmax())], len(prompt)
        for _ in range(n_new - 1):
            toks.append(int(fwd([toks[-1]], pos)[-1].argmax()))
            pos += 1
    return last.cpu(), toks


def parity(dev):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = 2
    seed(1)
    card = LlamaForCausalLM(cfg, device=dev)
    cfg32 = LlamaConfig.llama3_8b()
    cfg32.num_hidden_layers, cfg32.dtype = 2, "float32"
    host = LlamaForCausalLM(cfg32, device="cpu")
    host.set_state_dict({k: v.float().cpu().numpy()
                         for k, v in card.state_dict().items()})
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 300)
    t0 = time.perf_counter()
    got, toks = drive(card, prompt, 256, 8)
    ref, ref_toks = drive(host, prompt, 256, 8)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    # bf16 weights and activations on the card against fp32 on the
    # host: a few bf16 roundings (2^-8 relative) per layer of a hidden
    # state of unit RMS, carried into logits of this scale
    tol = 0.05 * scale
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"parity: logits max abs err {err} > {tol}")
    agree = sum(a == b for a, b in zip(toks, ref_toks))
    emit("parity", layers=2, prompt=len(prompt), chunk=256,
         logits_shape=list(got.shape), max_abs_err=err, ref_max_abs=scale,
         tolerance=tol, greedy_tokens=toks, plain_tokens=ref_toks,
         tokens_agree=f"{agree}/{len(toks)}",
         seconds=time.perf_counter() - t0)
    del card, host


# -- phase 5: serve the full model -------------------------------------------

def serve(dev, kernels):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama3_8b()
    seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = ContinuousBatchingEngine(model, slots=8, max_len=1024,
                                   kv_block_size=16, prefill_chunk=256)
    rng = np.random.default_rng(0)
    # one short request first: CUDA library handles and allocator pools
    # are set up outside the measured run
    eng.add_request(rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)
    eng.run()
    lengths = [64, 150, 256, 333, 420, 512, 600, 700]
    rids = [eng.add_request(rng.integers(0, cfg.vocab_size, n),
                            max_new_tokens=32) for n in lengths]
    stats0 = dict(eng.stats)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    for rid in rids:
        st = eng.request_status(rid)
        toks = out[rid][1]
        if st != "ok" or len(toks) != 32 or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"serve: request {rid} status {st!r}, "
                                 f"{len(toks)} tokens")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"serve: kernel {name} never launched")
    ttft = np.array([eng.request_status(r).timings["ttft_s"] for r in rids])
    dec_tok = eng.stats["decode_tokens"] - stats0["decode_tokens"]
    dec_s = eng.stats["decode_seconds"] - stats0["decode_seconds"]
    emit("serve", layers=cfg.num_hidden_layers, dtype=cfg.dtype,
         requests=len(rids), prompt_lengths=lengths, max_new_tokens=32,
         model_build_s=build_s, run_s=run_s,
         ttft_p50_s=float(np.percentile(ttft, 50)),
         ttft_p99_s=float(np.percentile(ttft, 99)),
         decode_steps=eng.stats["decode_steps"] - stats0["decode_steps"],
         decode_tokens=dec_tok, decode_tok_s=dec_tok / dec_s,
         prefill_chunks=eng.stats["prefill_chunks"]
         - stats0["prefill_chunks"],
         output_tok_s=sum(len(out[r][1]) for r in rids) / run_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches, first_tokens=[out[r][1][:4] for r in rids])
    profile(eng, cfg, rng)
    return launches


def profile(eng, cfg, rng):
    """Where a serving window's time goes: 8 requests (64-token prompts,
    16 new tokens) under torch.profiler; device time by kernel and the
    device's busy share of the window's wall time.  Run after the
    measured serve run, so profiling costs nothing there."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for _ in range(8):
        eng.add_request(rng.integers(0, cfg.vocab_size, 64),
                        max_new_tokens=16)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    emit("profile", requests=8, prompt=64, new_tokens=16, wall_s=wall,
         device_busy_s=busy_us / 1e6 if kernels else None,
         device_busy_share=busy_us / 1e6 / wall if kernels else None,
         top=[{"kernel": e.key[:90], "ms": e.device_time_total / 1e3,
               "calls": e.count} for e in top])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # the port itself: an ImportError here (script copied alone) is fatal
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    nvcc_s = _build.build_all()
    emit("build", nvcc_s=nvcc_s, cached=nvcc_s == 0.0,
         seconds=time.perf_counter() - t0, dir=str(_build.BUILD_DIR))

    timer = Timer(dev)
    res = {"fused_rmsnorm_qkv": {T: kernel_qkv(FB, dev, timer, T)
                                 for T in (8, 256)},
           "fused_mlp": {T: kernel_mlp(FB, dev, timer, T) for T in (8, 256)},
           "paged_decode_attention": {8: kernel_paged(PA, dev, timer)}}
    emit("kernels", results={k: {str(t): v for t, v in r.items()}
                             for k, r in res.items()})
    del timer
    torch.cuda.empty_cache()

    parity(dev)
    torch.cuda.empty_cache()
    launches = serve(dev, kernels)

    where = {
        "fused_rmsnorm_qkv": ("paddle_tpu_torch/ops/kernels/csrc/"
                              "fused_block.cu",
                              "paddle_tpu/ops/pallas/fused_block.py:249"),
        "fused_mlp": ("paddle_tpu_torch/ops/kernels/csrc/fused_block.cu",
                      "paddle_tpu/ops/pallas/fused_block.py:494"),
        "paged_decode_attention": (
            "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/paged_attention.py:86"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = []
    for name, (src, rep) in where.items():
        by_t = res[name]
        decode = by_t[8]             # the decode shape: most launches
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": launches[name],
                 **{k: decode[k] for k in keys}, "shape": "decode"}
        if 256 in by_t:
            entry["prefill_T256"] = {k: by_t[256][k] for k in keys}
        line.append(entry)
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
