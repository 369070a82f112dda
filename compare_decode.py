#!/usr/bin/env python3
"""Time the serving path's decode kernels of one checkout of the port on
one NVIDIA H100, with this directory's ``chip_smoke.py`` timers, so that
two checkouts (a parent and a change) are measured with one yardstick.

    python3 compare_decode.py --tree DIR --label NAME [--out FILE]

DIR holds the ``paddle_tpu_torch/`` to time; the timers, seeds and
shapes come from this file and its ``chip_smoke.py`` whatever DIR is.
Run it once a checkout in one call to the card, alternating (parent,
change, change, parent), and compare within that call only.

Prints one JSON line (and writes it to FILE):

- ``rows``: QKV at T = 8 (bf16, Llama-3-8B width), paged decode at the
  Serve shape (B = 8, 32 / 8 heads, head_dim 128, blocks of 16, lengths
  1..1024) over bf16 and int8 pools, and the int8 quant matmul at T = 8
  (q/o and k/v), each the mean device ms of 10 launches under
  ``chip_smoke.Timer`` (``spin``) and under the same timer with no spin
  before the launch (``no_spin``), beside the library call under both;
  and the largest error against the plain version.
- ``serve``: the full 32-layer Llama-3-8B (bf16, seeded random weights)
  behind the paged engine as ``chip_smoke.serve`` drives it: 8 requests
  of 64..700 prompt tokens, 32 new tokens each, once unprofiled (decode
  tokens/s) and once under torch.profiler; then ``chip_smoke.profile``'s
  window (8 requests of 64 tokens, 16 new) under torch.profiler.  For
  each profiled run, the device ms per decode step of paged decode,
  QKV at decode rows and the MLP at decode rows, by kernel name in
  either checkout, and the device's busy time.

Needs a card; exits 2 without one."""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# decode-row kernels by family, as either checkout names them: the serial
# paged walk or the split design; QKV's 16-row wmma tile (gemm_tile MODE
# 0) or the row pass and split-K; the MLP's 16-row wmma tile (modes 1-4)
FAMILIES = {
    "paged": re.compile(r"::paged_(decode|split)_kernel<"),
    "qkv": re.compile(r"::(qkv_decode_rows_kernel|qkv_splitk_kernel)[<(]"
                      r"|::gemm_kernel<__nv_bfloat16, 16, 0>"),
    "mlp": re.compile(r"::gemm_kernel<__nv_bfloat16, 16, [1-4]>"),
}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(timer, fn):
    """{"spin": ms, "no_spin": ms}: chip_smoke's Timer, then the same
    timer without the spin."""
    out = {"spin": timer(fn)}
    timer.BUSY_CYCLES = 0
    try:
        out["no_spin"] = timer(fn)
    finally:
        del timer.BUSY_CYCLES
    return out


def row(timer, kernel, library, reference):
    got = kernel()
    torch.cuda.synchronize()
    err = float((got.float() - reference().float()).abs().max())
    return {"ms": timed(timer, kernel), "library_ms": timed(timer, library),
            "max_abs_err": err}


def kernel_rows(cs, dev):
    from paddle_tpu_torch.inference.kv_cache import _quantize_kv
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.ops.kernels import quant_matmul as QM
    from paddle_tpu_torch.quantization.serving import quantize_linear_weight
    F_ = torch.nn.functional
    bf = torch.bfloat16
    timer = cs.Timer(dev)
    rows = {}
    D, DQ, DKV, EPS = cs.D, cs.DQ, cs.DKV, cs.EPS

    g = torch.Generator(device=dev).manual_seed(8)
    s = (2.0 / (D + DQ)) ** 0.5
    x = cs.rand(g, (8, D), bf, dev)
    wn = cs.rand(g, (D,), bf, dev, 0.1) + 1
    wq, wk, wv = (cs.rand(g, (D, n), bf, dev, s) for n in (DQ, DKV, DKV))

    def qkv_library():
        xn = F_.rms_norm(x, (D,), wn, EPS)
        return torch.cat([xn @ wq, xn @ wk, xn @ wv], 1)
    rows["qkv T=8"] = row(
        timer,
        lambda: torch.cat(FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS), 1),
        qkv_library,
        lambda: torch.cat(FB.qkv_reference(x, wn, wq, wk, wv, EPS), 1))
    del x, wq, wk, wv

    B, h, kvh, hd, bs, mb = 8, 32, 8, 128, 16, 64
    nb = 1 + B * mb
    g = torch.Generator(device=dev).manual_seed(7)
    lengths = torch.linspace(1, mb * bs, B).round().to(torch.int32).to(dev)
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    bt = perm.reshape(B, mb).to(torch.int32).contiguous()
    live = (torch.arange(mb * bs, device=dev)[None, :]
            < lengths.long()[:, None])[:, None, None, :]
    q = cs.rand(g, (B, h, hd), bf, dev)
    for pools in ("bf16", "int8"):
        kp = cs.rand(g, (nb, bs, kvh, hd), bf, dev)
        vp = cs.rand(g, (nb, bs, kvh, hd), bf, dev)
        sc = {}
        if pools == "int8":
            (kp, ks), (vp, vs) = _quantize_kv(kp), _quantize_kv(vp)
            sc = {"k_scale": ks, "v_scale": vs}

        def library(kp=kp, vp=vp, sc=sc):
            idx = bt.long()
            kb, vb = kp[idx], vp[idx]
            if sc:
                kb = (kb.float() * sc["k_scale"][idx][..., None]).to(bf)
                vb = (vb.float() * sc["v_scale"][idx][..., None]).to(bf)
            kb = kb.reshape(B, mb * bs, kvh, hd).transpose(1, 2)
            vb = vb.reshape(B, mb * bs, kvh, hd).transpose(1, 2)
            return F_.scaled_dot_product_attention(
                q[:, :, None], kb, vb, attn_mask=live,
                enable_gqa=True)[:, :, 0]
        rows[f"paged {pools}"] = row(
            timer,
            lambda kp=kp, vp=vp, sc=sc: PA.paged_decode_attention(
                q, kp, vp, bt, lengths, **sc),
            library,
            lambda kp=kp, vp=vp, sc=sc: PA.paged_decode_reference(
                q, kp, vp, bt, lengths, **sc))
        del kp, vp, sc

    for name, (K, N) in (("q/o", (D, DQ)), ("k/v", (D, DKV))):
        g = torch.Generator(device=dev).manual_seed(K + N)
        x = cs.rand(g, (8, K), bf, dev)
        qw, scale = quantize_linear_weight(
            cs.rand(g, (K, N), torch.float32, dev, K ** -0.5), "int8")
        wdq = (qw.float() * scale.reshape(1, -1)).to(bf)
        rows[f"quant int8 T=8 {name}"] = row(
            timer, lambda: QM.quant_matmul(x, qw, scale, mode="int8"),
            lambda: x @ wdq,
            lambda: QM.quant_matmul_reference(x, qw, scale))
    del timer
    torch.cuda.empty_cache()
    return rows


def per_step(prof, steps):
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"busy_ms": sum(e.device_time_total for e in kern) / 1e3}
    for fam, pat in FAMILIES.items():
        hits = [e for e in kern if pat.search(e.key)]
        out[fam] = {"ms_per_decode_step":
                    sum(e.device_time_total for e in hits) / 1e3 / steps,
                    "calls": sum(e.count for e in hits),
                    "kernels": sorted({e.key[:80] for e in hits})}
    return out


def window(eng, prompts, n_new, profiled):
    from torch.profiler import ProfilerActivity, profile
    s0 = dict(eng.stats)
    for p in prompts:
        eng.add_request(p, max_new_tokens=n_new)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if profiled else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.stats["decode_steps"] - s0["decode_steps"]
    tok = eng.stats["decode_tokens"] - s0["decode_tokens"]
    sec = eng.stats["decode_seconds"] - s0["decode_seconds"]
    out = {"wall_s": wall, "decode_steps": steps, "decode_tok_s": tok / sec}
    if profiled:
        out.update(per_step(prof, steps))
    return out


def serve(cs, dev):
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama3_8b()
    seed(0)
    model = LlamaForCausalLM(cfg, device=dev)
    eng = ContinuousBatchingEngine(model, slots=8, max_len=1024,
                                   kv_block_size=16, prefill_chunk=256)
    rng = np.random.default_rng(0)
    eng.add_request(rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)
    eng.run()
    long = [rng.integers(0, cfg.vocab_size, n) for n in cs.SERVE_LENGTHS]
    short = [rng.integers(0, cfg.vocab_size, 64) for _ in range(8)]
    return {"serve": window(eng, long, 32, False),
            "serve_profiled": window(eng, long, 32, True),
            "short_window_profiled": window(eng, short, 16, True)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_decode: CUDA is not available", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import paddle_tpu_torch
    if not Path(paddle_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise AssertionError(f"paddle_tpu_torch from "
                             f"{paddle_tpu_torch.__file__}, not {tree}")
    cs = load_chip_smoke()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    res = {"label": args.label, "tree": str(tree),
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": cs.nvidia_smi(), "rows": kernel_rows(cs, dev)}
    res.update(serve(cs, dev))
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
