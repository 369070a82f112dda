#!/usr/bin/env python3
"""Measure the split-K streams of the port's decode-row kernels on one
NVIDIA H100: how fast each streams its weight, and what a launch costs
beside its stream.

    python3 splitk_stream.py

- The MLP's split-K (bf16, T = 8 and 16): ``fused_mlp`` at Llama-3-8B
  width (d 4096, f 14336) and with d, or f, cut to a half and a quarter.
  For each call, its device time (``chip_smoke.Timer``) and weight
  bytes, and each launch's split count and profiled span.  Then a
  least-squares line through the calls' times against their bytes: the
  slope is the streaming rate (TB/s) and the intercept the fixed cost of
  a call, both launches (us at no bytes).  The launches are not fitted
  apart: the down product is a dependent launch whose span opens during
  gate/up's, and where the profiler closes gate/up's span then varies
  from run to run.
- The stream of QKV's and the quant matmul's split-K (per-warp
  [16][128] boxes) on weights of the MLP's sizes: ``fused_rmsnorm_qkv``
  at T = 8 with q as wide as gate and up together (d 4096, dq 28672) and
  as deep as the down product (d 14336, dq 4096), kv 64 wide: the
  split-K kernel's profiled span and its weight bytes over it.

Prints one JSON line a measurement, then the card's name and power
limit.  Imports nothing of JAX; exits 2 without a card."""

import json
import sys

import numpy as np
import torch

import chip_smoke as cs

D, F = 4096, 14336


def mlp_point(FB, dev, timer, T, d, f):
    """One fused_mlp call's two launches at (T, d, f): us and bytes."""
    g = torch.Generator(device=dev).manual_seed(d + f + T)
    s = (2.0 / (d + f)) ** 0.5
    x = cs.rand(g, (T, d), torch.bfloat16, dev)
    wg, wu = (cs.rand(g, (d, f), torch.bfloat16, dev, s) for _ in range(2))
    wd = cs.rand(g, (f, d), torch.bfloat16, dev, s)

    def call():
        return FB.fused_mlp(x, wg, wu, wd)
    if FB.gemm_path(T, torch.bfloat16) != "splitk":
        raise AssertionError(f"fused_mlp T={T} is not on split-K")
    ms = timer(call)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launches = cs.splitk_launches(timer, call, ms, (d, f, 4 * d * f),
                                  (f, d, 2 * d * f), sms)
    return {"T": T, "d": d, "f": f, "call_ms": ms, **launches}


def fit(points):
    """(intercept us, 1 / slope in TB/s) of (bytes, us) points, least
    squares."""
    b = np.array([p[0] for p in points], dtype=np.float64)
    us = np.array([p[1] for p in points], dtype=np.float64)
    slope, icept = np.polyfit(b, us, 1)
    return float(icept), float(1.0 / slope / 1e6)


def qkv_point(FB, dev, timer, d, dq, dkv=64, T=8):
    """QKV split-K's kernel span on a d x (dq + 2 dkv) weight."""
    g = torch.Generator(device=dev).manual_seed(d + dq)
    s = d ** -0.5
    x = cs.rand(g, (T, d), torch.bfloat16, dev)
    wn = cs.rand(g, (d,), torch.bfloat16, dev, 0.1) + 1
    wq = cs.rand(g, (d, dq), torch.bfloat16, dev, s)
    wk, wv = (cs.rand(g, (d, dkv), torch.bfloat16, dev, s) for _ in range(2))
    spans = cs.launch_us(timer, lambda: FB.fused_rmsnorm_qkv(x, wn, wq, wk,
                                                             wv))
    us = sum(v for k, v in spans.items() if "qkv_splitk_kernel" in k)
    nbytes = 2 * d * (dq + 2 * dkv)
    return {"d": d, "dq": dq, "dkv": dkv, "T": T, "weight_bytes": nbytes,
            "splits": FB.qkv_splits(d, dq, dkv, torch.cuda.
                                    get_device_properties(dev).
                                    multi_processor_count),
            "us": us, "tb_per_s": nbytes / us / 1e6}


def main():
    if not torch.cuda.is_available():
        print("splitk_stream: CUDA is not available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    dev = torch.device("cuda", 0)
    timer = cs.Timer(dev)
    for T in (8, 16):
        calls = []
        for d, f in ((D // 4, F), (D // 2, F), (D, F), (D, F // 4),
                     (D, F // 2)):
            p = mlp_point(FB, dev, timer, T, d, f)
            print(json.dumps({"mlp": p}), flush=True)
            calls.append((6 * d * f, 1e3 * p["call_ms"]))
            torch.cuda.empty_cache()
        icept, rate = fit(calls)
        print(json.dumps({"mlp_fit": {"T": T, "fixed_us": icept,
                                      "tb_per_s": rate}}), flush=True)
    for d, dq in ((D, 2 * F), (F, D)):
        print(json.dumps({"qkv_stream": qkv_point(FB, dev, timer, d, dq)}),
              flush=True)
        torch.cuda.empty_cache()
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
