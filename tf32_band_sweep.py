#!/usr/bin/env python3
"""Sweep the band of the 3xTF32 GEMM's persistent walk on one NVIDIA H100.

    python3 tf32_band_sweep.py [--bands 1,2,4,8,16]

``csrc/fused_block.cu``'s ``tf32x3_gemm_kernel`` walks its output tiles
in bands of ``kTf32Band`` row tiles (4), so that a band's split A rows stay
in L2 while its column tiles pass.  This builds ``fused_block.cu`` once for
each band (``-DPTT_TF32_BAND=n``, one nvcc each, all started together,
into ``ops/kernels/build/band_sweep/``), then calls fp32
``fused_rmsnorm_qkv`` (training variant) and ``fused_mlp`` at Llama-3-8B
width (d 4096, dq 4096, dkv 1024, f 14336) and T = 8192 through each
build.  Each call is timed whole with ``chip_smoke.Timer`` (the split
pre-pass, QKV's row pass and the GEMMs), in two passes over the bands, the
second in reverse order; every build's outputs must equal the first's
bit for bit, since the band moves only the order in which tiles are
taken.

Prints one JSON line a band and pass, then the card's name and power
limit.  Imports nothing of JAX; exits 2 without a card."""

import argparse
import ctypes
import json
import subprocess
import sys

import torch

import chip_smoke as cs
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import fused_block as FB

T = 8192


def build(bands):
    """{band: the loaded fused_block library built with that band}."""
    out = _build.BUILD_DIR / "band_sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for b in bands:
        so = out / f"libfused_block-band{b}.so"
        cmd = [_build._nvcc(), *_build.FLAGS, f"-DPTT_TF32_BAND={b}", "-o",
               str(so), str(_build.CSRC / "fused_block.cu")]
        procs[b] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT))
    libs = {}
    for b, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc, band {b}:\n"
                               f"{log.decode(errors='replace')}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES["fused_block"].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        libs[b] = lib
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bands", default="1,2,4,8,16",
                    help="comma-separated bands of row tiles")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tf32_band_sweep: CUDA is not available", file=sys.stderr)
        return 2
    bands = [int(b) for b in args.bands.split(",")]
    dev = torch.device("cuda", 0)
    libs = build(bands)
    timer = cs.Timer(dev)
    dt = torch.float32
    g = torch.Generator(device=dev).manual_seed(T + 19)
    x = cs.rand(g, (T, cs.D), dt, dev)
    wn = cs.rand(g, (cs.D,), dt, dev, 0.1) + 1
    s = (2.0 / (cs.D + cs.DQ)) ** 0.5
    w = [cs.rand(g, (cs.D, n), dt, dev, s) for n in (cs.DQ, cs.DKV, cs.DKV)]
    s = (2.0 / (cs.D + cs.F)) ** 0.5
    wg, wu = (cs.rand(g, (cs.D, cs.F), dt, dev, s) for _ in range(2))
    wd = cs.rand(g, (cs.F, cs.D), dt, dev, s)

    def qkv():
        return FB.fused_rmsnorm_qkv(x, wn, *w, cs.EPS, residuals=True)

    def mlp():
        return FB.fused_mlp(x, wg, wu, wd)

    first = None
    for pass_, order in enumerate((bands, bands[::-1])):
        for b in order:
            _build._libs["fused_block"] = libs[b]
            n0 = dict(FB.fused_mlp.launches_by_path)
            outs = qkv()[:3] + (mlp(),)
            if FB.fused_mlp.launches_by_path["tf32x3"] != n0["tf32x3"] + 1:
                raise AssertionError(f"band {b}: fused_mlp not on tf32x3")
            if first is None:
                first = outs
            elif not all(torch.equal(a, c) for a, c in zip(outs, first)):
                raise AssertionError(f"band {b}: outputs differ from band "
                                     f"{bands[0]}'s")
            del outs
            print(json.dumps({"band": b, "pass": pass_,
                              "qkv_train_ms": timer(qkv, iters=5),
                              "mlp_ms": timer(mlp, iters=5)}), flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
