#!/usr/bin/env python3
"""Time the multi-tensor norm and update of another tree's kernels against
this tree's, in turns, on one NVIDIA H100.

    git archive HEAD paddle_tpu_torch | tar -x -C _proof/parent
    python3 multi_tensor_ab.py --tree _proof/parent [--rounds 3]

Builds ``<tree>/paddle_tpu_torch/ops/kernels/csrc/multi_tensor.cu`` with
this tree's nvcc flags into ``ops/kernels/build/multi_tensor_ab/`` (its C
entries ``ptt_mt_norm`` and ``ptt_mt_adam`` keep this tree's signatures
and table layouts), then over the Train model's parameters (Llama-3-8B
width, 4 layers: 39 bf16 tensors, 1.92e9 parameters, bf16 gradients,
fp32 masters and moments) times ``multi_tensor_norm`` and
``multi_tensor_adam`` (AdamW with a clip scale and the keep flag) with
``chip_smoke.Timer``, the other tree's library and this one's in turns
(other, this, this, other) for ``--rounds`` rounds.  Both libraries'
norms must agree bit for bit, and their updates of the first six
tensors too.

Prints one JSON line a turn, then the card's name and power limit.
Imports nothing of JAX; exits 2 without a card."""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import multi_tensor as MT


def build_other(tree: Path) -> ctypes.CDLL:
    """The loaded multi_tensor library of `tree`'s sources."""
    csrc = tree / "paddle_tpu_torch" / "ops" / "kernels" / "csrc"
    out = _build.BUILD_DIR / "multi_tensor_ab"
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libmulti_tensor-other.so"
    p = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(so),
                        str(csrc / "multi_tensor.cu")], capture_output=True,
                       text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc, {csrc}:\n{p.stdout}{p.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("ptt_mt_norm", "ptt_mt_adam"):
        f = getattr(lib, fn)
        f.argtypes = _build._SIGNATURES["multi_tensor"][fn]
        f.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="a tree holding paddle_tpu_torch/ (another commit)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("multi_tensor_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    libs = {"this": _build.library("multi_tensor"),
            "other": build_other(Path(args.tree))}
    timer = cs.Timer(dev)
    _, model = cs.train_model(dev)
    params = [p.detach() for p in model.parameters()]
    g = torch.Generator(device=dev).manual_seed(13)
    grads = [cs.rand(g, p.shape, torch.bfloat16, dev, 0.01) for p in params]
    masters = [p.float() for p in params]
    m = [cs.rand(g, p.shape, torch.float32, dev, 1e-3) for p in params]
    v = [cs.rand(g, p.shape, torch.float32, dev, 1e-3).square_()
         for p in params]
    kw = dict(lr=torch.tensor(cs.MT_LR, device=dev),
              step=torch.tensor(cs.MT_STEP, dtype=torch.int32, device=dev),
              scale=torch.tensor(0.5, device=dev),
              keep=torch.tensor(True, device=dev), **cs.MT_ARGS)
    outs = {}
    for name, lib in libs.items():
        _build._libs["multi_tensor"] = lib
        st = [[t.clone() for t in ts[:6]] for ts in (params, m, v, masters)]
        MT.multi_tensor_adam(st[0], grads[:6], st[1], st[2], st[3],
                             weight_decays=[cs.MT_WD] * 6, **kw)
        outs[name] = [MT.multi_tensor_norm(grads)] + \
            [t for ts in st for t in ts]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(*outs.values())):
        raise AssertionError("the two trees' norms or updates differ")
    del outs
    kw["weight_decays"] = [cs.MT_WD] * len(params)
    for r in range(args.rounds):
        for name in ("other", "this", "this", "other"):
            _build._libs["multi_tensor"] = libs[name]
            print(json.dumps({
                "round": r, "tree": name,
                "norm_ms": timer(lambda: MT.multi_tensor_norm(grads)),
                "adam_ms": timer(lambda: MT.multi_tensor_adam(
                    params, grads, m, v, masters, **kw))}), flush=True)
    _build._libs["multi_tensor"] = libs["this"]
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
