#!/usr/bin/env python3
"""Time the port's host-bound eager paths for one checkout of the port on
one NVIDIA H100, so that two checkouts (a parent without the op hook and
a change with it) are measured with one yardstick.

    python3 compare_hook.py --tree DIR --label NAME [--out FILE]

DIR holds the ``paddle_tpu_torch/`` to time; the shapes, seeds and
repeats come from this file whatever DIR is.  Run it once a checkout in
one call to the card, alternating (parent, change, change, parent), and
compare within that call only: host-bound times move with the load of
the card machine's shared CPU from call to call.

Prints one JSON line (and writes it to FILE):

- ``transformer``: ``nn.Transformer()`` (d_model 512, 8 heads, 6 + 6
  layers, FFN 2048, relu) in bf16, eval, b=32, source and target 256
  with the causal target mask, as ``chip_smoke.transformer_infer``
  drives it: the host seconds of each of 20 forwards (each ending in a
  synchronize) after 3 warm-ups, their median, and where the tree has
  the hook, the hooked calls a forward (the operator stats).
- ``train_gpt``: ``TrainStep(GPTForCausalLM, AdamW(multi_precision))``
  at GPT-2 medium width (24 layers, bf16, dropout 0, b=8, s=1024), as
  ``chip_smoke.train_gpt`` drives it: 10 eager steps after one warm-up,
  each step's seconds and their median.

Needs a card; exits 2 without one."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_hook: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.tree)
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import Transformer
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW
    import paddle_tpu_torch
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    out = {"label": args.label, "tree": args.tree,
           "package": paddle_tpu_torch.__file__}

    seed(0)
    model = Transformer(dtype="bfloat16", device=dev).eval()
    g = torch.Generator(device=dev).manual_seed(9)
    src = torch.randn((32, 256, 512), generator=g, device=dev).bfloat16()
    tgt = torch.randn((32, 256, 512), generator=g, device=dev).bfloat16()
    mask = Transformer.generate_square_subsequent_mask(256, device=dev)

    def fwd():
        with torch.inference_mode():
            return model(src, tgt, tgt_mask=mask)

    for _ in range(3):
        fwd()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    hooked = None
    try:
        from paddle_tpu_torch.amp import debugging
    except ImportError:
        debugging = None
    if debugging is not None:
        with debugging.collect_operator_stats() as s:
            fwd()
        hooked = sum(s.counts.values())
    out["transformer"] = {"fwd_s": times, "fwd_s_median":
                          float(np.median(times)),
                          "hooked_calls_a_forward": hooked}
    del model, src, tgt
    torch.cuda.empty_cache()

    cfg = GPTConfig(dtype="bfloat16", hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    seed(0)
    step = TrainStep(GPTForCausalLM(cfg, device=dev),
                     AdamW(learning_rate=1e-4, multi_precision=True),
                     guard_nonfinite=True)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 1025))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    float(step(batch))
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        float(step(batch).detach())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["train_gpt"] = {"step_s": times,
                        "step_s_median": float(np.median(times))}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
