#!/usr/bin/env python3
"""Drive the PyTorch port (``paddle_tpu_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (build and ptxas one each; kernels
eight: the serving, the training, the quantized serving, the MoE, the
cross-entropy, the feed-forward, the decoder-tier and the multi-tensor
rows; train_graph and train_gpt_graph two more each, a profiled eager and
graphed step; serve,
serve_quant, train, train_moe, train_gpt, train_decoder and
transformer_infer one more each, for a profiled window; serve_quant and
train_moe two, one per engine or dispatch mode):

1. env      versions, the card, TF32 switched off for fp32 references.
2. build    nvcc builds the port's CUDA kernels from ``paddle_tpu_torch/
            ops/kernels/csrc`` (or finds them built); beside it, ptxas
            reports the Hopper kernels (the bf16 flash forward, dq and
            dk/dv, the QKV row pass and wgmma GEMM, the MLP / fused_ffn
            wgmma GEMM and split-K, the quant matmul's split-K and wgmma
            kernels, the rmsnorm's register design):
            registers, shared memory, spills (none allowed) and any wgmma
            serialisation (-Xptxas -v).
3. kernels  every kernel of the serving path at the path's own shapes
            (Llama-3-8B widths: fused RMSNorm+QKV at T = 1, 8 and 16
            decode rows (bf16: the row pass and split-K, bitwise equal
            over two calls) and T = 256 prefill rows, fused SwiGLU MLP at
            T = 1, 8 and 16 (bf16: split-K, bitwise equal over two calls,
            each launch's split count and TB/s from the profiler, timed
            also without the spin so the wrapper's host share shows) and
            T = 256; paged decode at B = 8, 32/8 heads, head_dim
            128, block 16, lengths 1..1024, split across the sequence,
            bitwise equal over two calls) held against its plain PyTorch
            version in bf16 and fp32, and timed with CUDA events beside
            the plain version, one PyTorch library call computing the
            same function, and its bound (the card held busy ~0.5 ms
            before each timed launch, so the host's enqueue time does not
            land between the events).
            The training slice's kernels at its own shapes (b=4,
            s=2048, 32/8 heads, head_dim 128, causal): flash attention
            forward, dq and dk/dv in bf16 (fp32 at b=1), each bf16 row
            within its own limit (FLASH_TOL), the same three at GPT-2
            medium's step through the head_dim pad (b=8, s=1024, 16/16
            heads, head_dim 128) and flash_delta at both shapes, and the
            QKV kernel's training variant, its forward variant (the
            scoring forward's launch) and the MLP kernel pair at T =
            8192.  In bf16 the three flash kernels, and QKV, the MLP
            and fused_ffn at T > 16, are the wgmma / TMA kernels; each
            MLP and FFN row names its path.
            The quantized serving path's kernels (kernels_quant): the
            quant matmul (int8 weights, bf16 io) at T = 8 for each of the
            five (K, N) of a decode step, int8 and fp8 at T = 150 (the
            prefill tile, last tile partial) for each of them, int8 at
            T = 256, fp8 at T = 8 and 256, one fp32-io row, each bf16 row
            within QUANT_MM_TOL; bf16 at T <= 16 is the split-K kernel,
            whose output must be bitwise equal over two calls, past 16
            the wgmma kernel; the int8 paged decode at the fp row's
            shapes, bf16 and fp32 q, both paged rows' bf16 within
            PAGED_TOL.
4. parity   a 2-layer model at full Llama-3-8B width (bf16, seeded random
            weights) on the card against the same weights through the
            plain path (the CPU, fp32): the last prefill chunk's logits
            within a stated tolerance, and 8 greedy tokens.  Then
            parity_quant: the same two models converted with
            quantize_for_serving, the host carrying the card's qweight /
            w_scale buffers: int8 weights with int8 KV pools, then fp8
            weights with fp pools, each within the same tolerance.
5. train_parity  a 1-layer model at full width (vocab cut to 32000),
            fp32, b=1, s=256 (flash routes), FLAGS_default_matmul_precision
            =float32 (as in every card-against-CPU parity phase): loss and
            every parameter's gradient on the card against the CPU's
            plain path.  train_parity_tf32: the card at the flag's
            default (the chunked CE's products in TF32) against the card
            at float32, within CE_TF32_TOL, and a control with bf16
            products outside it.
6. serve    the full 32-layer Llama-3-8B in bf16 (random weights from a
            seeded generator) behind the paged ContinuousBatchingEngine:
            8 requests, prompts of 64..700 tokens, 32 new tokens each.
            Every request must end "ok" with 32 tokens, and every serving
            kernel's launch count must have grown during this run (the
            MLP and QKV on both paths: wgmma for prefill chunks, split-K
            at decode, never the tile; paged decode split).  Then
            a short window under torch.profiler: device time by kernel,
            the decode kernels' device ms per decode step and the
            device's busy share.  serve_quant: the same model, in
            place, behind ContinuousBatchingEngine(quant_weights="int8",
            quant_kv="int8") and then (quant_weights="fp8"), the same 8
            requests: every request "ok" with 32 tokens, the quant
            kernels launched (split-K at decode, wgmma for prefill, the
            fp32 tile never) and the fused fp kernels not, 1025 int8
            blocks, the model restored by close(); then a profiled
            window of the int8 engine (profile_quant).
7. train    4 layers at Llama-3-8B width in bf16, TrainStep with
            AdamW(learning_rate=1e-4, multi_precision=True) and the
            non-finite guard, b=4, s=2048, one fixed random batch: 1
            warm-up and 5 timed steps.  Every loss finite, the last below
            the first, no step skipped, every training kernel launched;
            the chunked CE's device time alone at the step's shape, at
            the flag's default (TF32, the training phases' setting) and
            at float32, the default within CE_TF32_TOL of float32 and a
            control with bf16 products reported beside it.  Then one
            step under torch.profiler.

8. moe     the MoE slice at ERNIE-4.5-21B-A3B width.  kernels_moe (with
            the kernel phases): the grouped expert FFN against its plain
            version at the step's shape (G = E = 64, C = 960, d = 2560,
            h = 1536, bf16 on the wgmma ring, counts of a real routing),
            with counts 0, C and partial, in fp32 at C = 64 (the first
            design) and with G = 2E, each on its path and timed
            beside its plain version, the baddbmm -> gelu -> baddbmm
            chain and its bound.  moe_parity: one full-width MoELayer,
            forward and backward, kernel path against plain path on the
            card (fp32, bf16), then a 2-layer fp32 ERNIE loss on the card
            against the CPU, with the expert choices that differ.
            train_moe: TrainStep(ErnieForCausalLM) with 4 of 28 layers
            (1 dense, 3 MoE), bf16, b=4, s=2048, AdamW(multi_precision),
            einsum dispatch 1 + 5 steps (then train_moe_profile), index
            dispatch 1 + 3 steps on a fresh model; launch counts and the
            grouped FFN's wgmma path checked per step.
9. gpt      the GPT slice at GPT-2-medium width.  kernels_ce (with the
            kernel phases): the fused softmax cross-entropy forward and
            backward against their plain versions at the step's shape (bf16
            T = 8192, V = 50304), fp32 at T = 1024, and bf16 T = 1000 over
            the unpadded V = 50257 (rows off the 16-byte grid, a tail, some
            labels outside [0, V)); loss, lse and dx within CE_TOL, each
            timed beside its plain version, F.cross_entropy on fp32 logits
            (forward; its autograd backward) and its bound.  gpt_parity: a
            2-layer fp32 GPTForCausalLM at full width, b=1, s=1024 (flash
            through the head_dim-64 pad), loss and every gradient on the card
            against the CPU.  train_gpt: TrainStep(GPTForCausalLM) with all
            24 layers, bf16, dropout 0, b=8, s=1024, AdamW(multi_precision),
            1 + 5 steps, launch counts checked per step; then
            train_gpt_profile.
10. transformer  nn.Transformer() (the base model: d_model 512, 8 heads,
            6 + 6 layers, FFN 2048, relu, post-LN).  kernels_ffn (with the
            kernel phases): fused_ffn against ffn_reference at T = 8192,
            d = 512, f = 2048, relu / gelu / silu in bf16 and relu in fp32,
            and relu in bf16 at T = 8 (a decode step's rows: split-K,
            bitwise equal over two calls), timed beside the plain version,
            addmm -> act -> addmm and its bound.  transformer_infer: the full model in bf16, eval, b=32,
            source and target 256 with the causal target mask: the output
            against the plain FFN route on the card, forward seconds, tokens
            per second, fused_ffn launched 12 times a forward; a 2 + 2-layer
            fp32 card-vs-CPU parity; then transformer_profile.
11. decoder  the Llama decoder tier (PADDLE_TPU_FUSED_BLOCK=decoder).
            kernels_decoder (with the kernel phases): the whole-block
            kernel against decoder_reference in fp32 at b=1, s=512 (the
            first design) and in bf16 at the train shape (b=4, s=2048,
            Llama-3-8B width; the wgmma / TMA design, three calls in a row,
            bitwise equal), each within DECODER_TOL of the largest |out|
            and timed beside the plain version, its bound and the library
            chain in its dtype;
            the
            rmsnorm kernel against rmsnorm_reference at T=8192, d=4096
            (bf16 with and without a residual, fp32; without one h is x
            itself), beside x + r then F.rms_norm.  score_decoder (on the serve model, before it is
            freed): 32-layer cache-free scoring of b=4 x 2048 tokens at
            the decoder tier (32 block launches a forward, on wgmma) and
            at the default tier, logits within 5% of their largest.
            decoder_parity (after train): one fp32 full-width layer at the
            tier, loss and every gradient against the CPU.  train_decoder:
            the train step at the tier, 1 + 3 steps, launches exact per
            step (block 4 on wgmma, rmsnorm, QKV, MLP and flash 4 each),
            the peak beside train's; then train_decoder_profile.
            norm_residual (last): F.rms_norm_residual forward and
            backward at T=8192,
            one launch a call.
12. optimizer step  kernels_multi_tensor (with the kernel phases): the
            multi-tensor gradient norm and AdamW update on the Train
            model's parameter set (1.92 B bf16 parameters, fp32 masters and
            moments) against their plain versions (the update bitwise in
            every output, the norm within MT_TOL), timed beside the plain
            version, a PyTorch yardstick (torch._foreach_norm;
            torch._fused_adamw_) and the bound; each
            training phase checks both launched once a step.
            train_graph (after train): the Train cell with
            AdamW(LinearWarmup(CosineAnnealingDecay), multi_precision=True,
            grad_clip=ClipGradByGlobalNorm(1.0)): eager steps, then from the
            same saved state (state_dict -> set_state_dict) the step
            captured by TrainStep.compile as one CUDA graph and replayed;
            losses, parameters, masters, moments and the count bitwise equal
            to the eager run's, the graph holding an eager step's launches, the
            counters still under replay, step seconds and the profiled busy
            share of each, and a replay with a NaN weight leaving every
            parameter, optimizer state tensor and the count bitwise
            unchanged.  train_state: the Train model cut to one layer:
            accum_steps=2 and remat (policies "dots" and "nothing") against
            the plain step (STATE_TOL, peak memory of each); 3 steps, a
            saved state restored into a fresh step, 2 steps, bitwise equal
            to 5 uninterrupted steps.  train_gpt_graph (after train_gpt):
            train_graph's comparison at Train-GPT's shape.
            train_moe_graph (each dispatch mode) and train_decoder_graph:
            those cells' steps captured too, replayed three times.
13. graphs  the serving engine's programs and generate() as CUDA
            graphs (the serve model, after serve_quant).  static_parity
            (after parity_quant): the 2-layer models through the
            static-cache path, logits within 5% of their largest.
            serve_quant_graph (in serve_quant): each quantized engine
            again after aot_warmup, its tokens equal to the eager run's.
            serve_graph: Serve's engine after aot_warmup (the decode
            replayed as one CUDA graph a step, every prefill chunk as
            one graph), tokens equal to the eager Serve run's, then
            profile_graph; again at steps_per_sync=4 and sampled
            (top_k=50, seed 7), each against an eager engine of the same
            settings; eager beside graphed: decode and output tokens/s,
            TTFT, busy share, the decode kernels' device ms a step, the
            replays' and the chunks' CUDA-event ms, capture seconds,
            launches a replay.  serve_spec:
            spec_decode=4, graphed, prompts holding a 64-token span
            twice: every request "ok" with 32 tokens; drafts proposed and
            accepted, tokens a verify, agreement with a graphed non-spec
            run (reported).  serve_static: paged_kv=False, buckets
            128..768, eager and graphed (decode, a prefill a bucket, the
            insert): tokens equal; QKV and MLP launched, paged decode
            not.  generate: LlamaForCausalLM.generate at batch 4, prompt
            512, 64 new (greedy), then GPT-2 medium (24 layers, bf16) at
            batch 8, prompt 256, 64 new: the tokens of a first and a
            timed call equal a step-by-step loop over the same
            static-cache forward, exactly; tokens/s and ms a step of
            each; the EOS / pad rule on a forced EOS id.
            serve_fleet: the Serve model behind ServingRouter fleets
            (warmed replicas sharing it): 2 mixed replicas; 1 prefill +
            1 decode at steps_per_sync=4; that with int8 KV on the
            decode tier, and on both tiers; one engine with a host KV
            tier parking half the requests mid-decode and resuming
            them.  Every request "ok" with 32 tokens; the mixed, the
            disaggregated and the parking run's tokens equal Serve's;
            handoff bytes > 0, the int8 wire about half the bf16 one;
            TTFT, tokens/s, handoff bytes and export / serialize /
            import ms a request (CUDA events), affinity counters,
            imported against skipped blocks.

14. recovery  recovery_drill (after train_gpt_graph): the JAX
            package's MTTR drill (bench.py --recovery-drill) at GPT-2
            medium's full size (24 layers, bf16, b=8, s=1024, AdamW with
            fp32 masters, the step captured by TrainStep.compile): a
            TCPStore on a free port, ranks 0 and 1 in this process (rank
            1 mirrors rank 0's snapshot), an AutoCheckpoint in a temp dir;
            8 steps, a peer snapshot, a checkpoint and an SDC check every
            3, recovery.rank_kill at step 7; then a fresh captured step
            restored from the peer snapshot and, with recovery.peer_fetch
            armed, from disk, each resumed to step 8: losses bitwise equal
            to the uninterrupted run's on both paths.  A train.sdc_flip on
            one of three sentinels detected, blamed and quarantined; with
            two, the replay breaks the tie.  multi_tensor_digest on the
            parameters bitwise equal to its plain version and to the
            JAX package's formula in numpy, timed beside its bound.
            Snapshot bytes, ship and restore seconds, MTTR, checkpoint
            write and read GB/s.
15. cold start  cold_start (after recovery_drill): two fresh processes
            at Llama-3-8B width, 4 of 32 layers, bf16, Serve's paged
            engine.  A (the repo, an empty cache) runs aot_warmup, serves
            4 prompts with 32 greedy tokens, compiles the Train-shape
            TrainStep, bundles the weights, entries and kernel libraries,
            and takes one step.  B (a copy of paddle_tpu_torch without
            build/, another empty cache) loads the bundle, warms up,
            serves, compiles and steps: 0 nvcc runs, 0 counted warm-ups,
            0 misses, hits = A's stores, weights, tokens and the loss
            bitwise equal to A's; then aot_warmup(cache_only=True) on a
            third empty cache captures nothing and serves equal tokens
            eagerly.  Seconds from process start to the first token,
            split into build, load, capture and first step.
16. op_surface (after the kernel phases): every op of the surface on
            CUDA tensors against the port's CPU run on the same inputs:
            the 304 generated ops (each schema entry's first test case,
            SCHEMA_EXTRA's inputs for the entries with none) within the
            entry's tolerance (fp32's 1e-5 / 1e-6 by default), the
            hand-written ops of ops/creation, manipulation, linalg,
            search, stat, math, logic and array_ops (surface_cases(),
            the cases tests/test_torch_ops_surface.py holds against the
            JAX package) within theirs, sorts, gathers and indices
            exactly, decompositions through their products; the random
            ops' shapes and dtypes against the CPU's, two draws under
            seed(7) equal.  Counts by module, failures by name.
17. amp     (after train_state) Paddle's dygraph AMP recipe on the Train
            cell's model, built in fp32 (Llama-3-8B width, 4 of 32
            layers, b=4, s=2048, AdamW).  amp_o1: auto_cast(O1, bf16) +
            GradScaler, 3 steps: the first loss within AMP_LOSS_TOL of
            an fp32 forward's on the same weights and batch, the
            operator stats of the first step equal to a CPU run's at one
            and two layers scaled to four (linear and the attention
            bf16, rms_norm fp32), launches exact by wrapper and dtype
            (bf16 flash forward, dq and dk/dv, fp32 QKV training variant
            and MLP: 4 a step each), an inf written into one gradient
            skipping the step (every parameter bitwise equal, the scale
            halved), then one step profiled: the fp32 first designs'
            device share.  amp_o2: decorate(model, AdamW, O2, bf16), the
            same loop, the first loss against the plain bf16 model's,
            bf16 QKV and MLP, fp32 masters.  Step time and peak beside
            the Train cell's 0.2923 s.  kernels_train carries the fp32
            QKV training variant and MLP at T = 8192 (their bound at the
            fp32 rate, the fp32 library chain) and the kernels line
            their rows and every AMP wrapper's launches_amp_o1 / _o2.

Then the kernels line, the card's name and power limit, and the last
line ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero without the last line; so it does where CUDA is
missing or the package is not beside it.  Imports nothing of JAX or of
``paddle_tpu``."""

import concurrent.futures
import contextlib
import ctypes
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12         # dense bf16 tensor-core peak
FP32_FLOP_PER_S = 67e12          # fp32 outside the tensor cores
D, DQ, DKV, F = 4096, 4096, 1024, 14336
EPS = 1e-5
# kernel vs plain version, (atol, rtol): fp32 differs by summation order
# only; bf16 outputs carry a final bf16 rounding (2^-8 relative) of fp32
# sums taken in another order, and bf16-rounded intermediates (xn, h)
TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (3e-2, 3e-2)}
# the flash rows' bf16 limits, (atol, rtol).  Each output is a bf16
# rounding of an fp32 sum, so kernel and plain version may differ by one
# bf16 step, at most 2^-7 of the value; atol covers the P and dS
# roundings that the kernel's running max and summation order move.
# fwd and dq values are small (a causal row over n keys has |out| ~
# sqrt(e/n), 0.035 median at s=2048); dk and dv reach ~8.
FLASH_TOL = {"fwd": (4e-3, 2 ** -7), "dq": (4e-3, 2 ** -7),
             "dkv": (8e-3, 2 ** -7)}
# the paged decode rows' bf16 limit (fp and int8 pools): the same one-step
# bound; an output is a softmax average over n tokens of unit-normal V, so
# |out| ~ sqrt(e/n), 0.035-0.09 for most rows at lengths 147..1024
PAGED_TOL = (4e-3, 2 ** -7)
# the quant matmul's bf16 limit: codes up-convert exactly, so kernel and
# plain version differ by the fp32 summation order and one bf16 rounding
QUANT_MM_TOL = (2e-3, 2 ** -7)
# the cross-entropy rows' limits, (atol, rtol): loss and lse are fp32 sums
# of V exponentials in another order (and __expf, ~2 ulp) on both sides;
# dx is one rounding to the logits' type of fp32 values that differ by
# those few ulp, so in bf16 at most one bf16 step (2^-7 of the value)
CE_TOL = {"loss": (1e-4, 1e-5), "lse": (1e-4, 1e-5),
          "dx_bf16": (1e-7, 2 ** -7), "dx_fp32": (1e-7, 1e-5)}


# the kernels redesigned for Hopper (wgmma, TMA, mbarriers; the quant
# matmul's split-K on mma.sync), whose -Xptxas -v the ptxas line reports
# (none may spill or serialise its wgmma), and their sources
PTXAS_SOURCES = ("flash_attention", "fused_block", "quant_matmul",
                 "fused_decoder", "grouped_matmul", "paged_attention",
                 "rmsnorm")
PTXAS_KERNELS = ("flash_fwd_hopper", "flash_dq_hopper", "flash_dkv_hopper",
                 "qkv_gemm_kernel", "qkv_rows_kernel", "mlp_gemm_kernel",
                 "quant_splitk_kernel", "quant_wgmma_kernel",
                 "decoder_hopper", "grouped_hopper", "qkv_splitk_kernel",
                 "paged_split_kernel", "mlp_splitk_kernel",
                 "rmsnorm_regs_kernel")
# the chunked CE at FLAGS_default_matmul_precision="default" (TF32 chunk
# products on the card) against "float32" (exact fp32): TF32 rounds each
# operand to a 10-bit mantissa (2^-11 relative), so a logit moves by a few
# 1e-4 of its terms' scale; the loss is a mean of logsumexps and moves far
# less.  Limits: loss relative, each gradient's max abs difference over
# its largest |g|, by the CE's io dtype, set from the largest errors
# measured on the card (PERF.md, section 6).  bf16 h and W (ce_device at
# the training shapes): products of bf16 operands are exact in TF32 as
# in fp32, so the loss moves by the summation order alone (8.3e-7) and
# dh, dW by one bf16 rounding of a few outputs (4.5e-3 of the largest):
# about five and two times those.  Such a gate cannot tell TF32 from one
# bf16 pass, which rounds nothing more there (ce_device reports that
# control).  fp32 h and W (train_parity_tf32, a 1-layer model): TF32
# rounds every operand (loss 6.4e-7, worst gradient 3.9e-4 of its
# largest); the control with bf16 operands must break these limits.
CE_TF32_TOL = {"bfloat16": {"loss_rel": 4e-6, "grad_of_max": 1e-2},
               "float32": {"loss_rel": 4e-6, "grad_of_max": 1.5e-3}}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def gemm_paths(kernels):
    """Each GEMM wrapper's launches by design (``launches_by_path``:
    splitk / wgmma / tile), and the paged decode's (split / direct)."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as QM
    return {fn.__name__: dict(fn.launches_by_path)
            for fn in (kernels.fused_rmsnorm_qkv, kernels.fused_mlp,
                       kernels.fused_ffn, QM.quant_matmul,
                       kernels.fused_decoder_block,
                       kernels.grouped_expert_ffn,
                       kernels.paged_decode_attention,
                       kernels.paged_decode_attention_int8)}


def require_paths(what, got, want):
    """Raise unless every (wrapper, path) of `want` launched exactly the
    count given, or at least once where it gives None."""
    for (name, path), n in want.items():
        have = got[name][path]
        if (have < 1) if n is None else (have != n):
            raise AssertionError(f"{what}: {name} took its {path} path "
                                 f"{have} times, expected "
                                 f"{'some' if n is None else n}; {got}")


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of `fn` over `iters` launches, CUDA events around
    each launch; a 256 MB write before each evicts the 50 MB L2, so the
    weights come from device memory as they do in the model, where every
    layer reads its own.  Then the card spins for BUSY_CYCLES (~0.5 ms),
    so the host has enqueued `fn`'s launches before the first event is
    reached: a wrapper's host time, which on the card's machine can
    exceed the write's device time, would otherwise count as device
    time.  With BUSY_CYCLES = 0 it is the timer without the spin, as
    compare_decode.py uses it beside this one."""

    BUSY_CYCLES = 1_000_000

    def __init__(self, dev):
        self.scrub = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def __call__(self, fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        pairs = []
        for _ in range(iters):
            self.scrub.zero_()
            if self.BUSY_CYCLES:
                torch.cuda._sleep(self.BUSY_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters


def no_spin(timer, fn, **kw):
    """`timer`'s mean device ms of `fn` without the spin before each
    launch: a slow enqueue by the host then lands between the events, so
    beside the spin's figure it shows the wrapper's host share."""
    timer.BUSY_CYCLES = 0
    try:
        return timer(fn, **kw)
    finally:
        del timer.BUSY_CYCLES


# profiler sessions a per-launch reading may take: the card machine's
# profiler has returned a window with no device events at all, once in
# several runs of this script, where the same call in the next window
# showed every launch
PROFILE_SESSIONS = 3


def launch_us(timer, fn, iters=5):
    """Device microseconds of each kernel that `fn` launches, by kernel
    name, the mean over `iters` calls under torch.profiler with the L2
    scrub before each (the scrub's own fill kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            timer.scrub.zero_()
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / iters for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "fill" not in e.key.lower()}


def splitk_launches(timer, fn, ms, up, down, sms):
    """The MLP / FFN split-K call's two launches: each one's split count,
    device us and weight bytes over that time.  The first launch's us is
    its profiled span; the down product is a dependent launch whose span
    opens during the first one's, so its us is the rest of the call's
    `ms` (the Timer's).  Where the profiler closes the first span under
    the dependent launch varies from run to run, so the two shares do
    too; their sum is the call's.  `up` and `down`: (K, N, weight
    bytes)."""
    from paddle_tpu_torch.ops.kernels import splitk as SK
    for sessions in range(1, PROFILE_SESSIONS + 1):
        spans, seen = {}, launch_us(timer, fn)
        for key, us in seen.items():
            m = re.search(r"mlp_splitk_kernel<(\d+), \d+, \d+>", key)
            if m is not None:
                spans["down" if int(m.group(1)) == 2 else "up"] = us
        if set(spans) == {"up", "down"}:
            break
    else:
        raise AssertionError(f"split-K launches not both profiled in "
                             f"{PROFILE_SESSIONS} sessions: {spans}; the "
                             f"last saw {sorted(seen)}")
    out = {}
    for name, (K, N, nbytes), us in (
            ("up", up, spans["up"]), ("down", down, 1e3 * ms - spans["up"])):
        out[name] = {"us": us, "splits": SK.mlp_splits(K, N, sms),
                     "weight_bytes": nbytes, "tb_per_s": nbytes / us / 1e6}
    out["down"]["profiled_span_us"] = spans["down"]
    out["profiler_sessions"] = sessions
    return out


def bound_ms(nbytes, flops, flop_per_s=BF16_FLOP_PER_S):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flop_per_s * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


# the bounds' inputs, (bytes, flops) of each kernel's function at a shape:
# each input read once, each output written once (item: the io dtype's
# bytes).  The wrappers charge the cost model the same numbers
# (ops/kernels/costs.py; tests/test_torch_cost_model.py holds the two
# equal).

def qkv_io(T, item=2, train=False, d=D, dq=DQ, dkv=DKV):
    """RMSNorm + QKV (the training variant also writes xn and inv)."""
    n = dq + 2 * dkv
    nbytes = item * (T * d + d + d * n + T * n)
    if train:
        nbytes += item * T * d + 4 * T
    return nbytes, 2 * T * d * n


def mlp_io(T, item=2, d=D, f=F):
    """The SwiGLU MLP: x and three weights read, y written."""
    return item * (2 * T * d + 3 * d * f), 6 * T * d * f


def paged_io(B, h, kvh, hd, mb, tokens, int8=False):
    """Paged decode (bf16 q) over the live tokens: each token's K and V
    read once (int8 rows plus one fp32 scale each: 264 bytes per token
    and kv head at head_dim 128; bf16 pools: 512), the table and the
    lengths read."""
    per_token = kvh * 2 * ((hd + 4) if int8 else 2 * hd)
    return (2 * (2 * B * h * hd) + tokens * per_token + 4 * (B * mb + B),
            4 * tokens * h * hd)


def quant_io(T, K, N, isz):
    """x read, the one-byte weight and its fp32 scales read, y written."""
    return T * K * isz + K * N + 4 * N + T * N * isz, 2 * T * K * N


def ce_io(T, V, isz):
    """(forward, backward): the logits read once, the int64 labels read,
    loss and lse written (forward); lse and the cotangent read and dx
    written (backward); 4 fp32 operations an element."""
    nbytes = T * V * isz + 8 * T
    return ((nbytes + 8 * T, 4 * T * V),
            (nbytes + 8 * T + T * V * isz, 4 * T * V))


def ffn_io(T, isz, d, f):
    """act(x @ w1 + b1) @ w2 + b2: x, both weights and biases read."""
    return (2 * T * d + 2 * d * f + f + d) * isz, 4 * T * d * f


def grouped_io(n, G, C, isz, E, d, h):
    """The n routed rows read, every expert's weights read, y written
    whole (zeros past the counts), the counts read."""
    return (n * d * isz + E * (2 * d * h + h + d) * isz + G * C * d * isz
            + 4 * G, 4 * n * d * h)


def rmsnorm_io(T, d, item, res):
    """x (and r) read, y (and h) written, the weight read and inv written:
    without a residual h is x."""
    return item * (T * d * (2 + 2 * res) + d) + 4 * T, 5 * T * d


def adam_io(params, grads, masters):
    """The multi-tensor update: grad, moments and master read once,
    param, moments and master written once (with a master the kernel never
    reads the bf16 param, without one it does)."""
    n = sum(p.numel() for p in params)
    return sum(p.numel() * (gg.element_size() + 16 + p.element_size()
                            + (8 if ma is not None else p.element_size()))
               for p, gg, ma in zip(params, grads, masters)), MT_OPS * n


def norm_io(tensors):
    """The global norm: every tensor read once, two operations each."""
    return (sum(t.numel() * t.element_size() for t in tensors),
            2 * sum(t.numel() for t in tensors))


def digest_io(tensors):
    """The digest: every tensor read once, the per-tensor sums and the
    digest written (4 bytes each); one integer add an element."""
    return (sum(t.numel() * t.element_size() for t in tensors)
            + 4 * (len(tensors) + 1), sum(t.numel() for t in tensors))


def check_close(what, got, ref, dtype, tol=None, used=None):
    """Max abs error of `got` against `ref`, raising where an element is
    outside atol + rtol |ref| (`tol`, else TOL[dtype]); with a dict
    `used`, records under `what` the largest share of its limit that an
    element takes."""
    atol, rtol = tol or TOL[dtype]
    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    err = float(diff.max())
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    limit = atol + rtol * r.abs()
    bad = diff > limit
    if bool(bad.any()):
        raise AssertionError(f"{what} [{dtype}]: {int(bad.sum())} elements "
                             f"outside atol={atol} rtol={rtol}; max abs "
                             f"err {err}")
    if used is not None:
        used[what] = float((diff / limit).max())
    return err


def rand(g, shape, dtype, dev, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


# -- phase 3: the kernels at the path's shapes -------------------------------

def kernel_qkv(FB, dev, timer, T, plain_iters=10):
    """The QKV kernel's forward variant at T rows: 1, 8 and 16 decode
    steps (bf16: split-K, whose output must be bitwise equal over two
    calls), 256 a prefill chunk (the wgmma GEMM), 8192 the 32-layer
    scoring forward at the default tier."""
    g = torch.Generator(device=dev).manual_seed(T)
    errs, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = rand(g, (T, D), dtype, dev)
        wn = rand(g, (D,), dtype, dev, 0.1) + 1
        s = (2.0 / (D + DQ)) ** 0.5
        wq = rand(g, (D, DQ), dtype, dev, s)
        wk = rand(g, (D, DKV), dtype, dev, s)
        wv = rand(g, (D, DKV), dtype, dev, s)
        n0 = dict(FB.fused_rmsnorm_qkv.launches_by_path)
        got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS)
        path = FB.qkv_path(T, dtype)
        n0[path] += 1
        if FB.fused_rmsnorm_qkv.launches_by_path != n0:
            raise AssertionError(f"fused_rmsnorm_qkv T={T} {dtype}: not on "
                                 f"its {path} path")
        ref = FB.qkv_reference(x, wn, wq, wk, wv, EPS)
        errs[str(dtype)] = max(check_close(f"fused_rmsnorm_qkv T={T} {n}",
                                           a, b, dtype)
                               for n, a, b in zip("qkv", got, ref))
        if path == "splitk":
            again = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"fused_rmsnorm_qkv T={T}: split-K "
                                     "differs between two calls")
            out["bitwise_equal_twice"] = True
            out["splits"] = FB.qkv_splits(D, DQ, DKV, torch.cuda.
                                          get_device_properties(dev).
                                          multi_processor_count)
        del got, ref
    F_ = torch.nn.functional
    out["ms"] = timer(lambda: FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS))
    out["plain_ms"] = timer(lambda: FB.qkv_reference(x, wn, wq, wk, wv, EPS),
                            iters=plain_iters)

    def library():
        xn = F_.rms_norm(x, (D,), wn, EPS)
        return xn @ wq, xn @ wk, xn @ wv
    out["library_ms"] = timer(library)
    out["bound_ms"], out["bound_by"] = bound_ms(*qkv_io(T))
    out["max_abs_err"] = errs[str(torch.bfloat16)]
    out["max_abs_err_fp32"] = errs[str(torch.float32)]
    out["shape"] = f"T={T} d={D} dq={DQ} dkv={DKV} bf16"
    out["kernel_path"] = FB.qkv_path(T, torch.bfloat16)
    return out


def kernel_mlp(FB, dev, timer, T, plain_iters=10):
    """The gated MLP kernel pair at T rows: 1, 8 and 16 decode steps (bf16:
    split-K, bitwise equal over two calls, each launch's split count and
    TB/s from the profiler), 256 a prefill chunk (the wgmma ring), and the
    train step's T = b * s = 8192 runs the same pair in its forward; each
    call on its path (``launches_by_path``), timed with the spin and
    without it beside the library chain."""
    g = torch.Generator(device=dev).manual_seed(100 + T)
    errs, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = rand(g, (T, D), dtype, dev)
        wg = rand(g, (D, F), dtype, dev, (2.0 / (D + F)) ** 0.5)
        wu = rand(g, (D, F), dtype, dev, (2.0 / (D + F)) ** 0.5)
        wd = rand(g, (F, D), dtype, dev, (2.0 / (D + F)) ** 0.5)
        n0 = dict(FB.fused_mlp.launches_by_path)
        got = FB.fused_mlp(x, wg, wu, wd)
        path = FB.gemm_path(T, dtype)
        n0[path] += 1
        if FB.fused_mlp.launches_by_path != n0:
            raise AssertionError(f"fused_mlp T={T} {dtype}: not on its "
                                 f"{path} path")
        errs[str(dtype)] = check_close(f"fused_mlp T={T}", got,
                                       FB.mlp_reference(x, wg, wu, wd), dtype)
        if path == "splitk":
            if not torch.equal(got, FB.fused_mlp(x, wg, wu, wd)):
                raise AssertionError(f"fused_mlp T={T}: split-K differs "
                                     "between two calls")
            out["bitwise_equal_twice"] = True
        del got
    F_ = torch.nn.functional

    def kernel():
        return FB.fused_mlp(x, wg, wu, wd)

    def library():
        return (F_.silu(x @ wg) * (x @ wu)) @ wd
    out["ms"] = timer(kernel)
    out["ms_no_spin"] = no_spin(timer, kernel)
    out["plain_ms"] = timer(lambda: FB.mlp_reference(x, wg, wu, wd),
                            iters=plain_iters)
    out["library_ms"] = timer(library)
    out["library_ms_no_spin"] = no_spin(timer, library)
    out["bound_ms"], out["bound_by"] = bound_ms(*mlp_io(T))
    out["max_abs_err"] = errs[str(torch.bfloat16)]
    out["max_abs_err_fp32"] = errs[str(torch.float32)]
    # the two-launch design's extra traffic: h written, then read back
    out["workspace_bytes"] = 2 * T * F * 2
    out["shape"] = f"T={T} d={D} f={F} bf16"
    out["path"] = FB.gemm_path(T, torch.bfloat16)
    if out["path"] == "splitk":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        out["launches"] = splitk_launches(timer, kernel, out["ms"],
                                          (D, F, 4 * D * F),
                                          (F, D, 2 * D * F), sms)
    return out


def kernel_paged(PA, dev, timer):
    B, h, kvh, hd, bs, mb = 8, 32, 8, 128, 16, 64
    nb = 1 + B * mb
    g = torch.Generator(device=dev).manual_seed(7)
    lengths = torch.linspace(1, mb * bs, B).round().to(torch.int32).to(dev)
    # each row's blocks are a random slice of a permutation of 1..nb-1
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    bt = perm.reshape(B, mb).to(torch.int32).contiguous()
    errs, out, used = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(g, (B, h, hd), dtype, dev)
        kp = rand(g, (nb, bs, kvh, hd), dtype, dev)
        vp = rand(g, (nb, bs, kvh, hd), dtype, dev)
        got = paged_twice(PA, PA.paged_decode_attention, out, q, kp, vp, bt,
                          lengths)
        errs[str(dtype)] = check_close(
            "paged_decode_attention", got,
            PA.paged_decode_reference(q, kp, vp, bt, lengths), dtype,
            *paged_limit(dtype, used))
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
    out["bound_ms"], out["bound_by"] = bound_ms(
        *paged_io(B, h, kvh, hd, mb, int(lengths.sum())))
    out["max_abs_err"] = errs[str(torch.bfloat16)]
    out["max_abs_err_fp32"] = errs[str(torch.float32)]
    out["tolerance_bf16"] = dict(zip(("atol", "rtol"), PAGED_TOL))
    out["limit_used_bf16"] = used["paged_decode_attention"]
    out["shape"] = (f"B={B} h={h} kvh={kvh} hd={hd} bs={bs} "
                    f"lengths={lengths.tolist()}")
    return out


def paged_twice(PA, fn, out, *args):
    """Two calls of the paged wrapper `fn`: both on the split design
    (the table is 64 blocks of 16, 8 splits), bitwise equal (the merge
    sums the partials in split order whichever split arrives last);
    records the path and the split count in `out`."""
    n0 = dict(fn.launches_by_path)
    got = fn(*args)
    again = fn(*args)
    n0["split"] += 2
    if fn.launches_by_path != n0:
        raise AssertionError(f"{fn.__name__}: not on the split design "
                             f"{fn.launches_by_path}")
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{fn.__name__}: two calls differ")
    from paddle_tpu_torch.ops.kernels import _build
    lib = _build.library("paged_attention")
    out.update(kernel_path="split", bitwise_equal_twice=True,
               splits=lib.ptt_paged_splits(args[3].shape[1],
                                           args[1].shape[1]))
    return got


def paged_limit(dtype, used):
    """check_close's (tol, used) for a paged decode row: PAGED_TOL and
    the share of it used in bf16, TOL in fp32."""
    return (PAGED_TOL, used) if dtype == torch.bfloat16 else (None, None)


# -- phase 3, training rows: flash attention and the QKV train variant -------

FB_, FS, FH, FHK, FD = 4, 2048, 32, 8, 128       # the train step's attention
# GPT-2 medium's step through the head_dim pad (64 -> 128): b, s, h, hk
GPT_FLASH = (8, 1024, 16, 16)


def flash_bounds(b, s=FS, h=FH, hk=FHK):
    """(fwd, dq, dkv) (bytes, flops) of causal attention: each input read
    once, each output written once; a causal product is half the dense
    one, 2 b h s^2 d / 2 FLOPs."""
    q = b * s * h * FD * 2
    kv = b * s * hk * FD * 2
    stat = b * h * s * 4
    prod = 2 * b * h * s * s * FD // 2
    return ((q + 2 * kv + q + stat, 2 * prod),
            (q + 2 * kv + q + 2 * stat + q, 3 * prod),
            (q + 2 * kv + q + 2 * stat + 2 * kv, 4 * prod))


def flash_parity(FA, dev, dtype, b, s, h, hk, used):
    """The three flash kernels against their plain versions at one shape
    (causal; bf16 rows within FLASH_TOL, the share of it used recorded in
    `used`); returns the errors and the inputs with the kernel forward's
    lse and delta."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = rand(g, (b, s, h, FD), dtype, dev)
    k = rand(g, (b, s, hk, FD), dtype, dev)
    v = rand(g, (b, s, hk, FD), dtype, dev)
    do = rand(g, (b, s, h, FD), dtype, dev)

    def close(what, got, ref, row):
        if dtype != torch.bfloat16:
            return check_close(what, got, ref, dtype)
        return check_close(what, got, ref, dtype, FLASH_TOL[row],
                           used.setdefault(row, {}))

    out, lse = FA.flash_attention_fwd(q, k, v, True)
    ref, ref_lse = FA.flash_fwd_reference(q, k, v, True)
    e_out = close("flash_attention_fwd", out, ref, "fwd")
    check_close("flash_attention_fwd lse", lse, ref_lse, torch.float32)
    del ref, ref_lse
    delta = FA.flash_delta(out, do)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True)
    rdq, rdk, rdv = FA.flash_bwd_reference(q, k, v, do, lse, delta, True)
    errs = {
        "flash_attention_fwd": e_out,
        "flash_attention_bwd_dq": close("flash_attention_bwd_dq", dq, rdq,
                                        "dq"),
        "flash_attention_bwd_dkv": max(
            close("flash_attention_bwd_dk", dk, rdk, "dkv"),
            close("flash_attention_bwd_dv", dv, rdv, "dkv"))}
    del out, dq, dk, dv, rdq, rdk, rdv
    torch.cuda.empty_cache()
    return errs, (q, k, v, do, lse, delta)


def flash_timed(FA, timer, tensors, shape, errs, used):
    """The three kernels timed in bf16 at one shape beside their plain
    versions and F.scaled_dot_product_attention (forward; its autograd
    backward, dq, dk and dv together, for the two backward rows), with
    their bounds; and flash_delta, the reduction before every
    backward."""
    F_ = torch.nn.functional
    q, k, v, do, lse, delta = tensors
    b, s, h, hk = shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_in = [t.detach().clone().requires_grad_(True) for t in (qt, kt, vt)]
    lib_out = F_.scaled_dot_product_attention(*lib_in, is_causal=True,
                                              enable_gqa=True)
    do_t = do.transpose(1, 2)

    def lib_bwd():
        torch.autograd.grad(lib_out, lib_in, do_t, retain_graph=True)

    lib_bwd_ms = timer(lib_bwd)
    calls = {
        "flash_attention_fwd": (
            lambda: FA.flash_attention_fwd(q, k, v, True),
            lambda: FA.flash_fwd_reference(q, k, v, True),
            timer(lambda: F_.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))),
        "flash_attention_bwd_dq": (
            lambda: FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
            lambda: FA.flash_bwd_reference(q, k, v, do, lse, delta, True),
            lib_bwd_ms),
        "flash_attention_bwd_dkv": (
            lambda: FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               True),
            lambda: FA.flash_bwd_reference(q, k, v, do, lse, delta, True),
            lib_bwd_ms),
    }
    res = {}
    for (name, (kern, plain, lib_ms)), (nbytes, flops) in zip(
            calls.items(), flash_bounds(b, s, h, hk)):
        out = {"ms": timer(kern), "plain_ms": timer(plain, iters=3,
                                                    warmup=1),
               "library_ms": lib_ms}
        out["bound_ms"], out["bound_by"] = bound_ms(nbytes, flops)
        out["max_abs_err"] = errs[name]
        row = name.rsplit("_", 1)[-1]
        out["tolerance_bf16"] = dict(zip(("atol", "rtol"), FLASH_TOL[row]))
        out["limit_used_bf16"] = used[row]
        out["flops"] = flops
        out["shape"] = f"b={b} s={s} h={h} hk={hk} d={FD} causal bf16"
        res[name] = out
        torch.cuda.empty_cache()
    res["flash_attention_fwd"]["library"] = \
        "F.scaled_dot_product_attention(enable_gqa=True)"
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        res[name]["library"] = ("autograd backward of "
                                "F.scaled_dot_product_attention (dq, dk "
                                "and dv together)")
    # delta = rowsum(dO * O): O read from the forward's output
    out = FA.flash_attention_fwd(q, k, v, True)[0]
    res["flash_delta"] = {
        "ms": timer(lambda: FA.flash_delta(out, do)),
        "bound_ms": bound_ms(2 * q.numel() * 2 + 4 * b * h * s, 0)[0],
        "bound_by": "bytes",
        "shape": f"b={b} s={s} h={h} d={FD} bf16 -> fp32 [b, h, s]"}
    del lib_out, lib_in, out
    torch.cuda.empty_cache()
    return res


def kernel_flash(FA, dev, timer):
    """The three flash kernels against their plain versions (fp32 at b=1
    and bf16 at the train step's shape, bf16 at GPT-2 medium's step
    through the head_dim pad, b=8 s=1024 16 heads), then timed in bf16 at
    both bf16 shapes (flash_timed); the GPT rows carry the suffix
    ``_gpt``."""
    errs32 = flash_parity(FA, dev, torch.float32, 1, FS, FH, FHK, {})[0]
    torch.cuda.empty_cache()
    res = {}
    for suffix, shape in (("", (FB_, FS, FH, FHK)), ("_gpt", GPT_FLASH)):
        used = {}
        errs, tensors = flash_parity(FA, dev, torch.bfloat16, *shape, used)
        rows = flash_timed(FA, timer, tensors, shape, errs, used)
        del tensors
        torch.cuda.empty_cache()
        for name, row in rows.items():
            if not suffix and name in errs32:
                row["max_abs_err_fp32"] = errs32[name]
            res[name + suffix] = row
    return res


def kernel_qkv_train(FB, dev, timer, T=8192):
    """The QKV kernel's training variant (q, k, v, xn, inv) at the
    train step's T = b * s rows."""
    g = torch.Generator(device=dev).manual_seed(T + 1)
    errs, out = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x = rand(g, (T, D), dtype, dev)
        wn = rand(g, (D,), dtype, dev, 0.1) + 1
        s = (2.0 / (D + DQ)) ** 0.5
        wq = rand(g, (D, DQ), dtype, dev, s)
        wk = rand(g, (D, DKV), dtype, dev, s)
        wv = rand(g, (D, DKV), dtype, dev, s)
        got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS, residuals=True)
        ref = FB.qkv_reference(x, wn, wq, wk, wv, EPS, residuals=True)
        errs[dtype] = max(check_close(f"fused_rmsnorm_qkv train {n}", a, b_,
                                      dtype if n != "inv" else torch.float32)
                          for n, a, b_ in zip(("q", "k", "v", "xn", "inv"),
                                              got, ref))
        del got, ref
    F_ = torch.nn.functional
    out["ms"] = timer(lambda: FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS,
                                                   residuals=True))
    out["plain_ms"] = timer(lambda: FB.qkv_reference(
        x, wn, wq, wk, wv, EPS, residuals=True), iters=3, warmup=1)

    def library():
        xn = F_.rms_norm(x, (D,), wn, EPS)
        return xn @ wq, xn @ wk, xn @ wv
    out["library_ms"] = timer(library)
    out["bound_ms"], out["bound_by"] = bound_ms(*qkv_io(T, train=True))
    out["max_abs_err"] = errs[torch.bfloat16]
    out["max_abs_err_fp32"] = errs[torch.float32]
    out["shape"] = f"T={T} d={D} dq={DQ} dkv={DKV} bf16"
    return out


# -- phase 3, quantized serving rows: quant matmul and int8 paged decode -----

# the (K, N) of a decode step's quantized projections: 7 per layer and the
# lm_head, 225 launches a step at 32 layers
QUANT_SHAPES = {"q_proj/o_proj": (D, DQ), "k_proj/v_proj": (D, DKV),
                "gate_proj/up_proj": (D, F), "down_proj": (F, D),
                "lm_head": (D, 128256)}


def kernel_quant(QM, quantize, dev, timer, T, K, N, mode, dtype):
    """One quant-matmul shape: the kernel against its plain version, then
    timed beside it and the library call, a bf16 (or fp32) torch.matmul
    with the weight dequantized beforehand (what the unquantized engine
    pays: twice the weight bytes in bf16)."""
    g = torch.Generator(device=dev).manual_seed(T + K + N)
    x = rand(g, (T, K), dtype, dev)
    qw, scale = quantize(rand(g, (K, N), torch.float32, dev, K ** -0.5),
                         mode)
    got = QM.quant_matmul(x, qw, scale, mode=mode)
    tol = QUANT_MM_TOL if dtype == torch.bfloat16 else TOL[dtype]
    what, used = f"quant_matmul {mode} T={T} K={K} N={N}", {}
    err = check_close(what, got, QM.quant_matmul_reference(x, qw, scale),
                      dtype, tol, used)
    path = QM.kernel_path(T, dtype)
    if path == "splitk" and not torch.equal(
            got, QM.quant_matmul(x, qw, scale, mode=mode)):
        raise AssertionError(f"{what}: split-K differs between two calls")
    del got
    w = (qw.float() * scale).to(dtype)
    out = {"ms": timer(lambda: QM.quant_matmul(x, qw, scale, mode=mode)),
           "plain_ms": timer(lambda: QM.quant_matmul_reference(x, qw,
                                                               scale)),
           "library_ms": timer(lambda: x @ w)}
    isz = x.element_size()
    out["bound_ms"], out["bound_by"] = bound_ms(
        *quant_io(T, K, N, isz),
        BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S)
    out["max_abs_err"] = err
    out["tolerance"] = dict(zip(("atol", "rtol"), tol))
    out["limit_used"] = used[what]
    out["weight_bytes"] = K * N + 4 * N
    out["shape"] = f"T={T} K={K} N={N} {mode} {str(dtype)[6:]}"
    out["path"] = path
    if path == "splitk":
        from paddle_tpu_torch.ops.kernels import splitk as SK
        splits = SK.splitk_splits(
            K, N, torch.cuda.get_device_properties(dev).multi_processor_count)
        out["splits"] = splits
        out["workspace_bytes"] = 4 * splits * T * N if splits > 1 else 0
        out["bitwise_equal_twice"] = True
    del w, qw, x
    torch.cuda.empty_cache()
    return out


def kernel_quant_rows(QM, quantize, dev, timer):
    """The quant matmul at the decode step's five shapes (T = 8, int8,
    bf16), at every shape again through the prefill's 64-row tile with a
    partial last tile (T = 150, int8 and fp8), the prefill chunk's
    T = 256, fp8 at T = 8 and 256, and one fp32-io row."""
    rows = {}
    for name, (K, N) in QUANT_SHAPES.items():
        rows[f"int8 T=8 {name}"] = kernel_quant(QM, quantize, dev, timer, 8,
                                                K, N, "int8", torch.bfloat16)
    for mode in ("int8", "fp8"):
        for name, (K, N) in QUANT_SHAPES.items():
            rows[f"{mode} T=150 {name}"] = kernel_quant(
                QM, quantize, dev, timer, 150, K, N, mode, torch.bfloat16)
    K, N = QUANT_SHAPES["gate_proj/up_proj"]
    for mode, T, dtype in (("int8", 256, torch.bfloat16),
                           ("fp8", 8, torch.bfloat16),
                           ("fp8", 256, torch.bfloat16),
                           ("int8", 8, torch.float32)):
        rows[f"{mode} T={T} gate_proj/up_proj {str(dtype)[6:]}"] = \
            kernel_quant(QM, quantize, dev, timer, T, K, N, mode, dtype)
    return rows


def kernel_paged_int8(PA, quantize_kv, dev, timer):
    """The int8 paged decode at the fp row's shapes (B = 8, 32/8 heads,
    head_dim 128, block 16, lengths 1..1024), q in bf16 and fp32; the
    library yardstick gathers, dequantizes and calls SDPA."""
    B, h, kvh, hd, bs, mb = 8, 32, 8, 128, 16, 64
    nb = 1 + B * mb
    g = torch.Generator(device=dev).manual_seed(7)
    lengths = torch.linspace(1, mb * bs, B).round().to(torch.int32).to(dev)
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    bt = perm.reshape(B, mb).to(torch.int32).contiguous()
    errs, out, used = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q = rand(g, (B, h, hd), dtype, dev)
        kp, ks = quantize_kv(rand(g, (nb, bs, kvh, hd), dtype, dev))
        vp, vs = quantize_kv(rand(g, (nb, bs, kvh, hd), dtype, dev))
        got = paged_twice(PA, PA.paged_decode_attention_int8, out, q, kp, vp,
                          bt, lengths, ks, vs)
        errs[str(dtype)] = check_close(
            "paged_decode_attention_int8", got,
            PA.paged_decode_reference(q, kp, vp, bt, lengths, k_scale=ks,
                                      v_scale=vs), dtype,
            *paged_limit(dtype, used))
    F_ = torch.nn.functional
    out["ms"] = timer(lambda: PA.paged_decode_attention_int8(
        q, kp, vp, bt, lengths, ks, vs))
    out["plain_ms"] = timer(lambda: PA.paged_decode_reference(
        q, kp, vp, bt, lengths, k_scale=ks, v_scale=vs))
    live = (torch.arange(mb * bs, device=dev)[None, :]
            < lengths.long()[:, None])[:, None, None, :]

    def library():
        idx = bt.long()
        kb = (kp[idx].float() * ks[idx][..., None]).to(q.dtype)
        vb = (vp[idx].float() * vs[idx][..., None]).to(q.dtype)
        kb = kb.reshape(B, mb * bs, kvh, hd).transpose(1, 2)
        vb = vb.reshape(B, mb * bs, kvh, hd).transpose(1, 2)
        return F_.scaled_dot_product_attention(q[:, :, None], kb, vb,
                                               attn_mask=live,
                                               enable_gqa=True)
    out["library_ms"] = timer(library)
    out["bound_ms"], out["bound_by"] = bound_ms(
        *paged_io(B, h, kvh, hd, mb, int(lengths.sum()), int8=True))
    out["max_abs_err"] = errs[str(torch.bfloat16)]
    out["max_abs_err_fp32"] = errs[str(torch.float32)]
    out["tolerance_bf16"] = dict(zip(("atol", "rtol"), PAGED_TOL))
    out["limit_used_bf16"] = used["paged_decode_attention_int8"]
    out["shape"] = (f"B={B} h={h} kvh={kvh} hd={hd} bs={bs} int8 pools "
                    f"lengths={lengths.tolist()}")
    return out


# -- phase 9, kernel rows: the fused softmax cross-entropy --------------------

GPT_V, GPT_T = 50304, 8192          # GPT-2 medium's padded vocab, b * s


def kernel_ce(CE, dev, timer, T, V, dtype, ignored=0):
    """The CE forward and backward kernels against their plain versions
    (loss, lse, dx within CE_TOL), then each timed beside its plain
    version, F.cross_entropy on fp32 logits (forward; the backward of
    its autograd graph) and its bound: the logits read once (and dx
    written once), 4 fp32 operations an element."""
    F_ = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(T + V)
    x = rand(g, (T, V), dtype, dev, 2.0)
    lbl = torch.randint(0, V, (T,), generator=g, device=dev)
    if ignored:
        lbl[::T // ignored] = -100     # outside [0, V): no gold, loss = lse
    cot = rand(g, (T,), torch.float32, dev)
    errs, used = {}, {}
    loss, lse = CE.cross_entropy_fwd(x, lbl)
    rloss, rlse = CE.ce_fwd_reference(x, lbl)
    errs["loss"] = check_close(f"ce loss T={T} V={V}", loss, rloss, dtype,
                               CE_TOL["loss"], used)
    errs["lse"] = check_close(f"ce lse T={T} V={V}", lse, rlse, dtype,
                              CE_TOL["lse"], used)
    del rloss, rlse
    dkey = "dx_bf16" if dtype == torch.bfloat16 else "dx_fp32"
    dx = CE.cross_entropy_bwd(x, lbl, lse, cot)
    errs["dx"] = check_close(f"ce dx T={T} V={V}", dx,
                             CE.ce_bwd_reference(x, lbl, lse, cot), dtype,
                             CE_TOL[dkey], used)
    del dx
    torch.cuda.empty_cache()
    xf = x.float().requires_grad_(True)
    safe = lbl.clamp(0, V - 1)
    lib_loss = F_.cross_entropy(xf, safe, reduction="none")

    def lib_bwd():
        torch.autograd.grad(lib_loss, xf, cot, retain_graph=True)

    fwd_io, bwd_io = ce_io(T, V, x.element_size())
    rows = {}
    for name, kern, plain, lib, (nb, ops) in (
            ("cross_entropy_fwd", lambda: CE.cross_entropy_fwd(x, lbl),
             lambda: CE.ce_fwd_reference(x, lbl),
             lambda: F_.cross_entropy(xf.detach(), safe, reduction="none"),
             fwd_io),
            ("cross_entropy_bwd",
             lambda: CE.cross_entropy_bwd(x, lbl, lse, cot),
             lambda: CE.ce_bwd_reference(x, lbl, lse, cot), lib_bwd,
             bwd_io)):
        out = {"ms": timer(kern), "plain_ms": timer(plain, iters=3,
                                                    warmup=1),
               "library_ms": timer(lib, iters=5)}
        out["bound_ms"], out["bound_by"] = bound_ms(nb, ops,
                                                    FP32_FLOP_PER_S)
        out["bytes"] = nb
        rows[name] = out
    rows["cross_entropy_fwd"]["max_abs_err"] = max(errs["loss"], errs["lse"])
    rows["cross_entropy_fwd"]["max_abs_err_loss_lse"] = [errs["loss"],
                                                         errs["lse"]]
    rows["cross_entropy_bwd"]["max_abs_err"] = errs["dx"]
    for name in rows:
        rows[name]["tolerance"] = {k: dict(zip(("atol", "rtol"), CE_TOL[k]))
                                   for k in (("loss", "lse") if "fwd" in name
                                             else (dkey,))}
        rows[name]["limit_used"] = used
        rows[name]["library"] = ("F.cross_entropy(fp32 logits, "
                                 "reduction='none')" + (
                                     "" if "fwd" in name else
                                     ", autograd backward"))
        rows[name]["shape"] = (f"T={T} V={V} {str(dtype)[6:]}"
                               + (f", {ignored} labels -100" if ignored
                                  else ""))
    del x, xf, lib_loss, lse, loss
    torch.cuda.empty_cache()
    return rows


def kernels_ce(CE, dev, timer):
    return {"bf16 T=8192 V=50304": kernel_ce(CE, dev, timer, GPT_T, GPT_V,
                                             torch.bfloat16),
            "fp32 T=1024 V=50304": kernel_ce(CE, dev, timer, 1024, GPT_V,
                                             torch.float32),
            "bf16 T=1000 V=50257": kernel_ce(CE, dev, timer, 1000, 50257,
                                             torch.bfloat16, ignored=40)}


# -- phase 10, kernel rows: the act + bias feed-forward -----------------------

TB, TS, TD, TF_ = 32, 256, 512, 2048     # Transformer-base: b, s, d, FFN


def kernel_ffn(FB, dev, timer, act, dtype, T=TB * TS):
    """fused_ffn against ffn_reference at the Transformer cell's FFN
    shape (T = b * s rows; T = 8 a decode step's, bf16 split-K: bitwise
    equal over two calls, each launch's split count and TB/s), on its
    path, timed beside the plain version, addmm -> act -> addmm (the
    F.linear chain on [in, out] weights) and its bound."""
    F_ = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(len(act) + T)
    x = rand(g, (T, TD), dtype, dev)
    w1 = rand(g, (TD, TF_), dtype, dev, TD ** -0.5)
    w2 = rand(g, (TF_, TD), dtype, dev, TF_ ** -0.5)
    b1 = rand(g, (TF_,), dtype, dev, 0.1)
    b2 = rand(g, (TD,), dtype, dev, 0.1)
    used = {}
    what = f"fused_ffn {act} {dtype} T={T}"
    path = FB.gemm_path(T, dtype)
    n0 = dict(FB.fused_ffn.launches_by_path)
    got = FB.fused_ffn(x, w1, w2, b1, b2, act)
    n0[path] += 1
    if FB.fused_ffn.launches_by_path != n0:
        raise AssertionError(f"{what}: not on its {path} path")
    err = check_close(what, got, FB.ffn_reference(x, w1, b1, w2, b2, act),
                      dtype, None, used)
    if path == "splitk" and not torch.equal(
            got, FB.fused_ffn(x, w1, w2, b1, b2, act)):
        raise AssertionError(f"{what}: split-K differs between two calls")
    fn = {"relu": F_.relu, "gelu": F_.gelu, "silu": F_.silu}[act]

    def kernel():
        return FB.fused_ffn(x, w1, w2, b1, b2, act)

    def library():
        return torch.addmm(b2, fn(torch.addmm(b1, x, w1)), w2)
    out = {"ms": timer(kernel),
           "plain_ms": timer(lambda: FB.ffn_reference(x, w1, b1, w2, b2,
                                                      act)),
           "library_ms": timer(library)}
    isz = x.element_size()
    out["bound_ms"], out["bound_by"] = bound_ms(
        *ffn_io(T, isz, TD, TF_),
        BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S)
    out["max_abs_err"] = err
    out["tolerance"] = dict(zip(("atol", "rtol"), TOL[dtype]))
    out["limit_used"] = used[what]
    out["workspace_bytes"] = 2 * T * TF_ * isz
    out["library"] = "addmm(b1, x, w1) -> act -> addmm(b2, h, w2)"
    out["shape"] = f"T={T} d={TD} f={TF_} {act} {str(dtype)[6:]}"
    out["path"] = path
    if path == "splitk":
        out["bitwise_equal_twice"] = True
        out["ms_no_spin"] = no_spin(timer, kernel)
        out["library_ms_no_spin"] = no_spin(timer, library)
        out["launches"] = splitk_launches(
            timer, kernel, out["ms"], (TD, TF_, 2 * TD * TF_),
            (TF_, TD, 2 * TD * TF_),
            torch.cuda.get_device_properties(dev).multi_processor_count)
    return out


def kernels_ffn(FB, dev, timer):
    rows = {f"{act} bf16": kernel_ffn(FB, dev, timer, act, torch.bfloat16)
            for act in ("relu", "gelu", "silu")}
    rows["relu fp32"] = kernel_ffn(FB, dev, timer, "relu", torch.float32)
    # a decode step's rows at Transformer-base width: split-K
    rows["relu bf16 T=8"] = kernel_ffn(FB, dev, timer, "relu",
                                       torch.bfloat16, T=8)
    torch.cuda.empty_cache()
    return rows


# -- phase 4: full-width parity against the plain path -----------------------

def drive(model, prompt, chunk, n_new, quant_kv=None):
    """Chunked prefill then greedy decode of one sequence through the
    model's paged-cache forward (int8 pools with `quant_kv`); returns
    (last chunk's fp32 logits, greedy tokens)."""
    from paddle_tpu_torch.inference.kv_cache import PagedKVPool
    cfg = model.config
    dev = model.device
    bs, mb = 16, 64
    pool = PagedKVPool(cfg.num_hidden_layers, 1 + mb, bs,
                       cfg.num_key_value_heads, cfg.head_dim,
                       model.parameters()[0].dtype, dev, quant=quant_kv)
    bt = torch.arange(1, 1 + mb, dtype=torch.int32, device=dev)[None]
    caches = pool.caches(bt)

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
    return card, host, prompt


def parity_quant(card, host, prompt, kernels):
    """The parity phase's two models converted for quantized serving:
    int8 weights with int8 KV pools, then fp8 weights with fp pools.  The
    host carries the card's qweight / w_scale buffers (and its weights in
    fp32), so both sides multiply by the same quantized values; the last
    chunk's logits within 5% of their largest magnitude."""
    from paddle_tpu_torch.quantization.serving import (quantize_for_serving,
                                                       restore_from_serving)
    for wmode, kvq in (("int8", "int8"), ("fp8", None)):
        t0 = time.perf_counter()
        info = quantize_for_serving(card, wmode)
        quantize_for_serving(host, wmode)
        host.set_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
        kernels.reset_launch_counts()
        got, toks = drive(card, prompt, 256, 8, quant_kv=kvq)
        launched = {fn.__name__: fn.launches
                    for fn in kernels.SERVING + kernels.SERVING_QUANT}
        ref, ref_toks = drive(host, prompt, 256, 8, quant_kv=kvq)
        restore_from_serving(card)
        restore_from_serving(host)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        tol = 0.05 * scale
        if not torch.isfinite(got).all() or err > tol:
            raise AssertionError(f"parity_quant {wmode}/{kvq}: logits max "
                                 f"abs err {err} > {tol}")
        paged = "paged_decode_attention_int8" if kvq else \
            "paged_decode_attention"
        if not launched["quant_matmul"] or not launched[paged] or \
                launched["fused_rmsnorm_qkv"] or launched["fused_mlp"]:
            raise AssertionError(f"parity_quant {wmode}/{kvq}: launches "
                                 f"{launched}")
        agree = sum(a == b for a, b in zip(toks, ref_toks))
        emit("parity_quant", layers=2, weights=wmode, kv=kvq or "bf16",
             converted_layers=info["layers"], prompt=len(prompt), chunk=256,
             max_abs_err=err, ref_max_abs=scale, tolerance=tol,
             greedy_tokens=toks, plain_tokens=ref_toks,
             tokens_agree=f"{agree}/{len(toks)}", launches=launched,
             seconds=time.perf_counter() - t0)


# -- phase 5: the training step at full width against the plain path --------

@contextlib.contextmanager
def matmul_precision(mode):
    """FLAGS_default_matmul_precision set to `mode` inside the block."""
    from paddle_tpu_torch import flags
    saved = flags.get("default_matmul_precision")
    flags.set_flags({"default_matmul_precision": mode})
    try:
        yield
    finally:
        flags.set_flags({"default_matmul_precision": saved})


def matmul_mode():
    """FLAGS_default_matmul_precision as the port reads it."""
    from paddle_tpu_torch import flags
    return flags.get("default_matmul_precision")


def loss_and_grads(model, ids):
    """`model`'s loss on ids[:, :-1] -> ids[:, 1:] and every parameter's
    gradient (cleared first)."""
    model.zero_grad(set_to_none=True)
    x = torch.as_tensor(ids[:, :-1]).to(model.device)
    y = torch.as_tensor(ids[:, 1:]).to(model.device)
    loss = model.loss(x, y)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in model.named_parameters()}


def train_parity(dev):
    """Loss and every gradient of a 1-layer full-width model (vocab cut
    to 32000), fp32 with TF32 off, b=1, s=256: the card (flash, QKV train
    variant, MLP kernels) against the same weights on the CPU (plain
    versions), with FLAGS_default_matmul_precision=float32 (the chunked
    CE's products exact fp32 on both sides).  Then train_parity_tf32: the
    card at the flag's default (the CE's chunk products in TF32) against
    the card at float32, within CE_TF32_TOL["float32"], and the control
    (bf16_products) outside it."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers, cfg.vocab_size, cfg.dtype = 1, 32000, "float32"
    seed(2)
    card = LlamaForCausalLM(cfg, device=dev)
    host = LlamaForCausalLM(cfg, device="cpu")
    host.set_state_dict({k: v.cpu().numpy()
                         for k, v in card.state_dict().items()})
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 257))
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    losses, grads = [], []
    with matmul_precision("float32"):
        for model in (card, host):
            loss, grad = loss_and_grads(model, ids)
            losses.append(loss)
            grads.append(grad)
    launched = {fn.__name__: fn.launches for fn in kernels.TRAINING}
    if not all(launched.values()):
        raise AssertionError(f"train_parity: kernels not launched "
                             f"{launched}")
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    if not rel <= 1e-4:
        raise AssertionError(f"train_parity: loss {losses[0]} vs plain "
                             f"{losses[1]} (rel {rel})")
    # fp32 on both sides, sums taken in other orders (up to 14336 terms
    # per product, through attention and the chunked CE): 1e-3 of each
    # gradient's largest magnitude
    worst = {}
    for n, ref in grads[1].items():
        got = grads[0][n].cpu()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        if not torch.isfinite(got).all() or err > 1e-3 * scale + 1e-12:
            raise AssertionError(f"train_parity: grad {n} max abs err {err} "
                                 f"> 1e-3 * {scale}")
        worst[n] = err / scale if scale else 0.0
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:4]
    emit("train_parity", layers=1, vocab=cfg.vocab_size, batch=1, seq=256,
         dtype="float32", matmul_precision="float32", loss=losses[0],
         plain_loss=losses[1], loss_rel_err=rel,
         grad_tolerance="1e-3 of each grad's max |g|",
         worst_grad_rel_err=dict(top), launches=launched,
         seconds=time.perf_counter() - t0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    err = {}
    for what, ctx in (("default", contextlib.nullcontext()),
                      ("bf16_control", bf16_products())):
        with matmul_precision("default" if what == "default" else
                              "float32"), ctx:
            loss, grad = loss_and_grads(card, ids)
        now = torch.backends.cuda.matmul.allow_tf32
        if now != tf32:
            raise AssertionError(f"train_parity_tf32: the CE left TF32 {now}")
        if not all(torch.isfinite(g).all() for g in grad.values()):
            raise AssertionError(f"train_parity_tf32 {what}: a non-finite "
                                 "gradient")
        err[what] = {"loss_rel": abs(loss - losses[0]) / abs(losses[0])}
        for n, ref in grads[0].items():
            scale = float(ref.abs().max())
            err[what][n + "_of_max"] = \
                float((grad[n] - ref).abs().max()) / scale if scale else 0.0
        del grad
    breaks = {k: ce_breaches(v, "float32") for k, v in err.items()}
    top = {k: dict(sorted(v.items(), key=lambda kv: -kv[1])[:4])
           for k, v in err.items()}
    emit("train_parity_tf32", layers=1, vocab=cfg.vocab_size, batch=1,
         seq=256, dtype="float32", matmul_precision="default",
         float32_loss=losses[0], tolerance=CE_TF32_TOL["float32"],
         largest_errors=top, loss_rel_err={k: v["loss_rel"]
                                           for k, v in err.items()},
         breaks=breaks, tf32_global=tf32)
    if breaks["default"]:
        raise AssertionError(f"train_parity_tf32: TF32 against float32 "
                             f"breaks {breaks['default']}: {top['default']}")
    if not breaks["bf16_control"]:
        raise AssertionError("train_parity_tf32: bf16 products pass the "
                             f"TF32 gate: {top['bf16_control']}")
    del card, host, grads


# -- phase 6: serve the full model -------------------------------------------

SERVE_LENGTHS = [64, 150, 256, 333, 420, 512, 600, 700]
# the Serve cell's engine: the paged engine, passed explicitly (the
# engine's default follows PADDLE_TPU_PAGED_KV, off as in JAX)
SERVE_ENGINE = dict(slots=8, max_len=1024, kv_block_size=16,
                    prefill_chunk=256, paged_kv=True)

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
    eng = ContinuousBatchingEngine(model, **SERVE_ENGINE)
    rng = np.random.default_rng(0)
    # one short request first: CUDA library handles and allocator pools
    # are set up outside the measured run
    eng.add_request(rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)
    eng.run()
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in SERVE_LENGTHS]
    rids = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    stats0 = dict(eng.stats)
    # each eager chunk's span on the device, between CUDA events
    chunks, body = TimedReplays(None), eng._prefill_chunk_body
    eng._prefill_chunk_body = lambda **kw: chunks.timed(body, **kw)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    del eng._prefill_chunk_body
    launches = {fn.__name__: fn.launches for fn in kernels.SERVING}
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
    # prefill chunks (> 16 rows) on the wgmma ring, decode steps (8 rows)
    # on split-K (the MLP and QKV), never the tile; paged decode split
    by_path = gemm_paths(kernels)
    require_paths("serve", by_path, {("fused_mlp", "wgmma"): None,
                                     ("fused_mlp", "splitk"): None,
                                     ("fused_mlp", "tile"): 0,
                                     ("fused_rmsnorm_qkv", "wgmma"): None,
                                     ("fused_rmsnorm_qkv", "splitk"): None,
                                     ("fused_rmsnorm_qkv", "tile"): 0,
                                     ("paged_decode_attention", "split"):
                                     None,
                                     ("paged_decode_attention", "direct"):
                                     0})
    metrics = run_metrics(eng, rids, out, stats0, run_s)
    ms = chunks.ms()
    metrics["serving.prefill_chunk.eager.replay_ms"] = {
        "n": len(ms), "mean": float(np.mean(ms)), "total": float(np.sum(ms))}
    emit("serve", layers=cfg.num_hidden_layers, dtype=cfg.dtype,
         requests=len(rids), prompt_lengths=SERVE_LENGTHS, max_new_tokens=32,
         model_build_s=build_s, **metrics,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         launches=launches, launches_by_path=by_path,
         first_tokens=[out[r][1][:4] for r in rids])
    metrics["profile"] = profile(eng, cfg, rng)
    launches["launches_by_path"] = by_path
    eng.close()
    return launches, model, prompts, [out[r][1] for r in rids], metrics


def run_metrics(eng, rids, out, stats0, run_s):
    """A measured engine run's end-to-end numbers: run seconds, TTFT p50
    and p99 (host clock), decode steps and tokens, decode tokens/s over
    the decode steps' wall time, prefill chunks and output tokens/s."""
    ttft = np.array([eng.request_status(r).timings["ttft_s"] for r in rids])
    dec_tok = eng.stats["decode_tokens"] - stats0["decode_tokens"]
    dec_s = eng.stats["decode_seconds"] - stats0["decode_seconds"]
    return {"run_s": run_s,
            "ttft_p50_s": float(np.percentile(ttft, 50)),
            "ttft_p99_s": float(np.percentile(ttft, 99)),
            "decode_steps": eng.stats["decode_steps"]
            - stats0["decode_steps"],
            "decode_tokens": dec_tok, "decode_tok_s": dec_tok / dec_s,
            "prefill_chunks": eng.stats["prefill_chunks"]
            - stats0["prefill_chunks"],
            "output_tok_s": sum(len(out[r][1]) for r in rids) / run_s}


def serve_quant(dev, kernels, model, prompts, bf16_tokens):
    """The serve phase's 32-layer model, converted in place, behind the
    quantized engines: int8 weights with int8 KV pools, then fp8 weights
    with bf16 pools; the same 8 requests.  Returns each engine's launch
    counts."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.quantization import QuantedLinear
    cfg = model.config
    rng = np.random.default_rng(1)
    runs = {}
    for wmode, kvq in (("int8", "int8"), ("fp8", None)):
        t0 = time.perf_counter()
        eng = ContinuousBatchingEngine(model, **SERVE_ENGINE,
                                       quant_weights=wmode, quant_kv=kvq)
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        if kvq and eng._num_blocks != 1 + 2 * 8 * 64:
            raise AssertionError(f"serve_quant: {eng._num_blocks} int8 "
                                 "blocks, expected 1025")
        quanted = [m for m in model.modules() if isinstance(m, QuantedLinear)]
        q_bytes = sum(m.qweight.numel() * m.qweight.element_size()
                      + m.w_scale.numel() * 4 for m in quanted)
        fp_bytes = sum(m._orig.weight.numel() * m._orig.weight.element_size()
                       for m in quanted)
        eng.add_request(rng.integers(0, cfg.vocab_size, 16),
                        max_new_tokens=2)          # warm-up, as in serve
        eng.run()
        rids = [eng.add_request(p, max_new_tokens=32) for p in prompts]
        stats0 = dict(eng.stats)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        qm = kernels.SERVING_QUANT[0]
        launches = {fn.__name__: fn.launches
                    for fn in kernels.SERVING + kernels.SERVING_QUANT}
        launches["quant_matmul_by_mode"] = dict(qm.launches_by_mode)
        for rid in rids:
            st, toks = eng.request_status(rid), out[rid][1]
            if st != "ok" or len(toks) != 32 or \
                    not all(0 <= t < cfg.vocab_size for t in toks):
                raise AssertionError(f"serve_quant {wmode}: request {rid} "
                                     f"status {st!r}, {len(toks)} tokens")
        paged = "paged_decode_attention_int8" if kvq else \
            "paged_decode_attention"
        if not qm.launches_by_mode[wmode] or not launches[paged]:
            raise AssertionError(f"serve_quant {wmode}: quant kernels not "
                                 f"launched {launches}")
        if launches["fused_rmsnorm_qkv"] or launches["fused_mlp"]:
            raise AssertionError(f"serve_quant {wmode}: fused fp kernels "
                                 f"launched {launches}")
        # decode steps on split-K, prefill chunks on wgmma, none on the
        # fp32 tile; paged decode split
        launches["quant_matmul_by_path"] = dict(qm.launches_by_path)
        by_path = gemm_paths(kernels)
        launches["paged_by_path"] = by_path[paged]
        require_paths(f"serve_quant {wmode}", by_path,
                      {("quant_matmul", "splitk"): None,
                       ("quant_matmul", "wgmma"): None,
                       ("quant_matmul", "tile"): 0,
                       (paged, "split"): None, (paged, "direct"): 0})
        ttft = np.array([eng.request_status(r).timings["ttft_s"]
                         for r in rids])
        dec_tok = eng.stats["decode_tokens"] - stats0["decode_tokens"]
        dec_s = eng.stats["decode_seconds"] - stats0["decode_seconds"]
        agree = sum(a == b for r, ref in zip(rids, bf16_tokens)
                    for a, b in zip(out[r][1], ref))
        emit("serve_quant", layers=cfg.num_hidden_layers, weights=wmode,
             kv=kvq or "bf16", requests=len(rids),
             prompt_lengths=SERVE_LENGTHS, max_new_tokens=32,
             convert_s=convert_s, run_s=run_s,
             ttft_p50_s=float(np.percentile(ttft, 50)),
             ttft_p99_s=float(np.percentile(ttft, 99)),
             decode_steps=eng.stats["decode_steps"] - stats0["decode_steps"],
             decode_tokens=dec_tok, decode_tok_s=dec_tok / dec_s,
             prefill_chunks=eng.stats["prefill_chunks"]
             - stats0["prefill_chunks"],
             output_tok_s=sum(len(out[r][1]) for r in rids) / run_s,
             converted_layers=len(quanted), quant_weight_bytes=q_bytes,
             bf16_weight_bytes=fp_bytes, kv_blocks=eng._num_blocks,
             pool_bytes=eng._pool.nbytes,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
             tokens_agree_with_bf16=f"{agree}/{32 * len(rids)}",
             launches=launches, first_tokens=[out[r][1][:4] for r in rids])
        if kvq:
            profile(eng, cfg, rng, phase="profile_quant")
        # the same engine after aot_warmup, sharing the conversion
        # while the eager one is open; closed first (its graphs dropped
        # before the reference goes)
        geng, gtoks, gm, _ = serve_run(model, prompts, warm=True,
                                       quant_weights=wmode, quant_kv=kvq)
        graph = geng._graphs["serving.decode"]
        chunk = geng._graphs["serving.prefill_chunk"]
        same = gtoks == [out[r][1] for r in rids]
        emit("serve_quant_graph", weights=wmode, kv=kvq or "bf16",
             tokens_equal_eager=same, eager_decode_tok_s=dec_tok / dec_s,
             graphed=gm, capture_s=graph.seconds,
             launches_a_replay=graph.launches, replays=graph.replays,
             chunk_capture_s=chunk.seconds,
             chunk_launches_a_replay=chunk.launches,
             chunk_replays=chunk.replays)
        if chunk.graph is None or not chunk.replays:
            raise AssertionError(f"serve_quant_graph {wmode}/{kvq}: the "
                                 "prefill chunk was not replayed")
        if not same:
            raise AssertionError(f"serve_quant_graph {wmode}/{kvq}: graphed "
                                 "tokens differ from the eager run's")
        launches["graph_launches_a_replay"] = dict(graph.launches)
        launches["chunk_launches_a_replay"] = dict(chunk.launches)
        geng.close()
        del geng, graph, chunk
        eng.close()
        if not hasattr(model.lm_head, "weight") or \
                getattr(model, "_serving_quant_refs", 0) != 0:
            raise AssertionError("serve_quant: close() did not restore the "
                                 "model")
        runs[wmode] = launches
        del eng, out
        torch.cuda.empty_cache()
    return runs


def int8w_bytes(model):
    """The layers int8_weights converted, their int8 codes and fp32
    scales in bytes, and the bytes of the bf16 weights they stand for."""
    from paddle_tpu_torch.quantization import Int8Embedding, QuantedLinear
    mods = [m for m in model.modules()
            if isinstance(m, (QuantedLinear, Int8Embedding))]
    q = sum(m.qweight.numel() * m.qweight.element_size()
            + m.w_scale.numel() * 4 for m in mods)
    fp = sum(m._orig.weight.numel() * m._orig.weight.element_size()
             for m in mods)
    return len(mods), q, fp


def int8w_launch_gates(what, launches, paged=True):
    """int8_weights' path: every projection on the quant matmul, the
    fused QKV / MLP kernels never, paged decode where the engine pages."""
    bad = not launches.get("quant_matmul") or \
        launches.get("fused_rmsnorm_qkv") or launches.get("fused_mlp") or \
        (paged and not launches.get("paged_decode_attention"))
    if bad:
        raise AssertionError(f"{what}: launches {launches}")


def parity_int8w(card, host, prompt, kernels):
    """The parity phase's 2-layer models with the engine's int8_weights
    codes (every Linear and the embedding): the host carries the card's
    codes, scales and weights, so both sides dequantize the same values;
    the last chunk's logits within 5% of their largest magnitude."""
    from paddle_tpu_torch.quantization.serving import (
        quantize_int8_weights, restore_from_serving)
    t0 = time.perf_counter()
    info = quantize_int8_weights(card)
    quantize_int8_weights(host)
    host.set_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    kernels.reset_launch_counts()
    got, toks = drive(card, prompt, 256, 8)
    launched = {fn.__name__: fn.launches
                for fn in kernels.SERVING + kernels.SERVING_QUANT}
    ref, ref_toks = drive(host, prompt, 256, 8)
    restore_from_serving(card)
    restore_from_serving(host)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = 0.05 * scale
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"parity_int8w: logits max abs err {err} > "
                             f"{tol}")
    int8w_launch_gates("parity_int8w", launched)
    agree = sum(a == b for a, b in zip(toks, ref_toks))
    emit("parity_int8w", layers=2, converted_layers=info["layers"],
         prompt=len(prompt), chunk=256, max_abs_err=err, ref_max_abs=scale,
         tolerance=tol, greedy_tokens=toks, plain_tokens=ref_toks,
         tokens_agree=f"{agree}/{len(toks)}", launches=launched,
         seconds=time.perf_counter() - t0)


def serve_int8w(kernels, model, prompts, bf16_tokens):
    """The Serve cell with ``int8_weights=True`` (JAX's legacy rule: every
    Linear and the embedding as int8 with per-column fp32 scales): the
    paged engine eager and after aot_warmup, then the slot engine after
    aot_warmup.  Gates: every request "ok" with 32 tokens; graphed tokens
    equal to eager; the quant matmul launched (split-K at decode, wgmma
    in the chunks) and the fused QKV / MLP never; the model restored
    after close.  Reported: output and decode tokens/s, TTFT, a decode
    and a chunk replay's CUDA-event ms, the weight bytes, the launches
    one replay makes."""
    from paddle_tpu_torch.nn.common_layers import Embedding
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    eng, toks, m, _ = serve_run(model, prompts, int8_weights=True)
    launches = {fn.__name__: fn.launches
                for fn in kernels.SERVING + kernels.SERVING_QUANT}
    int8w_launch_gates("serve_int8w eager", launches)
    by_path = gemm_paths(kernels)
    require_paths("serve_int8w", by_path,
                  {("quant_matmul", "splitk"): None,
                   ("quant_matmul", "wgmma"): None,
                   ("quant_matmul", "tile"): 0})
    n_conv, q_bytes, fp_bytes = int8w_bytes(model)
    # graphed, sharing the eager engine's conversion
    kernels.reset_launch_counts()
    geng, gtoks, gm, ws = serve_run(model, prompts, warm=True,
                                    int8_weights=True)
    glaunches = {fn.__name__: fn.launches
                 for fn in kernels.SERVING + kernels.SERVING_QUANT}
    graph = geng._graphs["serving.decode"]
    chunk = geng._graphs["serving.prefill_chunk"]
    a_replay, chunk_replay = dict(graph.launches), dict(chunk.launches)
    same = gtoks == toks
    if not same:
        raise AssertionError("serve_int8w: graphed tokens differ from the "
                             "eager run's")
    if chunk.graph is None or not chunk.replays or not graph.replays:
        raise AssertionError("serve_int8w: the programs were not replayed")
    int8w_launch_gates("serve_int8w graphed", glaunches)
    int8w_launch_gates("serve_int8w decode replay", a_replay)
    int8w_launch_gates("serve_int8w chunk replay", chunk_replay, paged=False)
    geng.close()
    del geng, graph, chunk
    torch.cuda.empty_cache()
    # the slot-contiguous engine after aot_warmup
    kernels.reset_launch_counts()
    seng, stoks, sm, sws = serve_run(
        model, prompts, warm=True, int8_weights=True, paged_kv=False,
        prefill_buckets=STATIC_BUCKETS)
    slaunches = {fn.__name__: fn.launches
                 for fn in kernels.SERVING + kernels.SERVING_QUANT}
    int8w_launch_gates("serve_int8w slot", slaunches, paged=False)
    slot_replay = dict(seng._graphs["serving.decode"].launches)
    seng.close()
    eng.close()
    del seng, eng
    torch.cuda.empty_cache()
    if not isinstance(model.model.embed_tokens, Embedding) or \
            not hasattr(model.lm_head, "weight") or \
            getattr(model, "_serving_quant_refs", 0) != 0:
        raise AssertionError("serve_int8w: close() did not restore the "
                             "model")
    agree = sum(a == b for t, r in zip(toks, bf16_tokens)
                for a, b in zip(t, r))
    sagree = sum(a == b for t, r in zip(stoks, toks) for a, b in zip(t, r))
    emit("serve_int8w", layers=model.config.num_hidden_layers,
         requests=len(toks), max_new_tokens=32,
         converted_layers=n_conv, int8_weight_bytes=q_bytes,
         bf16_weight_bytes=fp_bytes, eager=m, graphed=gm, slot_graphed=sm,
         tokens_equal_eager=same,
         tokens_agree_with_bf16=f"{agree}/{32 * len(toks)}",
         slot_tokens_agree_with_paged=f"{sagree}/{32 * len(toks)}",
         capture_s={t: v["seconds"] for t, v in ws.items()},
         slot_capture_s={t: v["seconds"] for t, v in sws.items()},
         launches=launches, quant_matmul_by_path=by_path["quant_matmul"],
         graphed_launches=glaunches, slot_launches=slaunches,
         launches_a_replay=a_replay, chunk_launches_a_replay=chunk_replay,
         slot_launches_a_replay=slot_replay,
         seconds=time.perf_counter() - t0)
    return {"launches": launches["quant_matmul"],
            "graph_launches_a_replay": a_replay,
            "chunk_launches_a_replay": chunk_replay,
            "slot_launches_a_replay": slot_replay}


# -- phase 6b: the serving engine's programs as CUDA graphs -------------------

class TimedReplays:
    """Stands in for a StaticGraph's CUDA graph: CUDA events around each
    replay (or each call of :meth:`timed`), so a replay's device time is
    read without the profiler."""

    def __init__(self, graph):
        self.inner = graph
        self.events = []

    def replay(self):
        self.timed(self.inner.replay)

    def timed(self, fn, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def serve_run(model, prompts, warm=False, n_new=32, **kw):
    """One engine (SERVE_ENGINE with `kw`) over `prompts`, eager or after
    aot_warmup, after a short warm-up request; every request must end
    "ok" with `n_new` tokens.  Returns (engine, tokens, metrics,
    aot_warmup's stats); the metrics carry the replays' device ms from
    CUDA events."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    cfg = model.config
    eng = ContinuousBatchingEngine(model, **dict(SERVE_ENGINE, **kw))
    stats = eng.aot_warmup() if warm else None
    rng = np.random.default_rng(0)
    eng.add_request(rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)
    eng.run()
    timed = {t: TimedReplays(g.graph) for t, g in eng._graphs.items()}
    for t, g in eng._graphs.items():
        g.graph = timed[t]
    chunks = None
    if not warm and eng.paged:
        # an eager chunk's span on the device, between CUDA events
        chunks, body = TimedReplays(None), eng._prefill_chunk_body
        eng._prefill_chunk_body = lambda **kw: chunks.timed(body, **kw)
    rids = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    stats0 = dict(eng.stats)
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    for t, g in eng._graphs.items():
        g.graph = timed[t].inner
    if chunks is not None:
        del eng._prefill_chunk_body
        timed["serving.prefill_chunk.eager"] = chunks
    for rid in rids:
        st, toks = eng.request_status(rid), out[rid][1]
        if st != "ok" or len(toks) != n_new or \
                not all(0 <= x < cfg.vocab_size for x in toks):
            raise AssertionError(f"serve_run {kw}: request {rid} status "
                                 f"{st!r}, {len(toks)} tokens")
    m = run_metrics(eng, rids, out, stats0, run_s)
    for t, tr in timed.items():
        ms = tr.ms()
        m[t + ".replay_ms"] = {"n": len(ms), "mean": float(np.mean(ms)),
                               "total": float(np.sum(ms))} if ms else None
    return eng, [out[r][1] for r in rids], m, stats


def serve_graph(dev, kernels, model, prompts, eager_tokens, eager):
    """The Serve cell after aot_warmup: the decode replayed as one CUDA
    graph a step.  Gates: the tokens of every request equal the eager
    Serve run's (the same kernels in the same order), at
    steps_per_sync 1 and 4 and sampled (against an eager engine of the
    same seed); every serving kernel launched (at the warm-up, the
    capture and the eager prefill chunks: a replay moves no counter).
    Reports eager beside graphed: decode and output tokens/s, TTFT, the
    profiled busy share and the decode kernels' device ms a step, the
    replays' and chunks' event-timed device ms, capture seconds and
    launches a replay.  Returns the launches one decode replay and one
    prefill chunk replay make."""
    cfg = model.config
    kernels.reset_launch_counts()
    eng, toks, m, ws = serve_run(model, prompts, warm=True)
    launches = {fn.__name__: fn.launches for fn in kernels.SERVING}
    graph = eng._graphs["serving.decode"]
    chunk = eng._graphs["serving.prefill_chunk"]
    if toks != eager_tokens:
        raise AssertionError("serve_graph: graphed tokens differ from the "
                             "eager Serve run's")
    L = cfg.num_hidden_layers
    if not all(launches.values()) or not graph.launches or \
            chunk.graph is None or not chunk.replays or \
            chunk.launches.get("fused_mlp") != L or \
            chunk.launches.get("fused_rmsnorm_qkv") != L:
        raise AssertionError(f"serve_graph: launches {launches}, a replay "
                             f"{graph.launches}, a chunk {chunk.launches}")
    prof = profile(eng, cfg, np.random.default_rng(0), phase="profile_graph")
    emit("serve_graph", variant="bf16, steps_per_sync=1", requests=len(toks),
         tokens_equal_eager=True, eager={k: eager[k] for k in (
             "decode_tok_s", "output_tok_s", "ttft_p50_s", "ttft_p99_s",
             "run_s")}, graphed=m,
         eager_busy_share=eager["profile"]["device_busy_share"],
         graphed_busy_share=prof["device_busy_share"],
         eager_decode_kernels_ms_per_step=eager["profile"][
             "decode_kernels_ms_per_step"],
         graphed_decode_kernels_ms_per_step=prof[
             "decode_kernels_ms_per_step"],
         profiler_saw_replays=bool(prof["decode_kernels_ms_per_step"]),
         capture_s=ws["serving.decode"]["seconds"],
         launches_a_replay=graph.launches, replays=graph.replays,
         chunk_capture_s=ws["serving.prefill_chunk"]["seconds"],
         chunk_launches_a_replay=chunk.launches, chunk_replays=chunk.replays,
         eager_chunk_ms=eager["serving.prefill_chunk.eager.replay_ms"],
         graphed_chunk_ms=m["serving.prefill_chunk.replay_ms"],
         launches=launches)
    a_replay = dict(graph.launches)
    chunk_replay = dict(chunk.launches)
    eng.close()
    del eng, graph, chunk
    torch.cuda.empty_cache()
    for variant, kw in (("bf16, steps_per_sync=4", dict(steps_per_sync=4)),
                        ("bf16, do_sample (top_k=50, seed=7)",
                         dict(do_sample=True, top_k=50, seed=7))):
        e_eng, e_toks, e_m, _ = serve_run(model, prompts, **kw)
        e_eng.close()
        g_eng, g_toks, g_m, g_ws = serve_run(model, prompts, warm=True, **kw)
        g = g_eng._graphs["serving.decode"]
        emit("serve_graph", variant=variant, tokens_equal_eager=g_toks
             == e_toks, eager=e_m, graphed=g_m,
             capture_s=g_ws["serving.decode"]["seconds"],
             launches_a_replay=g.launches, replays=g.replays,
             chunk_launches_a_replay=g_ws["serving.prefill_chunk"][
                 "launches"],
             chunk_replays=g_eng._graphs["serving.prefill_chunk"].replays)
        if g_toks != e_toks:
            raise AssertionError(f"serve_graph {variant}: graphed tokens "
                                 "differ from the eager engine's")
        g_eng.close()
        del e_eng, g_eng, g
        torch.cuda.empty_cache()
    return a_replay, chunk_replay


SPEC_K = 4


def serve_spec(kernels, model):
    """Serve's engine with spec_decode=4 after aot_warmup, over prompts
    that hold a repeated 64-token span (each Serve length of random
    tokens, then the span twice), so the n-gram proposer finds drafts.
    Gate: every request "ok" with its 32 tokens.  Reported, not gated:
    proposed and accepted drafts, tokens a row a verify (at most 5), and
    agreement with a graphed non-spec run (bf16 near-ties may flip: a
    verify's 8 x 5 rows take other GEMM paths than 8-row decode)."""
    cfg = model.config
    rng = np.random.default_rng(3)
    span = rng.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([rng.integers(0, cfg.vocab_size, n), span,
                               span]) for n in SERVE_LENGTHS]
    ref_eng, ref, ref_m, _ = serve_run(model, prompts, warm=True)
    ref_eng.close()
    kernels.reset_launch_counts()
    eng, toks, m, ws = serve_run(model, prompts, warm=True,
                                 spec_decode=SPEC_K)
    launches = {fn.__name__: fn.launches for fn in kernels.SERVING}
    g = eng._graphs["serving.spec_verify"]
    st = eng.stats
    agree = sum(a == b for t, r in zip(toks, ref) for a, b in zip(t, r))
    emit("serve_spec", spec_decode=SPEC_K, requests=len(prompts),
         prompt_lengths=[len(p) for p in prompts], graphed=m,
         non_spec_graphed=ref_m, spec_verifies=st["spec_verifies"],
         spec_proposed=st["spec_proposed"],
         spec_accepted=st["spec_accepted"],
         acceptance=st["spec_accepted"] / max(1, st["spec_proposed"]),
         spec_rows=st["spec_rows"],
         tokens_per_row_verify=st["decode_tokens"] / max(1,
                                                         st["spec_rows"]),
         tokens_agree_with_non_spec=f"{agree}/{32 * len(prompts)}",
         capture_s={t: v["seconds"] for t, v in ws.items()},
         verify_launches_a_replay=g.launches, verify_replays=g.replays,
         launches=launches)
    if not all(launches.values()):
        raise AssertionError(f"serve_spec: launches {launches}")
    eng.close()
    del eng, g
    torch.cuda.empty_cache()


# -- phase 6c: the serving fleet ------------------------------------------------

class TransferTimes:
    """CUDA events around every block export and import and every
    serialize / deserialize of a handoff (patched on the classes and the
    module the router and the engine call), and the blocks each moved."""

    def __init__(self):
        from paddle_tpu_torch.inference import kv_cache as KV
        self.KV = KV
        self.saved = {}
        self.calls = {k: TimedReplays(None) for k in
                      ("export", "serialize", "deserialize", "import")}
        self.blocks = {"export": 0, "import": 0}

    def __enter__(self):
        KV, calls = self.KV, self.calls
        pool = KV.PagedKVPool
        self.saved = {"export": pool.export_blocks,
                      "import": pool.import_blocks,
                      "serialize": KV.serialize_handoff,
                      "deserialize": KV.deserialize_handoff}
        ex, im = self.saved["export"], self.saved["import"]

        # a block counts once its call has returned
        def export(p, bids):
            out = calls["export"].timed(ex, p, bids)
            self.blocks["export"] += len(bids)
            return out

        def import_(p, payload, dst, src_start=0):
            out = calls["import"].timed(im, p, payload, dst, src_start)
            self.blocks["import"] += len(dst)
            return out
        pool.export_blocks, pool.import_blocks = export, import_
        KV.serialize_handoff = lambda payload: calls["serialize"].timed(
            self.saved["serialize"], payload)
        KV.deserialize_handoff = lambda data: calls["deserialize"].timed(
            self.saved["deserialize"], data)
        return self

    def __exit__(self, *exc):
        KV = self.KV
        KV.PagedKVPool.export_blocks = self.saved["export"]
        KV.PagedKVPool.import_blocks = self.saved["import"]
        KV.serialize_handoff = self.saved["serialize"]
        KV.deserialize_handoff = self.saved["deserialize"]

    def report(self, requests):
        out = {}
        for k, t in self.calls.items():
            ms = t.ms()
            out[k] = {"calls": len(ms), "total_ms": float(np.sum(ms)),
                      "ms_per_request": float(np.sum(ms)) / requests}
        out["blocks"] = dict(self.blocks)
        return out


FLEETS = {
    "mixed": dict(replicas=2),
    "disaggregated": dict(replicas=2, prefill_replicas=1,
                          decode_kwargs=dict(steps_per_sync=4)),
    "disaggregated_int8_decode": dict(
        replicas=2, prefill_replicas=1,
        decode_kwargs=dict(steps_per_sync=4, quant_kv="int8")),
    "disaggregated_int8_both": dict(
        replicas=2, prefill_replicas=1, quant_kv="int8",
        decode_kwargs=dict(steps_per_sync=4)),
}
# Serve's prompts behind one system prefix of a whole prefill chunk (16
# blocks): the router's affinity and both tries' reuse fire on it, and a
# chunk never straddles the prefix, so reuse leaves the tokens bitwise
SHARED_PREFIX = 256


def _series(name):
    from paddle_tpu_torch.observability import default_registry
    m = default_registry().get(name)
    return {"/".join(k) or "all": c.value() for k, c in m.series()} \
        if m is not None else {}


def _delta(after, before):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def fleet_run(model, prompts, name, topo):
    """One warmed fleet over `prompts` (32 new tokens each) after a
    short warm-up request; returns (tokens, metrics)."""
    from paddle_tpu_torch.inference import ServingRouter
    cfg = model.config
    kw = dict(topo)
    engine_kwargs = dict(SERVE_ENGINE, quant_kv=kw.pop("quant_kv", None))
    t0 = time.perf_counter()
    router = ServingRouter(model, engine_kwargs=engine_kwargs,
                           warm_on_spawn=True, **kw)
    spawn_s = time.perf_counter() - t0
    if not all(rep.engine._warmed for rep in router._replicas.values()):
        raise AssertionError(f"serve_fleet {name}: a replica is not warmed")
    rng = np.random.default_rng(0)
    router.add_request(rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)
    router.run()
    names = ("paddle_tpu_router_affinity_total",
             "paddle_tpu_router_handoff_bytes_total",
             "paddle_tpu_router_handoffs_total",
             "paddle_tpu_router_requeues_total",
             "paddle_tpu_router_replica_deaths_total")
    before = {n: _series(n) for n in names}
    torch.cuda.reset_peak_memory_stats()
    with TransferTimes() as xfer:
        t0 = time.perf_counter()
        rids = [router.add_request(p, max_new_tokens=32) for p in prompts]
        out = router.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    toks = [out[r][1] for r in rids]
    for rid, t in zip(rids, toks):
        st = router.request_status(rid)
        if st != "ok" or len(t) != 32 or \
                not all(0 <= x < cfg.vocab_size for x in t):
            raise AssertionError(f"serve_fleet {name}: request {rid} status "
                                 f"{st!r}, {len(t)} tokens")
    timings = [router.request_status(r).timings for r in rids]
    ttft = np.array([t["ttft_s"] for t in timings])
    counters = {n.removeprefix("paddle_tpu_router_"): _delta(_series(n),
                                                             before[n])
                for n in names}
    m = {"replicas": router.replicas(), "spawn_s": spawn_s,
         "run_s": run_s, "ttft_p50_s": float(np.percentile(ttft, 50)),
         "ttft_p99_s": float(np.percentile(ttft, 99)),
         "output_tok_s": sum(len(t) for t in toks) / run_s,
         "handoff_s_p50": float(np.percentile(
             [t["handoff_s"] for t in timings], 50)),
         "prefix_tokens_reused": sum(t["prefix_tokens_reused"]
                                     for t in timings),
         # a routed request's timings are its last engine's: on the
         # decode tier, the blocks its trie spared the import
         "skipped_blocks": int(sum(t["prefix_tokens_reused"]
                                   for t in timings)
                               // SERVE_ENGINE["kv_block_size"]),
         "attempts": sum(t["attempts"] for t in timings),
         "transfer": xfer.report(len(rids)), **counters,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    m["handoff_bytes"] = m.pop("handoff_bytes_total").get("all", 0.0)
    router.close()
    fleet_gates(name, m, len(rids), disaggregated="prefill_replicas" in topo)
    return toks, m


def fleet_gates(name, m, n, disaggregated):
    """A fleet run took the path it was built for: no request was
    requeued, no replica died, and in a disaggregated fleet every request
    crossed by one handoff (none fell back to a fresh prefill) whose
    blocks the decode tier imported, less those its own trie held."""
    x = m["transfer"]
    bad = []
    if m["requeues_total"] or m["replica_deaths_total"] or m["attempts"]:
        bad.append("requeues / deaths / retries")
    if disaggregated:
        if m["handoffs_total"] != {"ok": float(n)}:
            bad.append("handoffs")
        if x["export"]["calls"] != n or x["import"]["calls"] != n:
            bad.append("export / import calls")
        b = x["blocks"]
        if not 0 < b["import"] == b["export"] - m["skipped_blocks"]:
            bad.append("imported blocks")
    elif m["handoffs_total"] or x["blocks"]["export"]:
        bad.append("a handoff in a mixed fleet")
    if bad:
        raise AssertionError(f"serve_fleet {name}: {', '.join(bad)}: "
                             f"handoffs {m['handoffs_total']}, requeues "
                             f"{m['requeues_total']}, deaths "
                             f"{m['replica_deaths_total']}, attempts "
                             f"{m['attempts']}, transfer {x}, skipped "
                             f"{m['skipped_blocks']}")


def park_run(model, prompts):
    """One warmed engine with a host KV tier: every other request is
    parked once it has 8 tokens and resumed when the others are done."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            KVTierManager)
    cfg = model.config
    tier = KVTierManager()
    eng = ContinuousBatchingEngine(model, **SERVE_ENGINE, kv_tier=tier)
    eng.aot_warmup()
    rng = np.random.default_rng(0)
    eng.add_request(rng.integers(0, cfg.vocab_size, 16), max_new_tokens=2)
    eng.run()
    before = _series("paddle_tpu_serving_session_resumes_total")
    with TransferTimes() as xfer:
        t0 = time.perf_counter()
        rids = [eng.add_request(p, max_new_tokens=32) for p in prompts]
        chosen, parked, tier_bytes = set(rids[::2]), [], 0
        while eng.pending or parked:
            eng.step()
            for slot, r in enumerate(eng._active):
                if r is not None and r.rid in chosen and \
                        slot not in eng._prefilling and len(r.out) >= 8:
                    chosen.discard(r.rid)
                    parked.append(r.rid)
                    eng.park(r.rid)
            if parked and not eng.pending:
                tier_bytes = max(tier_bytes, tier.stats()["host_bytes"])
                for rid in parked:
                    eng.resume(rid)
                parked = []
        out = {rid: t for rid, _p, t in eng.finished()}
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    toks = [out[r] for r in rids]
    timings = [eng.request_status(r).timings for r in rids]
    if chosen or any(eng.request_status(r) != "ok" or len(t) != 32
                     for r, t in zip(rids, toks)):
        raise AssertionError(f"serve_fleet park: unparked {chosen}, "
                             f"statuses {[str(eng.request_status(r)) for r in rids]}")
    resumes = _delta(_series("paddle_tpu_serving_session_resumes_total"),
                     before)
    ttft = np.array([t["ttft_s"] for t in timings])
    m = {"parked": len(rids[::2]), "resumes": resumes,
         "tier_host_bytes": tier_bytes,
         "parked_s": [round(t["parked_s"], 4) for t in timings],
         "run_s": run_s, "ttft_p50_s": float(np.percentile(ttft, 50)),
         "ttft_p99_s": float(np.percentile(ttft, 99)),
         "output_tok_s": sum(len(t) for t in toks) / run_s,
         "transfer": xfer.report(len(rids[::2]))}
    if resumes.get("promote", 0) != len(rids[::2]):
        raise AssertionError(f"serve_fleet park: resumes {resumes}")
    eng.close()
    return toks, m


def serve_fleet(kernels, model, prompts, paged_tokens):
    """The Serve model (32 layers, bf16, one shared model object) behind
    fleets of warmed replicas over Serve's prompts, 32 new tokens each:
    FLEETS, the disaggregated fleet again on the prompts behind a shared
    SHARED_PREFIX, then one engine with a host KV tier parking half of
    the requests mid-decode (park_run).  Gates: every request "ok" with
    32 tokens; each fleet on its path (fleet_gates: no requeue, no
    death, every handoff "ok" and imported); the mixed, the
    disaggregated and the parking run's tokens equal the Serve run's,
    the shared-prefix fleet's a single warmed engine's on its prompts,
    with affine routes and blocks the decode tier's trie spared; handoff
    bytes > 0 in the disaggregated fleets, the int8 wire (both tiers
    int8) within 0.45-0.6 of the bf16 one;
    every serving kernel launched (at the captures: replays move no
    counter), the int8 paged decode in the int8 fleets.  Reported, not
    gated: the int8 fleets' agreement with Serve.  Returns the launch
    counts."""
    kernels.reset_launch_counts()
    res = {}
    for name, topo in FLEETS.items():
        toks, m = fleet_run(model, prompts, name, topo)
        agree = sum(a == b for t, r in zip(toks, paged_tokens)
                    for a, b in zip(t, r))
        m["tokens_agree_with_serve"] = f"{agree}/{32 * len(toks)}"
        emit("serve_fleet", topology=name, requests=len(toks),
             prompt_lengths=SERVE_LENGTHS, **m)
        if "int8" not in name and toks != paged_tokens:
            raise AssertionError(f"serve_fleet {name}: tokens differ from "
                                 "the Serve run's")
        res[name] = m
        torch.cuda.empty_cache()
    prefix = np.random.default_rng(1).integers(0, model.config.vocab_size,
                                               SHARED_PREFIX)
    shared = [np.concatenate([prefix, p]) for p in prompts]
    eng, single, _, _ = serve_run(model, shared, warm=True)
    eng.close()
    name = "disaggregated_shared_prefix"
    toks, m = fleet_run(model, shared, name, FLEETS["disaggregated"])
    m["tokens_equal_single_engine"] = toks == single
    emit("serve_fleet", topology=name, requests=len(toks),
         shared_prefix=SHARED_PREFIX, prompt_lengths=SERVE_LENGTHS, **m)
    if toks != single or not m["affinity_total"].get("affine") or \
            not m["skipped_blocks"]:
        raise AssertionError(f"serve_fleet {name}: tokens equal "
                             f"{toks == single}, affinity "
                             f"{m['affinity_total']}, skipped blocks "
                             f"{m['skipped_blocks']}")
    torch.cuda.empty_cache()
    toks, m = park_run(model, prompts)
    m["tokens_equal_serve"] = toks == paged_tokens
    emit("serve_fleet", topology="park_resume", requests=len(toks), **m)
    if toks != paged_tokens:
        raise AssertionError("serve_fleet park_resume: tokens differ from "
                             "the Serve run's")
    torch.cuda.empty_cache()
    launches = {fn.__name__: fn.launches
                for fn in kernels.SERVING + kernels.SERVING_QUANT}
    bf16 = res["disaggregated"]["handoff_bytes"]
    int8 = res["disaggregated_int8_both"]["handoff_bytes"]
    ratio = int8 / bf16 if bf16 else None
    emit("serve_fleet", summary=True, int8_to_bf16_wire=ratio,
         launches=launches)
    if not bf16 or not res["disaggregated_int8_decode"]["handoff_bytes"] \
            or not 0.45 <= ratio <= 0.6:
        raise AssertionError(f"serve_fleet: handoff bytes bf16 {bf16}, "
                             f"int8 {int8}")
    if not all(launches[fn.__name__] for fn in kernels.SERVING) or \
            not launches["paged_decode_attention_int8"]:
        raise AssertionError(f"serve_fleet: launches {launches}")
    return launches


STATIC_BUCKETS = (128, 256, 512, 768)


def serve_static(kernels, model, prompts, paged_tokens):
    """The slot-contiguous engine (paged_kv=False, buckets 128..768,
    max_len 1024) over Serve's prompts, eager and after aot_warmup (the
    decode, one prefill a bucket and the insert as CUDA graphs).  Gates:
    the graphed tokens equal the eager ones; QKV and the MLP launched,
    paged decode not (static-cache attention is masked SDPA, as in JAX).
    Reported: decode tokens/s, TTFT, agreement with the paged engine."""
    kw = dict(paged_kv=False, prefill_buckets=STATIC_BUCKETS)
    e_eng, e_toks, e_m, _ = serve_run(model, prompts, **kw)
    e_eng.close()
    del e_eng
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    eng, toks, m, ws = serve_run(model, prompts, warm=True, **kw)
    launches = {fn.__name__: fn.launches for fn in kernels.SERVING}
    g = eng._graphs["serving.decode"]
    agree = sum(a == b for t, r in zip(toks, paged_tokens)
                for a, b in zip(t, r))
    emit("serve_static", buckets=list(STATIC_BUCKETS), requests=len(toks),
         tokens_equal_eager=toks == e_toks, eager=e_m, graphed=m,
         tokens_agree_with_paged=f"{agree}/{32 * len(toks)}",
         capture_s={t: v["seconds"] for t, v in ws.items()},
         launches_a_replay={t: v["launches"] for t, v in ws.items()},
         decode_replays=g.replays, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    if toks != e_toks:
        raise AssertionError("serve_static: graphed tokens differ from the "
                             "eager engine's")
    if not launches["fused_rmsnorm_qkv"] or not launches["fused_mlp"] or \
            launches["paged_decode_attention"]:
        raise AssertionError(f"serve_static: launches {launches}")
    a_replay = dict(g.launches)
    eng.close()
    del eng, g
    torch.cuda.empty_cache()
    return a_replay


def drive_static(model, prompt, n_new):
    """The prompt through the static-cache forward in one pass, then
    greedy steps at int offsets; returns (the prompt's fp32 logits,
    greedy tokens)."""
    from paddle_tpu_torch.generation import _empty_caches
    dev = model.device
    dtype = model.parameters()[0].dtype
    caches = _empty_caches(model, 1, len(prompt) + n_new, dtype)
    with torch.inference_mode():
        ids = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
        logits, _ = model(ids, None, caches, 0)
        last = logits[0].float()
        toks = [int(last[-1].argmax())]
        for i in range(n_new - 1):
            ids = torch.tensor([[toks[-1]]], dtype=torch.long, device=dev)
            logits, _ = model(ids, None, caches, len(prompt) + i)
            toks.append(int(logits[0, -1].float().argmax()))
    return last.cpu(), toks


def static_parity(card, host, prompt):
    """The parity phase's 2-layer full-width models through the
    static-cache path (the slot engine's and generate's): the prompt's
    logits on the card (bf16, kernels) within 5% of their largest of
    the host's (fp32, plain path), and 8 greedy tokens."""
    t0 = time.perf_counter()
    got, toks = drive_static(card, prompt, 8)
    ref, ref_toks = drive_static(host, prompt, 8)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = 0.05 * scale
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"static_parity: logits max abs err {err} > "
                             f"{tol}")
    agree = sum(a == b for a, b in zip(toks, ref_toks))
    emit("static_parity", layers=2, prompt=len(prompt),
         logits_shape=list(got.shape), max_abs_err=err, ref_max_abs=scale,
         tolerance=tol, greedy_tokens=toks, plain_tokens=ref_toks,
         tokens_agree=f"{agree}/{len(toks)}",
         seconds=time.perf_counter() - t0)


def concat_cache(card, kernels):
    """The parity phase's 2-layer full-width bf16 model through the
    concatenated ``(k, v)`` cache: a 256-token prefill from empty caches
    (sq == sk: flash), then 4 one-token steps, each step's logits within
    5% of their largest of a cache-free forward over the whole
    sequence (its logits at the same positions)."""
    cfg = card.config
    dev = card.device
    rng = np.random.default_rng(3)
    n0, steps = 256, 4
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, n0 + steps),
                          dtype=torch.long, device=dev)[None]
    empty = torch.zeros((1, 0, cfg.num_key_value_heads, cfg.head_dim),
                        dtype=torch.bfloat16, device=dev)
    caches = [(empty, empty) for _ in range(cfg.num_hidden_layers)]
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    with torch.inference_mode():
        logits, caches = card(ids[:, :n0], caches=caches)
        got = [logits[0, -1].float()]
        for i in range(steps):
            logits, caches = card(ids[:, n0 + i:n0 + i + 1], caches=caches,
                                  position_offset=n0 + i)
            got.append(logits[0, -1].float())
        launched = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        ref = card(ids)[0].float()
    want = ref[n0 - 1:n0 + steps]
    got = torch.stack(got)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = 0.05 * scale
    shapes = [tuple(c[0].shape) for c in caches]
    if not torch.isfinite(got).all() or err > tol or \
            shapes[0][1] != n0 + steps:
        raise AssertionError(f"concat_cache: logits max abs err {err} > "
                             f"{tol}, or caches {shapes}")
    if not launched["flash_attention_fwd"] or \
            not launched["fused_rmsnorm_qkv"] or not launched["fused_mlp"]:
        raise AssertionError(f"concat_cache: launches {launched}")
    emit("concat_cache", layers=cfg.num_hidden_layers, prefill=n0,
         steps=steps, cache_shape=list(shapes[0]), max_abs_err=err,
         ref_max_abs=scale, tolerance=tol,
         launches={k: v for k, v in launched.items() if v},
         seconds=time.perf_counter() - t0)


PTQ_BATCHES, PTQ_SHAPE = 4, (2, 64)
QAT_STEPS, QAT_SHAPE = 4, (1, 32)
# QAT's first-step gradients of each fake-quant layer, card (fp32) against
# the CPU (fp32) from the same layer inputs: the largest difference over
# the largest magnitude (fp32 summation order alone is ~1e-6)
QAT_GRAD_TOL = 1e-3


def _unwrap_fake(root):
    """Put each FakeQuantLinear's Linear back (QAT's wrappers off)."""
    from paddle_tpu_torch.quantization import FakeQuantLinear
    for name, child in list(root.named_children()):
        if isinstance(child, FakeQuantLinear):
            setattr(root, name, child.linear)
        else:
            _unwrap_fake(child)


def qat_loss(model, ids):
    """Next-token cross-entropy over the model's logits (the QAT model's
    lm_head is wrapped, so ``loss()``'s fused head does not apply)."""
    from paddle_tpu_torch.nn import functional as F
    logits = model(ids[:, :-1])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           ids[:, 1:].reshape(-1))


def qat_layer_grads(name, rec):
    """One fake-quant layer's weight (and bias) gradients on the CPU in
    fp32 from the card's own input, activation scale and output gradient
    of that layer: ``(weight grad, bias grad or None)``."""
    from paddle_tpu_torch.quantization import _absmax_scale, quant_dequant
    w = rec["w"].cpu().requires_grad_()
    b = None if rec["b"] is None else rec["b"].cpu().requires_grad_()
    xq = quant_dequant(rec["x"].cpu(), rec["scale"])
    wq = quant_dequant(w, _absmax_scale(w.detach()))
    out = torch.matmul(xq, wq)
    if b is not None:
        out = out + b
    out.backward(rec["gy"].cpu())
    return w.grad, None if b is None else b.grad


def ptq_qat(card, host, kernels):
    """Calibration at Llama-3-8B width, 2 layers.  QAT: a fresh fp32 card
    copy of the host model wrapped by ``QAT``, a few eager AdamW steps on
    one batch: the loss must fall, the first loss must be within 1e-4 of
    the host's fp32 forward, and each fake-quant layer's first-step
    weight gradients within QAT_GRAD_TOL of their largest of the CPU's
    fp32 gradients of that layer from the card's own input, activation
    scale and output gradient.  (The whole model's gradients are not
    comparable to that bound: bf16-free but differently summed
    activations flip fake-quant codes at their rounding boundaries, each
    flip one quant step, ~1% of a layer's range.)  PTQ: the bf16 card
    model calibrated over 4 batches, converted to W8A8, a forward: every
    converted layer's int32 accumulators on the card (``torch._int_mm``)
    bitwise equal to the CPU's on the same inputs, and the logits within
    5% of their largest of the host's fp32 forward through the card's
    codes and scales.  Both models are consumed."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.quantization import (PTQ, QAT, FakeQuantLinear,
                                               QuantedLinear,
                                               int8_linear_accumulate)
    cfg = host.config
    dev = card.device
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    # QAT on an fp32 card copy; each fake-quant layer's first step kept
    model = LlamaForCausalLM(cfg, device=dev)
    model.set_state_dict({k: v for k, v in host.state_dict().items()})
    QAT().quantize(model)
    recs = {}

    def keep(name):
        def hook(mod, args, out):
            rec = recs[name] = {"x": args[0].detach().clone(),
                                "scale": mod.act_observer.scale(),
                                "w": mod.linear.weight.detach().clone(),
                                "b": None if mod.linear.bias is None
                                else mod.linear.bias.detach().clone()}
            out.register_hook(lambda g: rec.__setitem__("gy", g.detach()))
        return hook

    fakes = {n: m for n, m in model.named_modules()
             if isinstance(m, FakeQuantLinear)}
    hooks = [m.register_forward_hook(keep(n)) for n, m in fakes.items()]
    ids = rng.integers(0, cfg.vocab_size, QAT_SHAPE)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    losses = []
    kernels.reset_launch_counts()
    for step in range(QAT_STEPS):
        loss = qat_loss(model, torch.as_tensor(ids, device=dev))
        loss.backward()
        if step == 0:
            for h in hooks:
                h.remove()
            for n, m in fakes.items():
                recs[n]["gw"] = m.linear.weight.grad.detach().cpu()
                recs[n]["gb"] = None if m.linear.bias is None else \
                    m.linear.bias.grad.detach().cpu()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    qat_launches = {k: v for k, v in ((fn.__name__, fn.launches)
                                      for fn in kernels.KERNELS) if v}
    del model, opt, fakes
    torch.cuda.empty_cache()
    worst, worst_name = -1.0, None
    for n, rec in recs.items():
        gw, gb = qat_layer_grads(n, rec)
        for what, got, ref in (("weight", rec["gw"], gw),
                               ("bias", rec["gb"], gb)):
            if ref is None:
                continue
            rel = float((got - ref).abs().max()) / \
                max(float(ref.abs().max()), 1e-30)
            if rel > worst:
                worst, worst_name = rel, f"{n}.{what}"
    del recs
    QAT().quantize(host)
    with torch.no_grad():
        hloss = float(qat_loss(host, torch.as_tensor(ids)))
    _unwrap_fake(host)
    if not losses[-1] < losses[0] or worst > QAT_GRAD_TOL or \
            abs(losses[0] - hloss) > 1e-4 * abs(hloss):
        raise AssertionError(f"ptq_qat: QAT losses {losses} (host "
                             f"{hloss}), worst layer gradient {worst} "
                             f"({worst_name})")
    qat_s = time.perf_counter() - t0
    # PTQ on the bf16 card model; the host carries its codes and scales
    t0 = time.perf_counter()
    ptq = PTQ()
    ptq.quantize(card)
    with torch.inference_mode():
        for _ in range(PTQ_BATCHES):
            card(torch.as_tensor(rng.integers(0, cfg.vocab_size, PTQ_SHAPE),
                                 device=dev))
    ptq.convert(card)
    PTQ().quantize(host)
    PTQ().convert(host)
    host.set_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    layers = {n: m for n, m in card.named_modules()
              if isinstance(m, QuantedLinear)}
    for n, m in host.named_modules():
        if isinstance(m, QuantedLinear):
            m.act_scale = layers[n].act_scale
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, n=n: inputs.__setitem__(n, args[0]))
        for n, m in layers.items()]
    x = rng.integers(0, cfg.vocab_size, PTQ_SHAPE)
    with torch.inference_mode():
        got = card(torch.as_tensor(x, device=dev))[0].float().cpu()
        ref = host(torch.as_tensor(x))[0].float()
        bitwise = {}
        for n, m in layers.items():
            xin = inputs[n].reshape(-1, inputs[n].shape[-1])[:32]
            acc = int8_linear_accumulate(xin, m.act_scale, m.qweight)
            cpu = int8_linear_accumulate(xin.cpu(), m.act_scale,
                                         m.qweight.cpu())
            bitwise[n] = bool(torch.equal(acc.cpu(), cpu))
    for h in hooks:
        h.remove()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = 0.05 * scale
    emit("ptq_qat", layers=cfg.num_hidden_layers, qat_steps=QAT_STEPS,
         qat_shape=list(QAT_SHAPE), qat_losses=losses,
         qat_host_loss=hloss, qat_worst_layer_grad_rel=worst,
         qat_worst_grad=worst_name, qat_grad_tolerance=QAT_GRAD_TOL,
         qat_launches=qat_launches, qat_s=qat_s,
         ptq_batches=PTQ_BATCHES, ptq_shape=list(PTQ_SHAPE),
         converted_layers=len(layers),
         act_scales={n: m.act_scale for n, m in list(layers.items())[:3]},
         int32_bitwise_layers=f"{sum(bitwise.values())}/{len(bitwise)}",
         max_abs_err=err, ref_max_abs=scale, tolerance=tol,
         ptq_s=time.perf_counter() - t0)
    if not all(bitwise.values()) or not torch.isfinite(got).all() or \
            err > tol:
        raise AssertionError(f"ptq_qat: PTQ accumulators bitwise "
                             f"{bitwise}, logits err {err} > {tol}")


def eager_generate(model, ids, n):
    """generate()'s greedy decode as a plain loop over the same
    static-cache forward (the prompt in one pass, then a step a token at
    a 0-d device position); returns (tokens [B, L + n], each step's
    event-timed ms)."""
    from paddle_tpu_torch.generation import _empty_caches
    B, L = ids.shape
    dtype = model.parameters()[0].dtype
    ms = []
    with torch.inference_mode():
        caches = _empty_caches(model, B, L + n, dtype)
        logits, _ = model(ids, None, caches, 0)
        toks = [logits[:, -1].float().argmax(-1)]
        for i in range(n - 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pos = torch.tensor(L + i, device=ids.device)
            logits, _ = model(toks[-1][:, None], None, caches, pos)
            toks.append(logits[:, -1].float().argmax(-1))
            end.record()
            ms.append((start, end))
        out = torch.cat([ids, torch.stack(toks, 1)], 1).to(torch.int32)
        out = out.cpu().numpy()
    return out, [a.elapsed_time(b) for a, b in ms]


def generate_phase(kernels, model, arch, B, L, n, wrappers):
    """`model.generate` at batch B, prompt L, n new greedy tokens: a
    first call (it captures the step), then a timed call, both against
    eager_generate's loop, exactly; then the EOS / pad rule on a forced
    EOS id (each row's tokens up to its first EOS, pads after it).
    `wrappers`: the kernels the path must launch (counts reset first).
    Reports tokens/s and ms a step, eager and graphed, capture seconds
    and launches a replay."""
    from paddle_tpu_torch import generation as G
    cfg = model.config
    dev = model.device
    ids = torch.as_tensor(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (B, L)), device=dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    first = model.generate(ids, max_new_tokens=n)
    first_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}
    run = next(reversed(G._RUN_CACHE[model].values()))
    timed = TimedReplays(run.step.graph)
    run.step.graph = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = model.generate(ids, max_new_tokens=n)
    graphed_s = time.perf_counter() - t0
    run.step.graph = timed.inner
    step_ms = timed.ms()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, eager_ms = eager_generate(model, ids, n)
    eager_s = time.perf_counter() - t0
    info = G.run_cache_info(model)[-1]
    same = bool(np.array_equal(got, ref) and np.array_equal(first, ref))
    # the EOS / pad rule: each row's third new token forced as EOS
    eos = int(ref[0, L + 2])
    forced = model.generate(ids, max_new_tokens=n, eos_token_id=eos,
                            pad_token_id=0)
    want = ref.copy()
    for b in range(B):
        hits = np.flatnonzero(ref[b, L:] == eos)
        if len(hits):
            want[b, L + hits[0] + 1:] = 0
    eos_ok = bool(np.array_equal(forced, want))
    emit("generate", arch=arch, layers=cfg.num_hidden_layers,
         dtype=cfg.dtype, batch=B, prompt=L, new_tokens=n,
         tokens_equal_eager_loop=same, first_call_s=first_s,
         graphed_call_s=graphed_s, eager_loop_s=eager_s,
         graphed_tok_s=B * n / graphed_s, eager_tok_s=B * n / eager_s,
         graphed_step_ms=float(np.mean(step_ms)),
         eager_step_ms=float(np.mean(eager_ms)),
         capture_s=info["capture_s"], launches_a_replay=info["launches"],
         replays=info["replays"], launches=launches,
         eos_id=eos, eos_rows=int(sum((ref[:, L:] == eos).any(1))),
         eos_pad_rule=eos_ok, first_tokens=ref[:, L:L + 4].tolist())
    if not same:
        raise AssertionError(f"generate {arch}: the graphed tokens differ "
                             "from the eager loop's")
    if not eos_ok:
        raise AssertionError(f"generate {arch}: the EOS / pad rule broke")
    if not info["graph"] or info["replays"] != 2 * (n - 1):
        raise AssertionError(f"generate {arch}: {info}")
    if not all(launches.values()):
        raise AssertionError(f"generate {arch}: launches {launches}")
    a_replay = dict(info["launches"])
    G._RUN_CACHE.pop(model, None)
    torch.cuda.empty_cache()
    return a_replay


def generate_gpt(dev, kernels):
    """GPT-2 medium (GPTConfig(), 24 layers, bf16, random weights)
    through generate: batch 8, prompt 256, 64 new tokens.  Its path
    launches none of the port's kernels (cuBLAS Linears, LayerNorm, GELU
    and masked SDPA, as in JAX)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    seed(4)
    model = GPTForCausalLM(GPTConfig(dtype="bfloat16"), device=dev).eval()
    generate_phase(kernels, model, "gpt2_medium", 8, 256, 64, ())
    del model
    torch.cuda.empty_cache()


# the decode step's kernels (T <= 16 rows) whose device time the serving
# profiles report per decode step: paged decode, QKV's row pass and
# split-K, the quant matmul's split-K (every projection of the quantized
# engines), the MLP's split-K, and the wmma tile that the MLP took at
# decode before it (serve requires it to launch no time; a parent tree's
# profile reports its MLP under it)
DECODE_FAMILIES = ("paged_split_kernel", "qkv_decode_rows_kernel",
                   "qkv_splitk_kernel", "quant_splitk_kernel",
                   "mlp_splitk_kernel", "gemm_kernel")


def profile(eng, cfg, rng, phase="profile"):
    """Where a serving window's time goes: 8 requests (64-token prompts,
    16 new tokens) under torch.profiler; device time by kernel, the
    decode kernels' device ms per decode step, and the device's busy
    share of the window's wall time.  Run after the measured serve run,
    so profiling costs nothing there."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for _ in range(8):
        eng.add_request(rng.integers(0, cfg.vocab_size, 64),
                        max_new_tokens=16)
    steps0 = eng.stats["decode_steps"]
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = eng.stats["decode_steps"] - steps0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = kernel_spans(prof)
    busy_us = union_us(spans)
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:12]
    fams = family_times(kernels, DECODE_FAMILIES, spans)
    res = dict(requests=8, prompt=64, new_tokens=16, wall_s=wall,
               device_busy_s=busy_us / 1e6 if kernels else None,
               device_busy_share=busy_us / 1e6 / wall if kernels else None,
               decode_steps=steps, port_kernels=fams,
               ms_per_decode_step={f: v["ms"] / steps
                                   for f, v in fams.items()
                                   if v["calls"]} if steps else None,
               decode_kernels_ms_per_step=sum(
                   v["ms"] for v in fams.values()) / steps if steps
               else None,
               top=[{"kernel": e.key[:90], "ms": e.device_time_total / 1e3,
                     "calls": e.count} for e in top])
    emit(phase, **res)
    return res


def kernel_spans(prof):
    """(name, start us, end us) of every kernel the profiler saw."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def union_us(spans):
    """Microseconds of the union of the spans' intervals: the time some
    kernel of them ran.  The MLP's split-K down product is a dependent
    launch that starts during its gate/up and waits, so the sum of the
    kernels' own times would count that wait twice."""
    total, end = 0.0, float("-inf")
    for _, a, b in sorted(spans, key=lambda t: t[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _in_family(name, fam):
    return f"::{fam}<" in name or f"::{fam}(" in name


def family_times(kern, families, spans=None):
    """Device ms and calls of the port's kernels by family (the kernel
    function's name) among the profiler's CUDA events `kern`; with
    `spans` (kernel_spans), a family's ms is the union of its kernels'
    intervals."""
    port = {}
    for fam in families:
        hits = [e for e in kern if _in_family(e.key, fam)]
        us = sum(e.device_time_total for e in hits) if spans is None else \
            union_us([t for t in spans if _in_family(t[0], fam)])
        port[fam] = {"ms": us / 1e3, "calls": sum(e.count for e in hits)}
    return port


# -- phase 7: the training step ----------------------------------------------

TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 4, 2048, 5


def train(dev, kernels):
    """The slice's main path: TrainStep(LlamaForCausalLM, AdamW) at
    Llama-3-8B width, 4 layers, bf16, b=4, s=2048, one fixed batch."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = TRAIN_LAYERS
    seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev)
    opt = AdamW(learning_rate=1e-4, multi_precision=True)
    step = TrainStep(model, opt, guard_nonfinite=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    t0 = time.perf_counter()
    losses = [float(step(batch))]                  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step(batch)
        losses.append(float(loss.detach()))      # the guard has synced already
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in kernels.TRAINING}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall {losses}")
    if any(step.skipped.values()) or step.step_count != 1 + TRAIN_STEPS:
        raise AssertionError(f"train: skipped steps {step.skipped}, "
                             f"step_count {step.step_count}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"train: kernel {name} never launched")
    by_path = gemm_paths(kernels)
    require_paths("train", by_path,
                  {("fused_mlp", "wgmma"): TRAIN_LAYERS * TRAIN_STEPS,
                   ("fused_mlp", "tile"): 0})
    launches.update(require_mt("train", kernels, TRAIN_STEPS))
    dt = float(np.median(times))
    tokens = TRAIN_B * TRAIN_S
    # bench.py's formula: 6N + 12 L s d FLOPs per token over the bf16 peak
    flops_tok = 6 * n_params + 12 * TRAIN_LAYERS * TRAIN_S * cfg.hidden_size
    ce = ce_device_ms(dev, tokens, cfg.hidden_size, cfg.vocab_size)
    emit("train", layers=TRAIN_LAYERS, dtype=cfg.dtype, batch=TRAIN_B,
         seq=TRAIN_S, params=n_params, optimizer="AdamW(lr=1e-4, "
         "multi_precision=True)", matmul_precision=matmul_mode(),
         ce_device=ce, ce_share_of_step=ce["ms"] / 1e3 / dt,
         model_build_s=build_s, warmup_s=warm_s,
         step_s=times, step_s_median=dt, tokens_per_s=tokens / dt,
         mfu=flops_tok * tokens / dt / BF16_FLOP_PER_S,
         peak_mem_gb=peak, losses=losses,
         launches=launches, launches_by_path=by_path,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()})
    train_profile(step, batch)
    return launches, peak


@contextlib.contextmanager
def bf16_products():
    """The CE gate's control: inside the block the chunked CE's products
    take bf16-rounded operands (one bf16 pass, exact products summed in
    fp32, as a TPU's default precision gives), with everything else of
    the CE as it is."""
    from paddle_tpu_torch.nn.functional import loss as L
    mm = L._mm
    L._mm = lambda a, b, tf32: mm(a.bfloat16().float(), b.bfloat16().float(),
                                  False)
    try:
        yield
    finally:
        L._mm = mm


def ce_breaches(err, io):
    """The CE_TF32_TOL[io] limits that `err` (loss_rel and gradients'
    max abs error over their largest |g|, keyed *_of_max) breaks."""
    tol = CE_TF32_TOL[io]
    return [k for k, v in err.items()
            if not v <= tol["loss_rel" if k == "loss_rel" else
                            "grad_of_max"]]


def ce_device_ms(dev, T, d, V):
    """Device ms of one forward and backward of the chunked lm-head CE
    (F.fused_linear_cross_entropy, chunks of 8192) at a training step's
    shape, bf16 hidden rows and weight as the model hands them over, CUDA
    events around a second call: at the flag's default (the chunk
    products in TF32), the training phases' setting, and at float32
    (exact fp32, as before).  The first call's loss and gradients at the
    default are held against float32's within CE_TF32_TOL["bfloat16"];
    the control (bf16_products) is reported beside them: with bf16 h and
    W it rounds nothing that TF32 keeps, so it is not expected to break
    them."""
    from paddle_tpu_torch.nn import functional as F_
    g = torch.Generator(device=dev).manual_seed(9)
    h = rand(g, (T, d), torch.bfloat16, dev).requires_grad_(True)
    w = rand(g, (d, V), torch.bfloat16, dev, 0.02).requires_grad_(True)
    lbl = torch.randint(0, V, (T,), generator=g, device=dev)

    def run():
        h.grad = w.grad = None
        loss = F_.fused_linear_cross_entropy(h, w, lbl)
        loss.backward()
        return float(loss)
    ms, res = {}, {}
    for mode in ("default", "float32"):
        with matmul_precision(mode):
            res[mode] = (run(), h.grad.float(), w.grad.float())
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            ms[mode] = a.elapsed_time(b)
    with matmul_precision("float32"), bf16_products():
        res["bf16_control"] = (run(), h.grad.float(), w.grad.float())
    l32, *g32 = res["float32"]
    err = {}
    for mode in ("default", "bf16_control"):
        lm, *gm = res.pop(mode)
        err[mode] = {"loss_rel": abs(lm - l32) / abs(l32)}
        for name, a_, b_ in zip(("dh", "dw"), gm, g32):
            err[mode][name + "_of_max"] = float((a_ - b_).abs().max() /
                                                b_.abs().max())
        del gm
    if ce_breaches(err["default"], "bfloat16"):
        raise AssertionError(f"ce_device T={T} d={d} V={V}: TF32 against "
                             f"float32 {err['default']}, limits "
                             f"{CE_TF32_TOL['bfloat16']}")
    err["bf16_control"]["breaks"] = ce_breaches(err["bf16_control"],
                                                "bfloat16")
    del h, w, lbl, res, g32
    torch.cuda.empty_cache()
    return {"shape": f"T={T} d={d} V={V} bf16", "ms": ms["default"],
            "float32_ms": ms["float32"], "tf32_vs_float32": err["default"],
            "bf16_control_vs_float32": err["bf16_control"]}


TRAIN_FAMILIES = ("grouped_hopper", "mlp_gemm_kernel", "flash_fwd_hopper",
                  "qkv_rows_kernel", "qkv_gemm_kernel", "flash_dq_hopper",
                  "flash_dkv_hopper")


def train_profile(step, batch, phase="train_profile", top_n=15,
                  families=TRAIN_FAMILIES):
    """One more step under torch.profiler (profile_call)."""
    return profile_call(lambda: step(batch), phase, families, top_n,
                        steps=1)


def require_mt(what, kernels, n_steps):
    """Raise unless each multi-tensor kernel (the gradient norm, the
    AdamW update) launched once a step; returns their counts."""
    got = {fn.__name__: fn.launches for fn in kernels.MULTI_TENSOR}
    if got != dict.fromkeys(got, n_steps):
        raise AssertionError(f"{what}: multi-tensor launches {got} in "
                             f"{n_steps} steps, expected one a step each")
    return got


def profile_call(fn, phase, families, top_n=15, **extra):
    """One call of `fn` under torch.profiler: the device's busy share of
    its wall time, the kernels launched, the top kernels by device time,
    and the device time of the port's own kernels by family (emitted and
    returned)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.device_time_total)[:top_n]
    port = family_times(kern, families)
    out = dict(**extra, wall_s=wall,
               device_busy_s=busy_us / 1e6 if kern else None,
               device_busy_share=busy_us / 1e6 / wall if kern else None,
               kernel_launches=sum(e.count for e in kern), port_kernels=port,
               top=[{"kernel": e.key[:90], "ms": e.device_time_total / 1e3,
                     "calls": e.count} for e in top])
    emit(phase, **out)
    return out


# -- the MoE slice: ERNIE-4.5-21B-A3B width ----------------------------------

ME, MK, MD, MH = 64, 6, 2560, 1536     # experts, top-k, d, expert hidden
MOE_B, MOE_S = 4, 2048
MOE_C = int(1.25 * MK * MOE_B * MOE_S / ME)     # 960 capacity slots
# the grouped kernel's bf16 limit: kernel and plain version round the
# hidden to bf16 at the same point and the output once, so they differ by
# the fp32 summation order, a rare one-step flip of a hidden element, and
# one bf16 rounding of outputs of order 1
GROUPED_TOL = (1e-2, 2 ** -7)


def moe_routed_counts(TM, dev, g, T, C):
    """Per-expert kept counts of a real routing: T random bf16 tokens
    through a Xavier-initialised [d, E] router and the port's gating."""
    x = rand(g, (T, MD), torch.bfloat16, dev)
    gate = rand(g, (MD, ME), torch.bfloat16, dev, (2.0 / (MD + ME)) ** 0.5)
    topi, _, _, keep, _ = TM.top_k_gating_indices(x @ gate, MK, C)
    return TM._expert_counts(topi, keep, ME)


def grouped_case(GM, dev, timer, G, C, dtype, counts, g):
    """One grouped expert-FFN case: the kernel pair against its plain
    version (rows past each count exactly zero), then timed beside the
    plain version and the library chain baddbmm -> gelu -> baddbmm."""
    F_ = torch.nn.functional
    rep = G // ME
    x = rand(g, (G, C, MD), dtype, dev)
    w1 = rand(g, (ME, MD, MH), dtype, dev, MD ** -0.5)
    b1 = rand(g, (ME, MH), dtype, dev, 0.1)
    w2 = rand(g, (ME, MH, MD), dtype, dev, MH ** -0.5)
    b2 = rand(g, (ME, MD), dtype, dev, 0.1)
    args = (x, w1, b1, w2, b2)
    paths = dict(GM.grouped_expert_ffn.launches_by_path)
    got = GM.grouped_expert_ffn(*args, counts=counts)
    path = "wgmma" if dtype == torch.bfloat16 else "tile"
    paths[path] += 1
    if GM.grouped_expert_ffn.launches_by_path != paths:
        raise AssertionError(f"grouped_expert_ffn {dtype}: expected the "
                             f"{path} path, {paths}")
    tol = GROUPED_TOL if dtype == torch.bfloat16 else TOL[dtype]
    what, used = f"grouped_expert_ffn G={G} C={C} {dtype}", {}
    err = check_close(what, got, GM.grouped_expert_ffn_reference(
        *args, counts=counts), dtype, tol, used)
    past = torch.arange(C, device=dev)[None, :] >= counts[:, None].long()
    if bool(got[past].any()):
        raise AssertionError(f"{what}: rows past the count are not zero")
    del got
    xr = x.reshape(ME, rep * C, MD)

    def library():
        h = F_.gelu(torch.baddbmm(b1[:, None, :], xr, w1))
        return torch.baddbmm(b2[:, None, :], h, w2)

    n = int(counts.sum())
    isz = x.element_size()
    out = {"ms": timer(lambda: GM.grouped_expert_ffn(*args, counts=counts)),
           "plain_ms": timer(lambda: GM.grouped_expert_ffn_reference(
               *args, counts=counts), iters=3, warmup=1),
           "library_ms": timer(library)}
    # rows read: the routed ones; y written whole (zeros past the counts)
    out["bound_ms"], out["bound_by"] = bound_ms(
        *grouped_io(n, G, C, isz, ME, MD, MH),
        BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S)
    out["max_abs_err"] = err
    out["tolerance"] = dict(zip(("atol", "rtol"), tol))
    out["limit_used"] = used[what]
    out["path"] = path
    out["routed_rows"] = n
    out["counts_min_max"] = [int(counts.min()), int(counts.max())]
    out["workspace_bytes"] = 2 * G * C * MH * isz
    out["shape"] = (f"G={G} E={ME} C={C} d={MD} h={MH} "
                    f"{str(dtype)[6:]}")
    del args, x, w1, w2, xr
    torch.cuda.empty_cache()
    return out


def kernels_moe(GM, TM, dev, timer):
    """The grouped kernel at the MoE step's shape (bf16, counts from a
    real routing of b*s = 8192 tokens), with counts 0, C and partial in
    turn, in fp32 at C = 64, and with G = 2E groups (rep 2)."""
    g = torch.Generator(device=dev).manual_seed(41)
    routed = moe_routed_counts(TM, dev, g, MOE_B * MOE_S, MOE_C)
    pattern = [0, MOE_C, MOE_C // 2 + 5, 37]
    mixed = torch.tensor([pattern[i % 4] for i in range(ME)],
                         dtype=torch.int32, device=dev)
    half = MOE_C // 2
    rep2 = torch.tensor([(0, half, half // 2 + 5, 37)[i % 4]
                         for i in range(2 * ME)],
                        dtype=torch.int32, device=dev)
    return {
        "routed bf16": grouped_case(GM, dev, timer, ME, MOE_C,
                                    torch.bfloat16, routed, g),
        "counts 0/C/partial bf16": grouped_case(GM, dev, timer, ME, MOE_C,
                                                torch.bfloat16, mixed, g),
        "fp32 C=64": grouped_case(
            GM, dev, timer, ME, 64, torch.float32,
            torch.tensor([(0, 64, 37, 63)[i % 4] for i in range(ME)],
                         dtype=torch.int32, device=dev), g),
        "rep 2 bf16": grouped_case(GM, dev, timer, 2 * ME, half,
                                   torch.bfloat16, rep2, g),
    }


def _plain_expert_ffn(GM):
    """``_expert_ffn`` through the plain version, differentiated by
    autograd: the plain path of the parity phases."""
    def ffn(x, w1, b1, w2, b2, act, counts=None):
        return GM.grouped_expert_ffn_reference(x, w1, b1, w2, b2, counts,
                                               act)
    return ffn


def moe_layer_parity(GM, TM, dev, dtype):
    """One full-width MoELayer (d 2560, 64 experts of 1536, top-6, T =
    2048, capacity 240), forward and backward of sum(out * r) + aux on the
    card, kernel path against plain path on the same input: the same
    routing (checked by the per-expert loads), the output and the
    gradient of x and of every parameter within 2e-2 (bf16) / 1e-3
    (fp32) of each array's largest magnitude."""
    from paddle_tpu_torch import seed
    seed(5)
    layer = TM.MoELayer(d_model=MD, num_experts=ME, d_hidden=MH,
                        gate="naive", top_k=MK, capacity_factor=1.25,
                        dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    x = rand(g, (2, 1024, MD), dtype, dev)
    r = rand(g, (2, 1024, MD), torch.float32, dev)
    runs = []
    kernel_ffn = TM._expert_ffn
    for ffn in (kernel_ffn, _plain_expert_ffn(GM)):
        TM._expert_ffn = ffn
        try:
            layer.clear_gradients()
            xi = x.detach().clone().requires_grad_(True)
            out = layer(xi)
            ((out.float() * r).sum() + layer.aux_loss.float()).backward()
        finally:
            TM._expert_ffn = kernel_ffn
        grads = {n: p.grad.detach().clone()
                 for n, p in layer.named_parameters()}
        grads["x"] = xi.grad.detach()
        runs.append((out.detach(), grads,
                     layer.router_stats["load"].clone(),
                     float(layer.router_stats["dropped_frac"])))
    (out, grads, load, dropped), (rout, rgrads, rload, _) = runs
    if not torch.equal(load, rload):
        raise AssertionError("moe_parity: the two paths routed differently")
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-3
    worst = {}
    for name, a, b in [("out", out, rout)] + [
            (n, grads[n], rgrads[n]) for n in rgrads]:
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        if not torch.isfinite(a).all() or err > rel * scale + 1e-12:
            raise AssertionError(f"moe_parity {dtype}: {name} max abs err "
                                 f"{err} > {rel} * {scale}")
        worst[name] = err / scale if scale else 0.0
    return {"tolerance": f"{rel} of each array's max |.|",
            "rel_err": worst, "dropped_frac": dropped,
            "load_max_over_mean": float(load.max() / load.float().mean())}


def moe_parity(GM, TM, dev):
    """The MoELayer check in fp32 and bf16, then a 2-layer full-width
    ERNIE (one dense, one MoE layer) in fp32, FLAGS_default_matmul_
    precision=float32: the loss on the card (the kernels) against the
    same weights on the CPU (plain versions), with the token-expert
    choices of the two paths compared."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import ErnieForCausalLM, ernie45_moe_config
    t0 = time.perf_counter()
    layer = {str(dt)[6:]: moe_layer_parity(GM, TM, dev, dt)
             for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.empty_cache()
    cfg = ernie45_moe_config(num_hidden_layers=2, dtype="float32")
    seed(3)
    card = ErnieForCausalLM(cfg, device=dev)
    host = ErnieForCausalLM(cfg, device="cpu")
    host.set_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 513))
    choices, gating = [], TM.top_k_gating_indices

    def spy(*a, **kw):
        res = gating(*a, **kw)
        choices.append(res[0].cpu())
        return res

    losses = []
    TM.top_k_gating_indices = spy
    try:
        with torch.no_grad(), matmul_precision("float32"):
            for model in (card, host):
                x = torch.as_tensor(ids[:, :-1]).to(model.device)
                y = torch.as_tensor(ids[:, 1:]).to(model.device)
                losses.append(float(model.loss(x, y)))
    finally:
        TM.top_k_gating_indices = gating
    differ = int((choices[0] != choices[1]).sum())
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    # fp32 on both sides, sums in other orders; a near-tie choice that
    # flips moves one token's expert mix by two nearly equal weights
    if not np.isfinite(losses[0]) or rel > 1e-4:
        raise AssertionError(f"moe_parity: loss {losses[0]} vs plain "
                             f"{losses[1]} (rel {rel}), {differ} choices "
                             "differ")
    emit("moe_parity", layer_T=2048, layer_capacity=240, layer=layer,
         model_layers=2, model_dtype="float32", seq=512, loss=losses[0],
         plain_loss=losses[1], loss_rel_err=rel, loss_tolerance=1e-4,
         choices=int(choices[0].numel()), choices_differ=differ,
         seconds=time.perf_counter() - t0)
    del card, host


MOE_LAYERS, MOE_STEPS = 4, {"einsum": 5, "index": 3}


def train_moe(dev, kernels):
    """The slice's main path: TrainStep(ErnieForCausalLM, AdamW) at
    ERNIE-4.5-21B-A3B width, 4 of 28 layers (1 dense, 3 MoE), bf16, b=4,
    s=2048, one fixed batch; einsum dispatch for 1 + 5 steps, then a
    fresh model with index dispatch for 1 + 3.  Returns each run's
    launch counts."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import ErnieForCausalLM, ernie45_moe_config
    from paddle_tpu_torch.optimizer import AdamW
    runs = {}
    for mode, n_steps in MOE_STEPS.items():
        cfg = ernie45_moe_config(num_hidden_layers=MOE_LAYERS,
                                 dispatch_mode=mode)
        n_moe = MOE_LAYERS - cfg.first_k_dense_replace
        seed(0)
        t0 = time.perf_counter()
        model = ErnieForCausalLM(cfg, device=dev)
        opt = AdamW(learning_rate=1e-4, multi_precision=True)
        step = TrainStep(model, opt, guard_nonfinite=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        named = dict(model.named_parameters())
        n_params = sum(p.numel() for p in named.values())
        expert = sum(p.numel() for n, p in named.items() if ".experts." in n)
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (MOE_B, MOE_S + 1))
        batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
                 "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
        t0 = time.perf_counter()
        losses = [float(step(batch))]                   # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            losses.append(float(step(batch)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in kernels.TRAINING_MOE}
        by_path = gemm_paths(kernels)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        moes = [layer.moe for layer in model.model.layers
                if not layer.is_dense]
        dropped = [float(m.router_stats["dropped_frac"]) for m in moes]
        loads = [m.router_stats["load"].float() for m in moes]
        imbalance = [float(ld.max() / ld.mean()) for ld in loads]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train_moe {mode}: non-finite loss "
                                 f"{losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train_moe {mode}: loss did not fall "
                                 f"{losses}")
        if any(step.skipped.values()) or step.step_count != 1 + n_steps:
            raise AssertionError(f"train_moe {mode}: skipped steps "
                                 f"{step.skipped}, step_count "
                                 f"{step.step_count}")
        # per step: the grouped FFN once a MoE layer; flash forward and
        # both backward kernels once a layer; the SwiGLU pair in the dense
        # layer and in each MoE layer's shared experts
        want = {"grouped_expert_ffn": n_moe, "flash_attention_fwd":
                MOE_LAYERS, "flash_attention_bwd_dq": MOE_LAYERS,
                "flash_attention_bwd_dkv": MOE_LAYERS,
                "fused_mlp": MOE_LAYERS}
        for name, per_step in want.items():
            if launches[name] != per_step * n_steps:
                raise AssertionError(f"train_moe {mode}: {name} launched "
                                     f"{launches[name]} times in {n_steps} "
                                     f"steps, expected {per_step} a step")
        require_paths(f"train_moe {mode}", by_path,
                      {("grouped_expert_ffn", "wgmma"): n_moe * n_steps,
                       ("grouped_expert_ffn", "tile"): 0})
        launches.update(require_mt(f"train_moe {mode}", kernels, n_steps))
        dt = float(np.median(times))
        tokens = MOE_B * MOE_S
        # bench.py:477-488: activated parameters (the idle experts' share
        # of the expert weights left out), 6 N_act + 12 L s d a token
        idle = int(expert * (cfg.num_experts - cfg.num_experts_per_tok)
                   / cfg.num_experts)
        flops_tok = 6 * (n_params - idle) + \
            12 * MOE_LAYERS * MOE_S * cfg.hidden_size
        ce = ce_device_ms(dev, tokens, cfg.hidden_size, cfg.vocab_size)
        emit("train_moe", dispatch_mode=mode, layers=MOE_LAYERS,
             matmul_precision=matmul_mode(), ce_device=ce,
             ce_share_of_step=ce["ms"] / 1e3 / dt,
             moe_layers=n_moe, dtype=cfg.dtype, batch=MOE_B, seq=MOE_S,
             capacity=MOE_C, params=n_params, activated_params=n_params -
             idle, optimizer="AdamW(lr=1e-4, multi_precision=True)",
             model_build_s=build_s, warmup_s=warm_s, step_s=times,
             step_s_median=dt, tokens_per_s=tokens / dt,
             mfu=flops_tok * tokens / dt / BF16_FLOP_PER_S, peak_mem_gb=peak,
             losses=losses, dropped_frac=dropped,
             load_max_over_mean=imbalance, launches=launches,
             launches_by_path=by_path,
             launches_per_step={k: v / n_steps for k, v in launches.items()})
        if mode == "einsum":
            train_profile(step, batch, phase="train_moe_profile", top_n=25)
        emit("train_moe_graph", dispatch_mode=mode, eager_step_s_median=dt,
             **graph_check(f"train_moe {mode}", step, batch, kernels))
        runs[mode] = launches
        del model, opt, step, named, batch, moes, loads
        torch.cuda.empty_cache()
    return runs


# -- phase 9: the GPT slice at GPT-2-medium width ---------------------------

GPT_B, GPT_S, GPT_STEPS = 8, 1024, 5


def grad_parity(what, card, host, ids):
    """Loss and every gradient of `card` and `host` (the same weights) on
    one batch, FLAGS_default_matmul_precision=float32 (train_parity's
    setting): the loss within 1e-4 relative, each gradient within 1e-3
    of its largest magnitude (train_parity's limits).  Returns the
    losses and the four worst gradients' relative errors."""
    losses, grads = [], []
    with matmul_precision("float32"):
        for model in (card, host):
            loss, grad = loss_and_grads(model, ids)
            losses.append(loss)
            grads.append(grad)
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    if not rel <= 1e-4:
        raise AssertionError(f"{what}: loss {losses[0]} vs plain "
                             f"{losses[1]} (rel {rel})")
    worst = {}
    for n, ref in grads[1].items():
        got = grads[0][n].cpu()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        if not torch.isfinite(got).all() or err > 1e-3 * scale + 1e-12:
            raise AssertionError(f"{what}: grad {n} max abs err {err} > "
                                 f"1e-3 * {scale}")
        worst[n] = err / scale if scale else 0.0
    return losses, rel, dict(sorted(worst.items(), key=lambda kv: -kv[1])[:4])


def gpt_parity(dev, kernels):
    """A 2-layer fp32 GPTForCausalLM at GPT-2-medium width (vocab 50304,
    d 1024, 16 heads of 64), b=1, s=1024: loss and every gradient on the
    card (the CE kernels, flash through the head_dim pad) against the
    same weights on the CPU (plain versions), TF32 off."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    seed(4)
    t0 = time.perf_counter()
    card = GPTForCausalLM(cfg, device=dev)
    host = GPTForCausalLM(cfg, device="cpu")
    host.set_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 1025))
    kernels.reset_launch_counts()
    losses, rel, worst = grad_parity("gpt_parity", card, host, ids)
    launched = {fn.__name__: fn.launches for fn in kernels.TRAINING_GPT}
    want = {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
            "flash_attention_fwd": 2, "flash_attention_bwd_dq": 2,
            "flash_attention_bwd_dkv": 2}
    if launched != want:
        raise AssertionError(f"gpt_parity: launches {launched}, expected "
                             f"{want}")
    emit("gpt_parity", layers=2, vocab=cfg.vocab_size, batch=1, seq=1024,
         dtype="float32", loss=losses[0], plain_loss=losses[1],
         loss_rel_err=rel, loss_tolerance=1e-4,
         grad_tolerance="1e-3 of each grad's max |g|",
         worst_grad_rel_err=worst, launches=launched,
         seconds=time.perf_counter() - t0)
    del card, host


def train_gpt(dev, kernels):
    """The slice's main path: TrainStep(GPTForCausalLM, AdamW) at
    GPT-2-medium width with all 24 layers, bf16, dropout 0, b=8,
    s=1024, one fixed batch; launch counts checked per step."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPTConfig(dtype="bfloat16", hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    seed(0)
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device=dev)
    step = TrainStep(model, AdamW(learning_rate=1e-4, multi_precision=True),
                     guard_nonfinite=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (GPT_B, GPT_S + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    t0 = time.perf_counter()
    losses = [float(step(batch))]                   # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for _ in range(GPT_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in kernels.TRAINING_GPT}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_gpt: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_gpt: loss did not fall {losses}")
    if any(step.skipped.values()) or step.step_count != 1 + GPT_STEPS:
        raise AssertionError(f"train_gpt: skipped steps {step.skipped}, "
                             f"step_count {step.step_count}")
    # per step: the CE pair once; flash forward and both backward kernels
    # once a layer (head_dim 64 padded to 128, seq 1024)
    want = {"cross_entropy_fwd": 1, "cross_entropy_bwd": 1,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    for name, per_step in want.items():
        if launches[name] != per_step * GPT_STEPS:
            raise AssertionError(f"train_gpt: {name} launched "
                                 f"{launches[name]} times in {GPT_STEPS} "
                                 f"steps, expected {per_step} a step")
    launches.update(require_mt("train_gpt", kernels, GPT_STEPS))
    dt = float(np.median(times))
    tokens = GPT_B * GPT_S
    # bench.py:1141-1144: 6N + 12 L s d FLOPs a token over the bf16 peak
    flops_tok = 6 * n_params + 12 * L * GPT_S * cfg.hidden_size
    emit("train_gpt", layers=L, dtype=cfg.dtype, vocab=cfg.vocab_size,
         hidden=cfg.hidden_size, heads=cfg.num_attention_heads,
         batch=GPT_B, seq=GPT_S, params=n_params, flops_per_token=flops_tok,
         optimizer="AdamW(lr=1e-4, multi_precision=True)",
         model_build_s=build_s, warmup_s=warm_s, step_s=times,
         step_s_median=dt, tokens_per_s=tokens / dt,
         mfu=flops_tok * tokens / dt / BF16_FLOP_PER_S, peak_mem_gb=peak,
         losses=losses, launches=launches,
         launches_per_step={k: v / GPT_STEPS for k, v in launches.items()},
         hook_off_vs_before={"step_s": dt,
                             "before_hook_s": HOOK_REF["train_gpt_s"]})
    train_profile(step, batch, phase="train_gpt_profile", top_n=20,
                  families=("ce_fwd_kernel", "ce_bwd_kernel",
                            "flash_fwd_hopper", "flash_dq_hopper",
                            "flash_dkv_hopper"))
    return launches


# -- phase 10: nn.Transformer inference (the base model) ---------------------

TRANSFORMER_FWDS = 5


def transformer_infer(dev, kernels):
    """nn.Transformer() in bf16, eval, b=32, source and target length 256,
    the causal target mask: the output against the same model with its
    FFN on the plain route (ffn_reference, on the card); forward seconds
    (median of TRANSFORMER_FWDS, each ending in a synchronize), tokens per
    second and fused_ffn launches (12 a forward).  Then a 2 + 2-layer fp32
    card-vs-CPU parity and a profiled forward."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nn import Transformer
    from paddle_tpu_torch.nn import transformer as TT
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    seed(0)
    t0 = time.perf_counter()
    model = Transformer(dtype="bfloat16", device=dev).eval()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_layers = len(model.encoder.layers) + len(model.decoder.layers)
    g = torch.Generator(device=dev).manual_seed(9)
    src = rand(g, (TB, TS, TD), torch.bfloat16, dev)
    tgt = rand(g, (TB, TS, TD), torch.bfloat16, dev)
    mask = Transformer.generate_square_subsequent_mask(TS, device=dev)

    def fwd():
        with torch.inference_mode():
            return model(src, tgt, tgt_mask=mask)

    fwd()                                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for _ in range(TRANSFORMER_FWDS):
        t0 = time.perf_counter()
        out = fwd()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in kernels.TRANSFORMER}
    if launches["fused_ffn"] != n_layers * TRANSFORMER_FWDS:
        raise AssertionError(f"transformer_infer: fused_ffn launched "
                             f"{launches['fused_ffn']} times in "
                             f"{TRANSFORMER_FWDS} forwards, expected "
                             f"{n_layers} a forward")
    by_path = gemm_paths(kernels)
    require_paths("transformer_infer", by_path,
                  {("fused_ffn", "wgmma"): n_layers * TRANSFORMER_FWDS,
                   ("fused_ffn", "tile"): 0})
    kernel_ffn = TT.F.fused_ffn

    def plain_ffn(x, w1, w2, b1=None, b2=None, activation="relu"):
        return FB.ffn_reference(x, w1, b1, w2, b2, activation)

    TT.F.fused_ffn = plain_ffn
    try:
        ref = fwd()
    finally:
        TT.F.fused_ffn = kernel_ffn
    err = float((out.float() - ref.float()).abs().max())
    mean_err = float((out.float() - ref.float()).abs().mean())
    scale = float(ref.float().abs().max())
    # both routes round h to bf16 at the same point and y once; an fp32
    # summation order that flips one bf16 step of h carries through the
    # later layers' post-LN outputs of unit scale
    tol = 0.05 * scale
    if not torch.isfinite(out).all() or err > tol:
        raise AssertionError(f"transformer_infer: max abs err {err} > {tol}")
    dt = float(np.median(times))
    emit("transformer_infer", d_model=TD, heads=8, encoder_layers=6,
         decoder_layers=6, ffn=TF_, activation="relu", dtype="bfloat16",
         batch=TB, src_len=TS, tgt_len=TS, model_build_s=build_s,
         fwd_s=times, fwd_s_median=dt, tokens_per_s=TB * 2 * TS / dt,
         target_tokens_per_s=TB * TS / dt, out_shape=list(out.shape),
         max_abs_err_vs_plain_ffn=err, mean_abs_err=mean_err,
         ref_max_abs=scale, tolerance=tol, launches=launches,
         launches_by_path=by_path["fused_ffn"],
         launches_per_forward={k: v / TRANSFORMER_FWDS
                               for k, v in launches.items()},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         parity_fp32=transformer_parity(dev),
         hook_off_vs_before={"fwd_ms": dt * 1e3,
                             "before_hook_ms": HOOK_REF["transformer_ms"]})
    profile_call(fwd, "transformer_profile",
                 families=("mlp_gemm_kernel",), top_n=15)
    del model, out, ref
    return launches


def transformer_parity(dev):
    """A 2 + 2-layer fp32 Transformer at the base width (d_model 512, FFN
    2048), b=2, length 256, on the card against the same weights on the
    CPU: the output within 1e-4 of its largest magnitude."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.nn import Transformer
    seed(5)
    kw = dict(num_encoder_layers=2, num_decoder_layers=2)
    card = Transformer(**kw, device=dev).eval()
    host = Transformer(**kw, device="cpu").eval()
    host.set_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    rng = np.random.default_rng(5)
    src, tgt = (torch.as_tensor(rng.standard_normal((2, TS, TD)),
                                dtype=torch.float32) for _ in range(2))
    mask = Transformer.generate_square_subsequent_mask(TS)
    with torch.inference_mode():
        got = card(src.to(dev), tgt.to(dev), tgt_mask=mask.to(dev)).cpu()
        ref = host(src, tgt, tgt_mask=mask)
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.isfinite(got).all() or err > 1e-4 * scale:
        raise AssertionError(f"transformer parity: max abs err {err} > "
                             f"1e-4 * {scale}")
    return {"layers": "2+2", "batch": 2, "len": TS, "max_abs_err": err,
            "ref_max_abs": scale, "tolerance": "1e-4 of the largest |out|"}


# -- phase 11: the Llama decoder tier (PADDLE_TPU_FUSED_BLOCK=decoder) -------

DEC_B, DEC_S, DEC_STEPS, DEC_FWDS = 4, 2048, 3, 2
DEC_H, DEC_HK, DEC_HD = 32, 8, 128
# the block kernel against decoder_reference, as a share of the output's
# largest magnitude: fp32 products in another order (1e-4); in bf16 both
# round at the same cast points, and a bf16 step flipped by another
# summation order carries through the block (3e-2, the JAX tests' limit)
DECODER_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the rmsnorm rows: h is the same fp32 sum rounded once (equal); inv an
# fp32 sum of d squares in another order; y in bf16 within one bf16 step
# (inv's last bits may flip a rounding), in fp32 within 1e-5
NORM_TOL = {torch.float32: (1e-6, 1e-5), torch.bfloat16: (1e-6, 2 ** -7)}
NORM_T = 8192


@contextlib.contextmanager
def decoder_tier():
    """PADDLE_TPU_FUSED_BLOCK=decoder inside the block (the knob is read
    at call time), the caller's value restored after."""
    old = os.environ.get("PADDLE_TPU_FUSED_BLOCK")
    os.environ["PADDLE_TPU_FUSED_BLOCK"] = "decoder"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PADDLE_TPU_FUSED_BLOCK")
        else:
            os.environ["PADDLE_TPU_FUSED_BLOCK"] = old


def check_share(what, got, ref, limit):
    """(max abs err, its share of ref's largest magnitude), raising on a
    non-finite output or a share above `limit`."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = float((got.float() - ref.float()).abs().max())
    share = err / max(float(ref.float().abs().max()), 1e-30)
    if share > limit:
        raise AssertionError(f"{what}: max abs err {err} is {share} of the "
                             f"largest |ref|, above {limit}")
    return err, share


def decoder_args(g, dev, b, s, dtype):
    """x, Xavier-scaled weights at Llama-3-8B width and the model's RoPE
    tables (theta 500000), in the block's argument order."""
    from paddle_tpu_torch.nn.functional import rotary_freqs
    w = lambda i, o: rand(g, (i, o), dtype, dev, (2.0 / (i + o)) ** 0.5)
    cos, sin = rotary_freqs(DEC_HD, 8192, base=500000.0, device=dev)
    return (rand(g, (b, s, D), dtype, dev), rand(g, (D,), dtype, dev, 0.1) + 1,
            w(D, DQ), w(D, DKV), w(D, DKV), cos, sin, w(DQ, D),
            rand(g, (D,), dtype, dev, 0.1) + 1, w(D, F), w(D, F), w(F, D),
            DEC_H, DEC_HK, EPS)


def decoder_bound(b, s, dtype):
    """(bytes, flops, rate) of one block: x read and y written once, the
    weights once; 2 T (d (dq + 2 dkv) + dq d + 3 d f) product FLOPs plus
    causal attention, 4 b h s^2 hd / 2."""
    item = 2 if dtype == torch.bfloat16 else 4
    w = D * (DQ + 2 * DKV) + DQ * D + 3 * D * F + 2 * D
    nbytes = item * (2 * b * s * D + w) + 2 * 4 * s * DEC_HD // 2
    flops = 2 * b * s * (w - 2 * D) + 4 * b * DEC_H * s * s * DEC_HD // 2
    return nbytes, flops, BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S


def kernel_decoder(FB, dev, timer):
    """The block kernel against decoder_reference: fp32 at b=1, s=512
    (the first design, ``tile``), then bf16 at the train shape (b=4,
    s=2048; the Hopper design, ``wgmma``) over three calls in a row, each
    within the limit and all three equal bit for bit (a workspace read
    by TMA before the writers' stores were visible would show as a
    difference), each timed beside the plain version and the library
    chain in its dtype (F.rms_norm, one QKV matmul, RoPE, SDPA, matmul +
    add, F.rms_norm, the gate/up matmul, silu, the down matmul + add)."""
    from paddle_tpu_torch.ops.kernels import _build
    rows = {}
    for dtype, b, s in ((torch.float32, 1, 512),
                        (torch.bfloat16, DEC_B, DEC_S)):
        g = torch.Generator(device=dev).manual_seed(13)
        args = decoder_args(g, dev, b, s, dtype)
        n0 = FB.fused_decoder_block.launches
        paths = dict(FB.fused_decoder_block.launches_by_path)
        calls = 3 if dtype == torch.bfloat16 else 1
        outs = [FB.fused_decoder_block(*args) for _ in range(calls)]
        path = "wgmma" if dtype == torch.bfloat16 else "tile"
        paths[path] += calls
        if FB.fused_decoder_block.launches != n0 + calls or \
                FB.fused_decoder_block.launches_by_path != paths:
            raise AssertionError(f"kernels_decoder: expected {calls} "
                                 f"launches on the {path} path, "
                                 f"{FB.fused_decoder_block.launches_by_path}")
        ref = FB.decoder_reference(*args)
        errs = [check_share(f"fused_decoder_block {dtype} call {i}", got,
                            ref, DECODER_TOL[dtype])
                for i, got in enumerate(outs)]
        err, share = max(errs)
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise AssertionError(f"kernels_decoder {dtype}: the {calls} "
                                 f"calls differ")
        del outs, ref
        torch.cuda.empty_cache()
        grid = (ctypes.c_int * 3)()
        lib = _build.library("fused_decoder")
        _build.check(lib, lib.ptt_fused_decoder_grid(
            _build.DTYPE_CODES[dtype], ctypes.addressof(grid)),
            "fused_decoder grid")
        nbytes, flops, rate = decoder_bound(b, s, dtype)
        row = {"max_abs_err": err, "err_share_of_max": share,
               "tolerance_share": DECODER_TOL[dtype], "path": path,
               "calls_checked": calls,
               "grid": {"blocks_per_sm": grid[0], "sms": grid[1],
                        "smem_bytes": grid[2]},
               "flops": flops, "shape": f"b={b} s={s} d={D} h={DEC_H} "
               f"hk={DEC_HK} f={F} {str(dtype).split('.')[1]}"}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops, rate)
        row["ms"] = timer(lambda: FB.fused_decoder_block(*args), iters=5)
        row["plain_ms"] = timer(lambda: FB.decoder_reference(*args),
                                iters=2, warmup=1)
        row["library_ms"] = timer(decoder_library(args, b, s), iters=5)
        row["library"] = ("F.rms_norm, QKV matmul, RoPE, SDPA(enable_gqa), "
                          "o-proj matmul + add, F.rms_norm, gate/up "
                          "matmul, silu * up, down matmul + add")
        rows[str(dtype).split(".")[1]] = row
        del args
        torch.cuda.empty_cache()
    return rows


def decoder_library(args, b, s):
    """The block as one chain of PyTorch calls on the block's own
    arguments (cuBLAS matmuls, SDPA), in their dtype: the library row."""
    F_ = torch.nn.functional
    (x, wn1, wq, wk, wv, cos, sin, wo, wn2, wg, wu, wd) = args[:12]
    wqkv = torch.cat([wq, wk, wv], dim=1)
    wgu = torch.cat([wg, wu], dim=1)
    c = cos[:s][None, :, None, :]
    sn = sin[:s][None, :, None, :]

    def rope(t):
        t1, t2 = t.float().chunk(2, dim=-1)
        return torch.cat([t1 * c - t2 * sn, t2 * c + t1 * sn], -1).to(t.dtype)

    def library():
        qkv = F_.rms_norm(x, (D,), wn1, EPS) @ wqkv
        q, k, v = qkv.split([DQ, DKV, DKV], dim=-1)
        q = rope(q.reshape(b, s, DEC_H, DEC_HD)).transpose(1, 2)
        k = rope(k.reshape(b, s, DEC_HK, DEC_HD)).transpose(1, 2)
        v = v.reshape(b, s, DEC_HK, DEC_HD).transpose(1, 2)
        o = F_.scaled_dot_product_attention(q, k, v, is_causal=True,
                                            enable_gqa=True)
        x2 = x + o.transpose(1, 2).reshape(b, s, DQ) @ wo
        gu = F_.rms_norm(x2, (D,), wn2, EPS) @ wgu
        return x2 + (F_.silu(gu[..., :F]) * gu[..., F:]) @ wd

    return library


def kernel_rmsnorm(RN, dev, timer):
    """The rmsnorm kernel against rmsnorm_reference at T=8192, d=4096:
    bf16 with and without a residual, fp32 with one; each timed beside
    the plain version and x + r then F.rms_norm."""
    F_ = torch.nn.functional
    rows = {}
    for dtype, res in ((torch.bfloat16, True), (torch.bfloat16, False),
                       (torch.float32, True)):
        g = torch.Generator(device=dev).manual_seed(17)
        x = rand(g, (NORM_T, D), dtype, dev)
        r = rand(g, (NORM_T, D), dtype, dev) if res else None
        w = rand(g, (D,), dtype, dev, 0.1) + 1
        n0 = RN.fused_rmsnorm.launches
        y, h, inv = RN.fused_rmsnorm(x, w, r, EPS)
        if RN.fused_rmsnorm.launches != n0 + 1:
            raise AssertionError("kernels_decoder: rmsnorm did not launch")
        ry, rh, rinv = RN.rmsnorm_reference(x, w, r, EPS)
        torch.cuda.synchronize()
        if not torch.equal(h, rh):
            raise AssertionError(f"fused_rmsnorm {dtype}: h differs")
        if not res and h.data_ptr() != x.data_ptr():
            raise AssertionError(f"fused_rmsnorm {dtype}: without a "
                                 "residual h is not x")
        check_close("fused_rmsnorm inv", inv, rinv, torch.float32, (0, 1e-5))
        err = check_close(f"fused_rmsnorm y {dtype}", y, ry, dtype,
                          NORM_TOL[dtype])
        item = x.element_size()
        nbytes, ops = rmsnorm_io(NORM_T, D, item, res)
        out = {"max_abs_err": err, "tolerance": dict(zip(
                   ("atol", "rtol"), NORM_TOL[dtype])),
               "ms": timer(lambda: RN.fused_rmsnorm(x, w, r, EPS)),
               "plain_ms": timer(lambda: RN.rmsnorm_reference(x, w, r, EPS)),
               "library_ms": timer(
                   (lambda: F_.rms_norm(x + r, (D,), w, EPS)) if res else
                   (lambda: F_.rms_norm(x, (D,), w, EPS))),
               "library": "x + r, F.rms_norm" if res else "F.rms_norm",
               "h_is_x": not res,
               "shape": f"T={NORM_T} d={D} {str(dtype).split('.')[1]}"
                        + (" residual" if res else "")}
        out["bound_ms"], out["bound_by"] = bound_ms(
            nbytes, ops,
            BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S)
        rows[out["shape"]] = out
        del x, r, y, h, ry, rh
        torch.cuda.empty_cache()
    return rows


def decoder_parity(dev, kernels):
    """One full-width layer (vocab cut to 32000), fp32, b=1, s=256, at the
    decoder tier: the loss and every gradient on the card (the block
    kernel's forward, the remat through the per-segment kernels) against
    the CPU's plain path (decoder_reference and its autograd),
    train_parity's limits."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers, cfg.vocab_size, cfg.dtype = 1, 32000, "float32"
    seed(6)
    t0 = time.perf_counter()
    card = LlamaForCausalLM(cfg, device=dev)
    host = LlamaForCausalLM(cfg, device="cpu")
    host.set_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 257))
    with decoder_tier():
        kernels.reset_launch_counts()
        losses, rel, worst = grad_parity("decoder_parity", card, host, ids)
    launched = {fn.__name__: fn.launches for fn in kernels.DECODER_TRAINING}
    routes = dict(FB.fused_decoder_block.routes)
    if launched != dict.fromkeys(launched, 1) or \
            routes != {"decoder": 2, "segments": 0}:
        raise AssertionError(f"decoder_parity: launches {launched}, routes "
                             f"{routes}")
    emit("decoder_parity", layers=1, vocab=cfg.vocab_size, batch=1, seq=256,
         dtype="float32", loss=losses[0], plain_loss=losses[1],
         loss_rel_err=rel, loss_tolerance=1e-4,
         grad_tolerance="1e-3 of each grad's max |g|",
         worst_grad_rel_err=worst, launches=launched, routes=routes,
         seconds=time.perf_counter() - t0)
    del card, host


def train_decoder(dev, kernels, train_peak):
    """The train phase's step (Llama-3-8B width, 4 layers, bf16, b=4,
    s=2048, AdamW(multi_precision), the guard) at the decoder tier: 1
    warm-up and DEC_STEPS timed steps on a fresh model.  Each step
    launches the block kernel 4 times (the forward) and, in the
    backward's recompute, the rmsnorm, QKV, MLP and flash kernels once a
    layer each.  Then one profiled step."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = TRAIN_LAYERS
    with decoder_tier():
        seed(0)
        t0 = time.perf_counter()
        model = LlamaForCausalLM(cfg, device=dev)
        step = TrainStep(model, AdamW(learning_rate=1e-4,
                                      multi_precision=True),
                         guard_nonfinite=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (DEC_B, DEC_S + 1))
        batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
                 "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
        t0 = time.perf_counter()
        losses = [float(step(batch))]                  # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for _ in range(DEC_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(batch)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches
                    for fn in kernels.DECODER_TRAINING}
        by_path = gemm_paths(kernels)
        routes = dict(FB.fused_decoder_block.routes)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train_decoder: non-finite loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train_decoder: loss did not fall {losses}")
        if any(step.skipped.values()) or step.step_count != 1 + DEC_STEPS:
            raise AssertionError(f"train_decoder: skipped steps "
                                 f"{step.skipped}, step_count "
                                 f"{step.step_count}")
        # per step: the block once a layer in the forward; the recompute
        # runs the QKV training variant, flash forward, rmsnorm (norm2)
        # and the MLP pair once a layer, flash's backward pair once a layer
        want = dict.fromkeys(launches, TRAIN_LAYERS * DEC_STEPS)
        if launches != want or routes != {
                "decoder": TRAIN_LAYERS * DEC_STEPS, "segments": 0}:
            raise AssertionError(f"train_decoder: launches {launches}, "
                                 f"routes {routes}; expected "
                                 f"{TRAIN_LAYERS} a step each")
        launches.update(require_mt("train_decoder", kernels, DEC_STEPS))
        require_paths("train_decoder", by_path,
                      {("fused_decoder_block", "wgmma"):
                       TRAIN_LAYERS * DEC_STEPS,
                       ("fused_decoder_block", "tile"): 0})
        dt = float(np.median(times))
        tokens = DEC_B * DEC_S
        flops_tok = 6 * n_params + 12 * TRAIN_LAYERS * DEC_S * cfg.hidden_size
        ce = ce_device_ms(dev, tokens, cfg.hidden_size, cfg.vocab_size)
        emit("train_decoder", layers=TRAIN_LAYERS, dtype=cfg.dtype,
             batch=DEC_B, seq=DEC_S, params=n_params,
             matmul_precision=matmul_mode(), ce_device=ce,
             ce_share_of_step=ce["ms"] / 1e3 / dt,
             optimizer="AdamW(lr=1e-4, multi_precision=True)",
             model_build_s=build_s, warmup_s=warm_s, step_s=times,
             step_s_median=dt, tokens_per_s=tokens / dt,
             mfu=flops_tok * tokens / dt / BF16_FLOP_PER_S, peak_mem_gb=peak,
             train_phase_peak_mem_gb=train_peak, losses=losses,
             launches=launches, launches_by_path=by_path, routes=routes,
             launches_per_step={k: v / DEC_STEPS
                                for k, v in launches.items()})
        train_profile(step, batch, phase="train_decoder_profile", top_n=15,
                      families=("decoder_hopper", "rmsnorm_kernel",
                                "mlp_gemm_kernel", "qkv_rows_kernel",
                                "qkv_gemm_kernel", "flash_fwd_hopper",
                                "flash_dq_hopper", "flash_dkv_hopper"))
        emit("train_decoder_graph", eager_step_s_median=dt,
             **graph_check("train_decoder", step, batch, kernels))
    del model, step
    return launches


def score_decoder(model, kernels):
    """The serve phase's 32-layer bf16 model scoring b=4 sequences of
    2048 tokens without a cache (`LlamaForCausalLM(input_ids)` under
    inference_mode): at the decoder tier (the block kernel, 32 launches a
    forward) and at the default tier (the per-segment kernels), 1 warm-up
    and DEC_FWDS timed forwards each.  The two tiers' logits differ by
    norm2's cast point (the block multiplies by the weight in fp32 before
    its one cast; the RMSNorm layer casts first) carried through 32
    layers: within 5% of their largest magnitude, the serving parity's
    limit."""
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    cfg = model.config
    dev = model.device
    ids = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (DEC_B, DEC_S))).to(dev)

    def fwd():
        with torch.inference_mode():
            return model(ids)

    def timed():
        fwd()                                           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        times = []
        for _ in range(DEC_FWDS):
            t0 = time.perf_counter()
            out = fwd()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS
                    if fn.launches}
        res = {"fwd_s": times, "fwd_s_median": float(np.median(times)),
               "tokens_per_s": DEC_B * DEC_S / float(np.median(times)),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches": launches,
               "launches_by_path": gemm_paths(kernels),
               "routes": dict(FB.fused_decoder_block.routes)}
        return out, res

    t0 = time.perf_counter()
    with decoder_tier():
        got, dec = timed()
    n = cfg.num_hidden_layers * DEC_FWDS
    if dec["launches"].get("fused_decoder_block") != n or \
            dec["routes"] != {"decoder": n, "segments": 0}:
        raise AssertionError(f"score_decoder: launches {dec['launches']}, "
                             f"routes {dec['routes']}; expected "
                             f"{cfg.num_hidden_layers} blocks a forward")
    # the decoder tier's blocks in bf16: the wgmma / TMA design, every layer
    require_paths("score_decoder (decoder tier)", dec["launches_by_path"],
                  {("fused_decoder_block", "wgmma"): n,
                   ("fused_decoder_block", "tile"): 0})
    ref, seg = timed()
    if seg["launches"].get("fused_decoder_block"):
        raise AssertionError("score_decoder: the default tier launched the "
                             "block kernel")
    # the default tier's QKV and MLP at T = 8192: the wgmma ring, every
    # layer
    require_paths("score_decoder (default tier)", seg["launches_by_path"],
                  {("fused_rmsnorm_qkv", "wgmma"): n,
                   ("fused_mlp", "wgmma"): n, ("fused_mlp", "tile"): 0})
    err = scale = mean = 0.0
    for i in range(DEC_B):                  # one row at a time: 1 GB fp32
        diff = (got[i].float() - ref[i].float()).abs()
        if not torch.isfinite(got[i]).all():
            raise AssertionError("score_decoder: non-finite logits")
        err = max(err, float(diff.max()))
        mean += float(diff.mean()) / DEC_B
        scale = max(scale, float(ref[i].float().abs().max()))
    if err > 0.05 * scale:
        raise AssertionError(f"score_decoder: logits max abs err {err} > "
                             f"0.05 * {scale}")
    emit("score_decoder", layers=cfg.num_hidden_layers, dtype=cfg.dtype,
         batch=DEC_B, seq=DEC_S, logits_shape=list(got.shape),
         decoder=dec, segments=seg, max_abs_err_vs_segments=err,
         mean_abs_err=mean, ref_max_abs=scale, tolerance=0.05 * scale,
         launches_per_forward=dec["launches"]["fused_decoder_block"]
         / DEC_FWDS, seconds=time.perf_counter() - t0)
    del got, ref
    torch.cuda.empty_cache()
    return dec["launches"]["fused_decoder_block"]


def norm_residual(dev, kernels):
    """F.rms_norm_residual forward and backward at T=8192, d=4096 in
    bf16: y, h and inv of the forward against rmsnorm_reference (the
    rows' limits), finite gradients of x, the residual and the weight,
    and one rmsnorm launch a call (the backward is plain products);
    seconds of 5 calls each way after one warm-up."""
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.ops.kernels import rmsnorm as RN
    g = torch.Generator(device=dev).manual_seed(19)
    x, r = (rand(g, (NORM_T, D), torch.bfloat16, dev).requires_grad_(True)
            for _ in range(2))
    w = (rand(g, (D,), torch.bfloat16, dev, 0.1) + 1).requires_grad_(True)
    gy, gh = (rand(g, (NORM_T, D), torch.bfloat16, dev) for _ in range(2))

    def call():
        y, h = TF.rms_norm_residual(x, w, r, EPS)
        torch.autograd.backward((y, h), (gy, gh))
        return y, h

    call()                                             # warm-up
    x.grad = r.grad = w.grad = None
    kernels.reset_launch_counts()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        y, h = call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in kernels.NORM}
    if launches != {"fused_rmsnorm": 5}:
        raise AssertionError(f"norm_residual: launches {launches}")
    with torch.no_grad():
        ry, rh, _ = RN.rmsnorm_reference(x, w, r, EPS)
    if not torch.equal(h, rh):
        raise AssertionError("norm_residual: h differs from the plain sum")
    err = check_close("norm_residual y", y, ry, torch.bfloat16,
                      NORM_TOL[torch.bfloat16])
    for name, t in (("x", x), ("residual", r), ("weight", w)):
        if t.grad is None or not torch.isfinite(t.grad).all():
            raise AssertionError(f"norm_residual: gradient of {name}")
    emit("norm_residual", T=NORM_T, d=D, dtype="bfloat16", calls=5,
         fwd_bwd_s=times, fwd_bwd_s_median=float(np.median(times)),
         max_abs_err=err, launches=launches,
         launches_per_call=launches["fused_rmsnorm"] / 5)
    return launches["fused_rmsnorm"]


# -- the optimizer step: multi-tensor kernels, CUDA graphs, training state ---

# the AdamW arguments of the multi_tensor rows: one update of the Train
# model's parameters at update count 3, lr 1e-4, the clip scale 0.5
MT_ARGS = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, decoupled=True,
               multi_precision=True)
MT_LR, MT_STEP, MT_WD = 1e-4, 3, 0.01
# fp32 operations a parameter: the clip's multiply, the two moments (6),
# both bias corrections (2), sqrt, eps, the quotient, the decay (2), the
# step (2)
MT_OPS = 17


def train_model(dev, layers=TRAIN_LAYERS, seed_=0):
    """The Train cell's model: LlamaConfig.llama3_8b() (bf16) cut to
    `layers` layers, random weights from `seed_`."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = layers
    seed(seed_)
    return cfg, LlamaForCausalLM(cfg, device=dev)


def kernel_multi_tensor(MT, dev, timer):
    """Both multi-tensor kernels on the Train model's parameter set (1.92
    B bf16 parameters with fp32 masters and moments, bf16 gradients),
    each against its plain version on the same inputs: the max error and
    whether every output is bitwise equal (the plain version runs a
    tensor at a time on copies, its results kept on the host, before the
    kernel's one launch updates the originals); then each timed beside
    its plain version, a PyTorch yardstick (the norm: torch._foreach_norm
    in fp32, then the norm of those; the update: torch._fused_adamw_ on
    the fp32 masters with fp32 gradients, whose op order differs: a
    timing only) and its bound (bytes: every gradient read once; grad,
    moments and master read once, param, moments and master written once:
    with a master the kernel never reads the bf16 param, without one it
    does)."""
    cfg, model = train_model(dev)
    params = [p.detach() for p in model.parameters()]
    n = sum(p.numel() for p in params)
    g = torch.Generator(device=dev).manual_seed(13)
    grads = [rand(g, p.shape, torch.bfloat16, dev, 0.01) for p in params]
    kw = dict(lr=torch.tensor(MT_LR, device=dev),
              step=torch.tensor(MT_STEP, dtype=torch.int32, device=dev),
              scale=torch.tensor(0.5, device=dev),
              keep=torch.tensor(True, device=dev), **MT_ARGS)
    masters = [p.float() for p in params]
    m = [rand(g, p.shape, torch.float32, dev, 1e-3) for p in params]
    v = [rand(g, p.shape, torch.float32, dev, 1e-3).square_() for p in params]
    state = (params, m, v, masters)

    def plain_update(ps, gs, ms_, vs, mast):
        for p, gg, mm, vv, ma in zip(ps, gs, ms_, vs, mast):
            MT.adam_reference(p, gg, mm, vv, ma, weight_decay=MT_WD, **kw)

    plain = []
    for i in range(len(params)):
        one = [t[i].clone() for t in state]
        plain_update([one[0]], [grads[i]], [one[1]], [one[2]], [one[3]])
        plain.append([t.cpu() for t in one])
        del one
    n0 = MT.multi_tensor_adam.launches
    MT.multi_tensor_adam(params, grads, m, v, masters,
                         weight_decays=[MT_WD] * len(params), **kw)
    if MT.multi_tensor_adam.launches != n0 + 1:
        raise AssertionError("multi_tensor_adam: not one launch a call")
    names = ("params", "moment1", "moment2", "master")
    err, bitwise = dict.fromkeys(names, 0.0), dict.fromkeys(names, True)
    for i, ref in enumerate(plain):
        for name, t, r in zip(names, (x[i] for x in state), ref):
            got = t.cpu()
            err[name] = max(err[name],
                            float((got.float() - r.float()).abs().max()))
            bitwise[name] = bitwise[name] and torch.equal(got, r)
    del plain
    for name in names:
        if not bitwise[name]:
            raise AssertionError(f"multi_tensor_adam: {name} differs from "
                                 f"its plain version (max abs err "
                                 f"{err[name]})")
    adam_bytes, adam_ops = adam_io(params, grads, masters)
    ms = timer(lambda: MT.multi_tensor_adam(
        params, grads, m, v, masters, weight_decays=[MT_WD] * len(params),
        **kw))
    plain_ms = timer(lambda: plain_update(params, grads, m, v, masters),
                     iters=3, warmup=1)
    grads32 = [gg.float() for gg in grads]
    steps = [torch.tensor(float(MT_STEP), device=dev) for _ in params]
    lib_ms = timer(lambda: torch._fused_adamw_(
        masters, grads32, m, v, [], steps, lr=MT_LR, beta1=0.9, beta2=0.999,
        weight_decay=MT_WD, eps=1e-8, amsgrad=False, maximize=False))
    del grads32, steps
    b, by = bound_ms(adam_bytes, adam_ops, FP32_FLOP_PER_S)
    rows = {"multi_tensor_adam": {
        "shape": f"{len(params)} tensors, {n} params: bf16 with fp32 "
                 "master and moments, bf16 grads",
        "max_abs_err": err["params"], "errors": err, "bitwise": bitwise,
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": "torch._fused_adamw_ (fp32 masters, fp32 grads; other "
                   "op order)", "bound_ms": b, "bound_by": by,
        "tb_per_s": adam_bytes / ms / 1e9}}
    norm = MT.multi_tensor_norm(grads)
    again = MT.multi_tensor_norm(grads)
    ref = MT.norm_reference(grads)
    rel = float((norm - ref).abs() / ref)
    if not rel <= MT_TOL["norm_rel"]:
        raise AssertionError(f"multi_tensor_norm: {float(norm)} against "
                             f"{float(ref)} (rel {rel})")
    norm_bytes, norm_ops = norm_io(grads)
    b, by = bound_ms(norm_bytes, norm_ops, FP32_FLOP_PER_S)
    row = rows["multi_tensor_norm"] = {
        "shape": f"{len(params)} bf16 grads, {n} elements",
        "max_abs_err": float((norm - ref).abs()), "rel_err": rel,
        "bitwise": bool(torch.equal(norm, ref)),
        "two_launches_bitwise": bool(torch.equal(norm, again)),
        "ms": timer(lambda: MT.multi_tensor_norm(grads)),
        "plain_ms": timer(lambda: MT.norm_reference(grads), iters=3,
                          warmup=1),
        "library_ms": timer(lambda: torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=torch.float32)))),
        "library": "torch._foreach_norm (fp32) then the norm of those",
        "bound_ms": b, "bound_by": by}
    row["tb_per_s"] = norm_bytes / row["ms"] / 1e9
    rows["multi_tensor_digest_train"] = kernel_digest(
        MT, timer, params, "the Train model's 1.92 B bf16 parameters")
    del model, params, grads, masters, m, v, state
    torch.cuda.empty_cache()
    return rows


def digest_formula(tensors):
    """The JAX package's params_digest (recovery.py:503-520) in numpy on
    host copies: each leaf's element bits zero-extended and summed mod
    2^32, folded from 2166136261 by acc * 16777619 + sum."""
    acc = 2166136261
    for t in tensors:
        size = t.element_size()
        raw = t.detach().contiguous().view(
            {1: torch.uint8, 2: torch.int16, 4: torch.int32}[size]).cpu()
        bits = raw.numpy().view({1: np.uint8, 2: np.uint16,
                                 4: np.uint32}[size])
        s_ = int(bits.sum(dtype=np.uint64)) & 0xFFFFFFFF
        acc = (acc * 16777619 + s_) & 0xFFFFFFFF
    return acc


def kernel_digest(MT, timer, tensors, what):
    """multi_tensor_digest against its plain version (bitwise: integer
    sums) and the numpy formula, timed beside the plain version and the
    bound (bytes: every leaf read once; one integer add an element at
    the fp32 rate).  No single PyTorch call computes it: library_ms is
    null."""
    got = MT.multi_tensor_digest(tensors)
    again = MT.multi_tensor_digest(tensors)
    ref = MT.digest_reference(tensors)
    formula = digest_formula(tensors)
    digest = int(got[-1]) & 0xFFFFFFFF
    if not (torch.equal(got, ref) and torch.equal(got, again)
            and digest == formula):
        raise AssertionError(f"multi_tensor_digest ({what}): {digest} "
                             f"against plain {int(ref[-1]) & 0xFFFFFFFF} "
                             f"and the formula {formula}")
    nbytes, n = digest_io(tensors)
    b, by = bound_ms(nbytes, n, FP32_FLOP_PER_S)
    row = {"shape": f"{len(tensors)} tensors, {n} elements ({what})",
           "max_abs_err": 0.0, "bitwise": True, "digest": digest,
           "ms": timer(lambda: MT.multi_tensor_digest(tensors)),
           "plain_ms": timer(lambda: MT.digest_reference(tensors), iters=3,
                             warmup=1),
           "library_ms": None, "bound_ms": b, "bound_by": by}
    row["tb_per_s"] = nbytes / row["ms"] / 1e9
    return row


# the multi-tensor update against its plain version is the same fp32
# operations in the same order on the same card: every output must be
# bitwise equal (one update moves a parameter by about lr = 1e-4, under
# one bf16 step of most weights, so no tolerance would see a store that
# went wrong).  The norm: fp32 sums of 1.9e9 squares in another order
MT_TOL = {"norm_rel": 1e-5}

# a graphed step against the eager step from one state runs the same
# kernels in the same order on the same inputs: the losses and every
# parameter, master, moment and the count must be bitwise equal after
# GRAPH_STEPS steps (three AdamW steps move a weight by about 1e-4, under
# one bf16 step of many weights: a graph that applied no update, or read
# a stale lr, count or clip scale, shows in the fp32 state)
GRAPH_STEPS, GRAPH_TIMED = 3, 5


def graph_optimizer():
    """AdamW(LinearWarmup(CosineAnnealingDecay), multi_precision=True,
    grad_clip=ClipGradByGlobalNorm(1.0))."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW, lr
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-4, T_max=100),
                            warmup_steps=3, start_lr=1e-5, end_lr=1e-4)
    return AdamW(learning_rate=sched, multi_precision=True,
                 grad_clip=ClipGradByGlobalNorm(1.0))


def timed_steps(step, batch, n):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def graph_check(what, step, batch, kernels, n=3):
    """The step captured as one CUDA graph (after its eager steps): n
    replays, each loss finite, the counters still, the replays' median
    seconds (each synchronized) and the launches the graph holds."""
    torch.cuda.empty_cache()
    info = step.compile(batch)
    if not info.graph:
        raise AssertionError(f"{what}: compile() captured no graph")
    kernels.reset_launch_counts()
    before = step.replays
    t, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step(batch)))
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    moved = {fn.__name__: fn.launches for fn in kernels.KERNELS
             if fn.launches}
    if moved or step.replays != before + n or not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: replays {step.replays - before}, "
                             f"counters moved {moved}, losses {losses}")
    return {"compile_s": info.seconds, "graph_step_s": t,
            "graph_step_s_median": float(np.median(t)),
            "graph_losses": losses, "graph_launches": info.launches}


def state_tensors(step):
    """Every parameter and optimizer state tensor of `step`, and its
    device count."""
    opt = step.optimizer
    return [t for _, p in step._named
            for t in [p.detach()] + list(opt._accumulators[id(p)].values())
            ] + [step._count]


def same_bits(tensors, host):
    """Whether each tensor's bytes equal its host copy's (one tensor on
    the host at a time)."""
    return all(torch.equal(t.cpu().reshape(-1).view(torch.uint8),
                           h.reshape(-1).view(torch.uint8))
               for t, h in zip(tensors, host))


def graph_phase(phase, model, batch, families, kernels, tokens, flops_tok,
                telemetry=False):
    """The step captured as one CUDA graph against the eager step, from
    one saved state (state_dict -> set_state_dict): GRAPH_STEPS steps of
    each, the losses and every parameter, master, moment and the count
    bitwise equal; then GRAPH_TIMED timed steps of each (median seconds, each
    step synchronized), one profiled step of each (busy share, kernels
    launched); the kernels the graph holds (its capture's launches) and
    the wrappers' counters under replay (they must not move); then one
    replay with a NaN in a weight: the skip counted, every parameter,
    optimizer state tensor and the count bitwise unchanged."""
    from paddle_tpu_torch.jit import TrainStep
    step = TrainStep(model, graph_optimizer(), guard_nonfinite=True)
    t0 = time.perf_counter()
    saved = step.state_dict()
    save_s = time.perf_counter() - t0
    eager_losses = [float(step(batch)) for _ in range(GRAPH_STEPS)]
    eager_state = [t.cpu() for t in state_tensors(step)]
    kernels.reset_launch_counts()
    eager_s = timed_steps(step, batch, GRAPH_TIMED)
    eager_launches = {fn.__name__: fn.launches / GRAPH_TIMED
                      for fn in kernels.KERNELS if fn.launches}
    eager_prof = train_profile(step, batch, f"{phase}_eager_profile",
                               families=families)
    t0 = time.perf_counter()
    step.set_state_dict(saved)
    load_s = time.perf_counter() - t0
    del saved
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    info = step.compile(batch)
    if not info.graph:
        raise AssertionError(f"{phase}: compile() captured no graph")
    if info.launches != {k: round(v) for k, v in eager_launches.items()}:
        raise AssertionError(f"{phase}: the graph holds {info.launches}, "
                             f"an eager step launches {eager_launches}")
    kernels.reset_launch_counts()
    graph_losses = [float(step(batch)) for _ in range(GRAPH_STEPS)]
    moved = {fn.__name__: fn.launches for fn in kernels.KERNELS
             if fn.launches}
    if moved or step.replays != GRAPH_STEPS:
        raise AssertionError(f"{phase}: counters moved under replay "
                             f"{moved}, replays {step.replays}")
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(graph_losses, eager_losses))
    state_err, bitwise = 0.0, True
    for t, ref in zip(state_tensors(step), eager_state):
        ref = ref.to(t.device)
        bitwise = bitwise and torch.equal(t.reshape(-1).view(torch.uint8),
                                          ref.reshape(-1).view(torch.uint8))
        state_err = max(state_err,
                        float((t.float() - ref.float()).abs().max()))
    del eager_state, ref
    if not bitwise or graph_losses != eager_losses:
        raise AssertionError(f"{phase}: graphed against eager: losses "
                             f"{graph_losses} and {eager_losses}, the state "
                             f"bitwise {bitwise} (max abs err {state_err})")
    graph_s = timed_steps(step, batch, GRAPH_TIMED)
    graph_prof = train_profile(step, batch, f"{phase}_graph_profile",
                               families=families)
    if telemetry:
        train_telemetry(step, batch, info, tokens, flops_tok,
                        float(np.median(graph_s)))
        profiler_trace(step, batch)
    # a NaN in the second weight (a norm weight or the position table:
    # every row reads it) inside the graph
    skips = dict(step.skipped)
    poisoned = step._named[1][1]
    with torch.no_grad():
        keep = poisoned.view(-1)[0].clone()
        poisoned.view(-1)[0] = float("nan")
    before = [t.cpu() for t in state_tensors(step)]
    nan_loss = float(step(batch))
    unchanged = same_bits(state_tensors(step), before)
    del before
    with torch.no_grad():
        poisoned.view(-1)[0] = keep
    if np.isfinite(nan_loss) or not unchanged or \
            step.skipped["nonfinite_loss"] != skips["nonfinite_loss"] + 1:
        raise AssertionError(f"{phase}: the NaN step: loss {nan_loss}, "
                             f"state unchanged {unchanged}, skips "
                             f"{step.skipped}")
    e, gph = float(np.median(eager_s)), float(np.median(graph_s))
    emit(phase, tokens=tokens, optimizer="AdamW(LinearWarmup(Cosine"
         "AnnealingDecay), multi_precision=True, grad_clip="
         "ClipGradByGlobalNorm(1.0))", state_dict_s=save_s,
         set_state_dict_s=load_s, compile_s=info.seconds,
         eager_losses=eager_losses, graph_losses=graph_losses,
         loss_rel_err=loss_rel, state_max_abs_err=state_err,
         state_bitwise=bitwise, losses_bitwise=graph_losses == eager_losses,
         eager_step_s=eager_s, graph_step_s=graph_s,
         eager_step_s_median=e, graph_step_s_median=gph,
         speedup=e / gph, graph_tokens_per_s=tokens / gph,
         graph_mfu=flops_tok * tokens / gph / BF16_FLOP_PER_S,
         eager_busy_share=eager_prof["device_busy_share"],
         graph_busy_share=graph_prof["device_busy_share"],
         eager_kernels_per_step=eager_prof["kernel_launches"],
         graph_kernels_per_step=graph_prof["kernel_launches"],
         graph_launches=info.launches, eager_launches_per_step=eager_launches,
         replays=step.replays, nan_step_skipped=True,
         nan_step_state_unchanged=unchanged, skipped=step.skipped)
    return info.launches


def train_graph(dev, kernels):
    """graph_phase at the Train cell: Llama-3-8B width, 4 layers, bf16,
    b=4, s=2048."""
    cfg, model = train_model(dev)
    n_params = sum(p.numel() for p in model.parameters())
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    flops_tok = 6 * n_params + 12 * TRAIN_LAYERS * TRAIN_S * cfg.hidden_size
    return graph_phase("train_graph", model, batch, TRAIN_FAMILIES, kernels,
                       TRAIN_B * TRAIN_S, flops_tok, telemetry=True)


# -- the measurement slice: TrainStep's telemetry, the device profiler, the
# measured tier, the profiler's trace, the demo ------------------------------

class _Null:
    """An instrument that records nothing: the telemetry-off control."""

    def labels(self, **kw):
        return self

    def inc(self, *a):
        pass

    def set(self, *a):
        pass

    def observe(self, *a):
        pass


def sync_warnings(step, batch, n=2):
    """The warnings torch.cuda.set_sync_debug_mode("warn") gives over n
    graphed steps, one a synchronizing call (its one-time notice that
    the mode is a prototype left out)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                step(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return [str(w.message) for w in caught
            if "called a synchronizing" in str(w.message)]


def train_telemetry(step, batch, info, tokens, flops_tok, graph_s):
    """train_graph's TrainStep telemetry on the card: the MFU gauge after
    compile() beside the phase's analytic MFU (bench.py's FLOPs a token:
    6 N + 12 L s d), the watermark of a fresh monitor against
    torch.cuda.max_memory_allocated over the same steps, the steps and
    tokens counters exact, and the sync-debug warnings of graphed steps
    with telemetry equal to those with the watermark and the metrics off
    (the guard's read of the skip code is the one sync either way)."""
    from paddle_tpu_torch.observability import default_registry
    from paddle_tpu_torch.observability.device_profiler import \
        DeviceMemoryMonitor
    from paddle_tpu_torch.observability.metrics import MetricsRegistry
    reg = default_registry()
    names = ("paddle_tpu_train_steps_total", "paddle_tpu_train_tokens_total")
    c0 = {n: reg.get(n).value() for n in names}
    step._memmon = DeviceMemoryMonitor(registry=MetricsRegistry(),
                                       device=step._device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 3
    for _ in range(n):
        step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    moved = {n_: reg.get(n_).value() - c0[n_] for n_ in names}
    if moved != {names[0]: n, names[1]: n * tokens}:
        raise AssertionError(f"train_telemetry: counters moved {moved} over "
                             f"{n} steps of {tokens} tokens")
    watermark = step._memmon.watermark
    if not 0 < watermark <= peak:
        raise AssertionError(f"train_telemetry: watermark {watermark} "
                             f"against max_memory_allocated {peak}")
    gauge = reg.get("paddle_tpu_train_mfu").value()
    step_s = reg.get("paddle_tpu_train_step_ema_seconds").value()
    analytic = flops_tok * tokens / graph_s / BF16_FLOP_PER_S
    if not 0 < gauge < 1:
        raise AssertionError(f"train_telemetry: MFU gauge {gauge}")
    with_tel = sync_warnings(step, batch)
    keep = step._metrics, step._memmon
    step._metrics = {k: _Null() for k in keep[0]}
    step._memmon = None
    try:
        without = sync_warnings(step, batch)
    finally:
        step._metrics, step._memmon = keep
    if len(with_tel) != len(without):
        raise AssertionError(f"train_telemetry: {len(with_tel)} sync "
                             f"warnings with telemetry, {len(without)} "
                             f"without: {with_tel} / {without}")
    emit("train_telemetry", card=torch.cuda.get_device_name(0),
         power_limit=nvidia_smi(), steps=n, counters_moved=moved,
         mfu_gauge=gauge, analytic_mfu=analytic, ratio=gauge / analytic,
         counted_flops_per_step=step._step_flops,
         analytic_flops_per_step=flops_tok * tokens,
         flops_ratio=step._step_flops / (flops_tok * tokens),
         step_ema_s=step_s, graph_step_s_median=graph_s,
         ratio_note="gauge / analytic = (counted / analytic FLOPs) x "
                    "(median graphed step s / the gauge's step s): the "
                    "count charges causal attention at half the dense "
                    "products (the analytic 12 L s d is dense) and adds the "
                    "norms, RoPE, CE, clip and update",
         watermark_bytes=watermark, max_memory_allocated=peak,
         sync_warnings_with_telemetry=len(with_tel),
         sync_warnings_without=len(without),
         sync_warning_first=with_tel[:1],
         compile_record={"target": info.target, "lower_s": info.lower_s,
                         "compile_s": info.compile_s,
                         "flops": info.stats.flops,
                         "bytes": info.stats.bytes_accessed,
                         "peak_bytes": info.stats.peak_bytes})


def profiler_trace(step, batch):
    """paddle_tpu_torch.profiler.Profiler over two graphed steps, each
    inside a RecordEvent: the exported chrome trace holds the card's
    kernel events and both ranges, and load_profiler_result reads it."""
    import tempfile
    from paddle_tpu_torch import profiler
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        prof = profiler.Profiler(log_dir=os.path.join(tmp, "log"))
        with prof:
            for i in range(2):
                with profiler.RecordEvent(f"graphed_step_{i}"):
                    step(batch)
                prof.step()
        path = os.path.join(tmp, "trace.json")
        prof.export(path)
        events = profiler.load_profiler_result(path)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    ranges = {e["name"] for e in events
              if str(e.get("name", "")).startswith("graphed_step_")}
    if not kern or ranges != {"graphed_step_0", "graphed_step_1"}:
        raise AssertionError(f"profiler_trace: {len(kern)} kernel events, "
                             f"ranges {sorted(ranges)}")
    emit("profiler_trace", events=len(events), kernel_events=len(kern),
         ranges=sorted(ranges), kernel_us=sum(e.get("dur", 0) for e in kern),
         seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def calibration_into(path):
    """PADDLE_TPU_CALIBRATION=1 with the ledger in `path` inside the
    block (the process-wide ledger reloaded on entry and exit)."""
    from paddle_tpu_torch.observability import calibration
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    old = {k: os.environ.get(k) for k in ("PADDLE_TPU_CALIBRATION",
                                          "PADDLE_TPU_CALIBRATION_DIR")}
    os.environ.update(PADDLE_TPU_CALIBRATION="1",
                      PADDLE_TPU_CALIBRATION_DIR=str(path))
    calibration.reset()
    FB.clear_measured_tiers()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        calibration.reset()
        FB.clear_measured_tiers()


# segments the profiler must time at their roofline: a compute-bound
# segment below this gap beats the card's peak, which nothing does
COMPUTE_GAP_MIN = 0.95
PROFILE_REPS = 5
PROFILE_KERNELS = ("fused_rmsnorm_qkv", "fused_mlp", "flash_attention_fwd",
                   "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                   "fused_decoder_block")


def device_profile(dev, kernels, ledger):
    """DeviceProfiler over llama_step_segments of the Train cell's model
    (Llama-3-8B width, 4 layers, bf16, b=4, s=2048): each segment
    captured as a CUDA graph, PROFILE_REPS replays timed with CUDA
    events (the minimum), against the cost model's roofline;
    decoder_block_fused at the decoder tier (one block launch), the rest
    at the default tier, every row fed to the ledger in `ledger`.  Fails
    on a skipped segment, on a compute-bound gap below COMPUTE_GAP_MIN,
    or where a kernel of PROFILE_KERNELS never launched; a memory-bound
    gap below 1 is reported with the operator the unfused count charged
    the most bytes."""
    from paddle_tpu_torch.observability import device_profiler as DP
    t0 = time.perf_counter()
    cfg, model = train_model(dev)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size,
                                            (TRAIN_B, TRAIN_S + 1))
    segs = DP.llama_step_segments(model, {"input_ids": ids[:, :-1],
                                          "labels": ids[:, 1:]})
    kernels.reset_launch_counts()
    reports, tables = {}, []
    with calibration_into(ledger):
        for seg in segs:
            tier = decoder_tier() if seg.name == "decoder_block_fused" \
                else contextlib.nullcontext()
            with tier:
                res = DP.DeviceProfiler(device=dev).add(seg).profile(
                    reps=PROFILE_REPS)
            if res.skipped:
                raise AssertionError(f"device_profile: skipped {res.skipped}")
            reports[seg.name] = res.segments[0]
            tables.append(res.table().splitlines()[2])
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS
                if fn.launches}
    missing = [k for k in PROFILE_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"device_profile: never launched {missing} "
                             f"({launches})")
    rows, low = {}, {}
    for name, r in reports.items():
        rows[name] = {"device_ms": r.device_s * 1e3,
                      "roofline_ms": r.predicted_s * 1e3, "gap": r.gap,
                      "bound": r.bound, "count": r.count, "group": r.group,
                      "gflops": r.flops / 1e9, "gbytes": r.bytes_accessed / 1e9,
                      "heaviest": r.heaviest,
                      "capture_pool_gb": r.peak_bytes / 2 ** 30}
        if r.bound == "compute" and r.gap < COMPUTE_GAP_MIN:
            raise AssertionError(f"device_profile: {name} at gap {r.gap} "
                                 "beats the card's peak")
        if r.bound == "memory" and r.gap < 1.0:
            low[name] = {"gap": r.gap, "over_charged_by": r.heaviest}
    del model, segs
    torch.cuda.empty_cache()
    emit("device_profile", card=torch.cuda.get_device_name(0),
         power_limit=nvidia_smi(), shape=f"b={TRAIN_B} s={TRAIN_S} "
         f"d={cfg.hidden_size} bf16, {TRAIN_LAYERS} layers", reps=PROFILE_REPS,
         segments=rows, memory_bound_below_1=low, launches=launches,
         table=tables, seconds=time.perf_counter() - t0)
    return reports


def measured_tier(model, kernels, ledger, reports):
    """PADDLE_TPU_FUSED_BLOCK=measured over the ledger device_profile
    filled: measured_tier_for((4, 2048, 4096), bf16) names the tier of
    the lower recorded time (decoder_block at segments against
    decoder_block_fused at decoder), and the Score-decoder forward (the
    32-layer serve model, b=4, s=2048) launches the block kernel once a
    layer if and only if that tier is decoder."""
    from paddle_tpu_torch.observability import calibration
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    t0 = time.perf_counter()
    shape = (DEC_B, DEC_S, model.config.hidden_size)
    with calibration_into(ledger):
        cm = calibration.CalibratedCostModel()
        t_seg = cm.measured_for("decoder_block", shape, "bfloat16",
                                layout="tier=segments")
        t_dec = cm.measured_for("decoder_block_fused", shape, "bfloat16",
                                layout="tier=decoder")
        tier = FB.measured_tier_for(shape, torch.bfloat16)
        want = "decoder" if t_dec < t_seg else "segments"
        if t_seg != reports["decoder_block"].device_s or \
                t_dec != reports["decoder_block_fused"].device_s or \
                tier != want:
            raise AssertionError(f"measured_tier: ledger {t_seg} / {t_dec}, "
                                 f"profiled {reports['decoder_block']} / "
                                 f"{reports['decoder_block_fused']}, tier "
                                 f"{tier}")
        ids = torch.as_tensor(np.random.default_rng(7).integers(
            0, model.config.vocab_size, (DEC_B, DEC_S))).to(model.device)
        old = os.environ.get("PADDLE_TPU_FUSED_BLOCK")
        os.environ["PADDLE_TPU_FUSED_BLOCK"] = "measured"
        try:
            kernels.reset_launch_counts()
            with torch.inference_mode():
                out = model(ids)
            torch.cuda.synchronize()
        finally:
            if old is None:
                os.environ.pop("PADDLE_TPU_FUSED_BLOCK")
            else:
                os.environ["PADDLE_TPU_FUSED_BLOCK"] = old
        detail = calibration.bench_detail()
    L = model.config.num_hidden_layers
    blocks = FB.fused_decoder_block.launches
    routes = dict(FB.fused_decoder_block.routes)
    if blocks != (L if tier == "decoder" else 0) or routes[tier] != L or \
            not torch.isfinite(out).all():
        raise AssertionError(f"measured_tier: tier {tier}, {blocks} block "
                             f"launches, routes {routes}")
    del out
    torch.cuda.empty_cache()
    emit("measured_tier", card=torch.cuda.get_device_name(0),
         power_limit=nvidia_smi(), shape=list(shape), dtype="bfloat16",
         decoder_block_segments_ms=t_seg * 1e3,
         decoder_block_fused_decoder_ms=t_dec * 1e3, tier=tier,
         block_launches=blocks, routes=routes, layers=L,
         calibration=detail, seconds=time.perf_counter() - t0)
    return tier


def demo_phase():
    """python -m paddle_tpu_torch.observability.demo --device cuda
    --fleet --forensics, in a process of its own: exit code 0."""
    import tempfile
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.observability.demo",
             "--device", "cuda", "--fleet", "--forensics",
             "--trace-out", os.path.join(tmp, "trace.json"),
             "--fleet-trace-out", os.path.join(tmp, "fleet.json")],
            capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    tail = [ln for ln in r.stderr.splitlines() if ln.startswith("[demo]")]
    if r.returncode != 0:
        raise AssertionError(f"demo: exit {r.returncode}\n"
                             + r.stderr[-4000:])
    emit("demo", rc=r.returncode, lines=tail,
         metrics_lines=len(r.stdout.splitlines()),
         seconds=time.perf_counter() - t0)


def train_gpt_graph(dev, kernels):
    """graph_phase at Train-GPT: GPT-2 medium, 24 layers, bf16, b=8,
    s=1024 (the host-bound cell)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(dtype="bfloat16", hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    seed(0)
    model = GPTForCausalLM(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (GPT_B, GPT_S + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    L = cfg.num_hidden_layers
    flops_tok = 6 * n_params + 12 * L * GPT_S * cfg.hidden_size
    return graph_phase("train_gpt_graph", model, batch,
                       ("ce_fwd_kernel", "ce_bwd_kernel", "flash_fwd_hopper",
                        "flash_dq_hopper", "flash_dkv_hopper"), kernels,
                       GPT_B * GPT_S, flops_tok)


# train_state: the Train model cut to one layer (the vocabulary's 1.05 B
# embedding and head parameters stay), b=4, s=2048.  Accumulation and
# remat against the plain step: the slices' and the whole batch's loss are
# fp32 means of the same bf16 logits in another grouping, and remat
# recomputes the same kernels: loss 1e-3 relative, each gradient 1e-2 of
# its largest (one bf16 rounding of sums in another order)
STATE_LAYERS = 1
STATE_TOL = {"loss_rel": 1e-3, "grad_of_max": 1e-2}


def train_state(dev):
    """At STATE_LAYERS layers: accum_steps=2 against 1 on the same batch
    (loss, peak memory), remat_policy "dots" (and "nothing") against no
    remat (loss, every gradient, peak memory), with lr 0 so the weights
    stay where they were; then 3 steps, state_dict(), a fresh step of
    other weights loaded with it, 2 more steps: bitwise equal to 5
    uninterrupted steps."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    cfg, model = train_model(dev, STATE_LAYERS)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    opt = AdamW(learning_rate=0.0, multi_precision=True)
    params = [p for p in model.parameters()]
    out = {}

    def run(what, **kw):
        step = TrainStep(model, opt, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = step._loss(batch)
        grads = step._grads(loss, params)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        float(step(batch))          # and one whole step through __call__
        out[what] = {"loss": float(loss.detach()), "peak_mem_gb": peak}
        return float(loss.detach()), grads

    base_loss, base_grads = run("plain")
    step = TrainStep(model, opt, accum_steps=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acc_loss = float(step(batch))
    out["accum_steps=2"] = {"loss": acc_loss, "peak_mem_gb":
                            torch.cuda.max_memory_allocated() / 2 ** 30}
    out["accum_steps=2"]["loss_rel_err"] = \
        abs(acc_loss - base_loss) / abs(base_loss)
    for policy in ("dots", "nothing"):
        loss, grads = run(f"remat {policy}", remat=True, remat_policy=policy)
        worst = max(float((a.float() - b.float()).abs().max() /
                          b.float().abs().max().clamp_min(1e-30))
                    for a, b in zip(grads, base_grads))
        out[f"remat {policy}"].update(
            loss_rel_err=abs(loss - base_loss) / abs(base_loss),
            grad_err_of_max=worst)
        del grads
    del base_grads
    bad = {k: v for k, v in out.items()
           if v.get("loss_rel_err", 0) > STATE_TOL["loss_rel"]
           or v.get("grad_err_of_max", 0) > STATE_TOL["grad_of_max"]}
    if bad:
        raise AssertionError(f"train_state: outside {STATE_TOL}: {bad}")
    del model, opt, params, step
    torch.cuda.empty_cache()

    batches = []
    for i in range(5):
        ids = np.random.default_rng(10 + i).integers(
            0, cfg.vocab_size, (TRAIN_B, TRAIN_S + 1))
        batches.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})

    def fresh(seed_):
        _, m = train_model(dev, STATE_LAYERS, seed_)
        return m, TrainStep(m, graph_optimizer())

    m, step = fresh(0)
    ref = [float(step(b)) for b in batches]
    ref_params = [p.detach().cpu() for _, p in step._named]
    del m, step
    torch.cuda.empty_cache()
    m, step = fresh(0)
    got = [float(step(b)) for b in batches[:3]]
    t0 = time.perf_counter()
    saved = step.state_dict()
    save_s = time.perf_counter() - t0
    del m, step
    torch.cuda.empty_cache()
    m, step = fresh(1)
    t0 = time.perf_counter()
    step.set_state_dict(saved)
    load_s = time.perf_counter() - t0
    del saved
    got += [float(step(b)) for b in batches[3:]]
    same = got == ref and all(
        torch.equal(p.detach().cpu(), r)
        for (_, p), r in zip(step._named, ref_params))
    if not same:
        raise AssertionError(f"train_state: restored run {got} against "
                             f"uninterrupted {ref}, parameters equal "
                             f"{same}")
    emit("train_state", layers=STATE_LAYERS, batch=TRAIN_B, seq=TRAIN_S,
         runs=out, tol=STATE_TOL, restore_losses=got,
         uninterrupted_losses=ref, restore_bitwise=same,
         state_dict_s=save_s, set_state_dict_s=load_s)
    del m, step, ref_params
    torch.cuda.empty_cache()


# the recovery drill: JAX's bench.py --recovery-drill at GPT-2 medium's
# full size; a snapshot, a checkpoint and an SDC check every DRILL_EVERY
# steps, the rank killed at DRILL_KILL
DRILL_STEPS, DRILL_KILL, DRILL_EVERY = 8, 7, 3


def _counter_sum(name, **labels):
    from paddle_tpu_torch.observability import default_registry
    m = default_registry().get(name)
    if m is None:
        return 0.0
    return sum(child.value() for values, child in m.series()
               if all(dict(zip(m.labelnames, values)).get(k) == v
                      for k, v in labels.items()))


def _gauge(name):
    from paddle_tpu_torch.observability import default_registry
    return next(c.value() for _, c in default_registry().get(name).series())


def _hist_sum(name):
    """(sum, count) of a histogram's observations."""
    from paddle_tpu_torch.observability import default_registry
    m = default_registry().get(name)
    if m is None:
        return 0.0, 0
    kids = [c for _, c in m.series()]
    return sum(c._sum for c in kids), sum(c._count for c in kids)


def recovery_drill(dev, kernels):
    """The MTTR drill on the card (module docstring, 14).  Returns the
    launches of the drill's path and the digest's kernel row."""
    from paddle_tpu_torch import robustness as rob
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.distributed import checkpoint as CK
    from paddle_tpu_torch.distributed.elastic import free_port
    from paddle_tpu_torch.distributed.tcp_store import TCPStore
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.robustness import recovery as rec
    cfg = GPTConfig(dtype="bfloat16", hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)

    def batch_for(i):
        ids = np.random.default_rng(1000 + i).integers(
            0, cfg.vocab_size, (GPT_B, GPT_S + 1))
        return {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
                "labels": torch.as_tensor(ids[:, 1:]).to(dev)}

    def build(**kw):
        seed(0)
        model = GPTForCausalLM(cfg, device=dev)
        return TrainStep(model, AdamW(learning_rate=1e-4,
                                      multi_precision=True), **kw)

    def bits(loss):
        return loss.detach().float().cpu().numpy().tobytes()

    tmp = tempfile.mkdtemp(prefix="ptt_drill_")
    store = TCPStore("127.0.0.1", free_port(), is_master=True, world_size=2,
                     timeout=120.0)
    t_phase = time.perf_counter()
    try:
        snap = rec.PeerSnapshotter(store, rank=0, world_size=2,
                                   interval_steps=DRILL_EVERY)
        mirror = rec.PeerSnapshotter(store, rank=1, world_size=2,
                                     interval_steps=DRILL_EVERY)
        ckpt = CK.AutoCheckpoint(tmp, keep=3,
                                 save_interval_steps=DRILL_EVERY)
        sentinel = rec.SDCSentinel(store, rank=0, dp_peers=[0],
                                   host="drill-h0",
                                   interval_steps=DRILL_EVERY, timeout=5.0)
        save0 = _hist_sum("paddle_tpu_checkpoint_save_seconds")
        rob.inject("recovery.rank_kill", nth=DRILL_KILL, times=1)
        kernels.reset_launch_counts()
        victim = build(sdc_sentinel=sentinel)
        n_params = sum(p.numel() for p in victim.params.values())
        victim.compile(batch_for(1))
        ref, killed_at, ship, state_s = {}, None, [], []
        verdicts, pending = [], None
        for i in range(1, DRILL_STEPS + 1):
            ref[i] = bits(victim(batch_for(i)))
            if victim.last_sdc_verdict is not None:
                verdicts.append(victim.last_sdc_verdict["ok"])
                victim.last_sdc_verdict = None
            if killed_at is None and i % DRILL_EVERY == 0:
                t0 = time.perf_counter()
                sd = victim.state_dict()
                state_s.append(time.perf_counter() - t0)
                snap0 = _hist_sum("paddle_tpu_recovery_snapshot_seconds")
                if not snap.maybe_snapshot(i, sd):
                    raise AssertionError(f"recovery_drill: step {i}'s "
                                         "snapshot was not shipped")
                snap1 = _hist_sum("paddle_tpu_recovery_snapshot_seconds")
                t0 = time.perf_counter()
                if mirror.fetch_buddy() != i:
                    raise AssertionError("recovery_drill: rank 1 did not "
                                         f"mirror step {i}")
                ship.append({"step": i, "bytes": _gauge(
                    "paddle_tpu_recovery_snapshot_bytes"),
                             "snapshot_s": snap1[0] - snap0[0],
                             "mirror_s": time.perf_counter() - t0})
                pending = ckpt.maybe_save(
                    i, rec.flatten_for_checkpoint(sd)) or pending
                del sd
            if killed_at is None and rob.fault_fires("recovery.rank_kill",
                                                     step=i):
                killed_at = i
        if killed_at != DRILL_KILL:
            raise AssertionError(f"recovery_drill: the kill fired at "
                                 f"{killed_at}, not {DRILL_KILL}")
        t0 = time.perf_counter()
        pending.wait(timeout=600)
        ckpt_wait_s = time.perf_counter() - t0
        save1 = _hist_sum("paddle_tpu_checkpoint_save_seconds")
        write_s = (save1[0] - save0[0]) / max(1, save1[1] - save0[1])
        del victim
        torch.cuda.empty_cache()

        # the replacement rank: built and captured before the restores
        template = build()
        t0 = time.perf_counter()
        info = template.compile(batch_for(DRILL_KILL))
        capture_s = time.perf_counter() - t0
        paths = {}
        for path in ("peer", "disk"):
            if path == "disk":
                rob.inject("recovery.peer_fetch", times=1)
            t0 = time.perf_counter()
            step, state, got = rec.resume_train_state(
                store, rank=0, auto_ckpt=ckpt, device=dev)
            restore_s = time.perf_counter() - t0
            if got != path or step != DRILL_EVERY * (DRILL_KILL //
                                                     DRILL_EVERY):
                raise AssertionError(f"recovery_drill: {path} restore "
                                     f"came from {got} at step {step}")
            template.set_state_dict(state)
            torch.cuda.synchronize(dev)
            mttr = time.perf_counter() - t0
            del state
            t0 = time.perf_counter()
            resumed = {}
            for i in range(step + 1, DRILL_STEPS + 1):
                resumed[i] = bits(template(batch_for(i)))
                if i == step + 1:
                    first_step_s = time.perf_counter() - t0
            equal = all(resumed[i] == ref[i] for i in resumed)
            if not equal:
                raise AssertionError(
                    f"recovery_drill: {path} resume's losses differ from the "
                    "uninterrupted run's: " + str(
                        {i: (np.frombuffer(resumed[i], np.float32)[0],
                             np.frombuffer(ref[i], np.float32)[0])
                         for i in resumed}))
            paths[path] = {"step": step, "restore_s": restore_s,
                           "mttr_s": mttr, "first_resumed_step_s":
                           first_step_s, "losses_bitwise": equal,
                           "replays": template.replays}
        step_dir = ckpt._step_dir(paths["disk"]["step"])
        ckpt_bytes = sum(os.path.getsize(os.path.join(step_dir, f))
                         for f in os.listdir(step_dir))
        t0 = time.perf_counter()
        CK.load_state_dict(step_dir, device=dev)
        torch.cuda.synchronize(dev)
        read_s = time.perf_counter() - t0

        # SDC: three sentinels, one silently corrupt; then two and a
        # replay to break the tie
        params = template.params
        # (with a host leaf beside the card's parameters, as an `extra`
        # is: still one launch each on the card)
        trio = [rec.SDCSentinel(store, rank=r, dp_peers=[0, 1, 2],
                                host=f"drill-h{r}", timeout=5.0)
                for r in range(3)]
        n0 = MT.multi_tensor_digest.launches
        trio[0].publish(100, params, extra=100)
        rob.inject("train.sdc_flip", times=1)
        trio[1].publish(100, params, extra=100)
        rob.clear_faults("train.sdc_flip")
        trio[2].publish(100, params, extra=100)
        trio_launches = MT.multi_tensor_digest.launches - n0
        v3 = trio[0].verify(100)
        duo = [rec.SDCSentinel(store, rank=r, dp_peers=[0, 1],
                               host=f"drill-d{r}", prefix="sdc2",
                               timeout=5.0) for r in range(2)]
        duo[0].publish(101, params)
        rob.inject("train.sdc_flip", times=1)
        duo[1].publish(101, params)
        rob.clear_faults("train.sdc_flip")
        tie = duo[0].verify(101)
        v2 = duo[0].verify(101, replay=lambda: rec.deterministic_replay(
            None, lambda _: params))
        sdc = {"detected": not v3["ok"], "blamed": v3["blamed"],
               "quarantined": v3["quarantined"],
               "roster": sorted(rec.quarantined_hosts(store)),
               "tie_unattributed": tie["blamed"] == [],
               "replay_blamed": v2["blamed"], "replayed": v2["replayed"],
               "hook_checks": len(verdicts), "hook_ok": all(verdicts),
               "trio_launches": trio_launches}
        if not (sdc["detected"] and v3["blamed"] == [1]
                and trio_launches == 3
                and v3["quarantined"] == ["drill-h1"]
                and rec.is_quarantined(store, "drill-h1")
                and sdc["tie_unattributed"] and v2["blamed"] == [1]
                and sdc["hook_checks"] == DRILL_STEPS // DRILL_EVERY
                and sdc["hook_ok"]):
            raise AssertionError(f"recovery_drill: SDC {sdc}")
        launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
        for name in ("multi_tensor_digest", "multi_tensor_norm",
                     "multi_tensor_adam", "cross_entropy_fwd",
                     "cross_entropy_bwd", "flash_attention_fwd",
                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            if launches[name] <= 0:
                raise AssertionError(f"recovery_drill: {name} never "
                                     "launched")
        rob.clear_faults()

        # the digest kernel at the drill's shape (these launches do not
        # count: the counts were read above)
        timer = Timer(dev)
        leaves = rec.digest_leaves(params)
        row = kernel_digest(MT, timer, leaves,
                            "GPT-2 medium's bf16 parameters")
        row["params_digest_equals_formula"] = \
            rec.params_digest(params) == digest_formula(leaves)
        del timer
        snap_bytes = ship[-1]["bytes"]
        emit("recovery_drill", model="gpt2_medium", params=n_params,
             batch=[GPT_B, GPT_S], steps=DRILL_STEPS, killed_at=killed_at,
             every=DRILL_EVERY, snapshots=ship,
             snapshot_gb=snap_bytes / 1e9,
             ship_gb_per_s=snap_bytes / ship[-1]["snapshot_s"] / 1e9,
             state_dict_s=state_s, checkpoint_bytes=ckpt_bytes,
             checkpoint_write_s=write_s,
             checkpoint_write_gb_per_s=ckpt_bytes / write_s / 1e9,
             checkpoint_wait_s=ckpt_wait_s,
             checkpoint_read_s=read_s,
             checkpoint_read_gb_per_s=ckpt_bytes / read_s / 1e9,
             checkpoint_read_cache="warm (this process wrote the files)",
             template_capture_s=capture_s, template_cached=info.cached,
             peer=paths["peer"], disk=paths["disk"], sdc=sdc,
             digest=row, launches=launches,
             phase_s=time.perf_counter() - t_phase)
        del template, params, leaves
        torch.cuda.empty_cache()
        return launches, row
    finally:
        rob.clear_faults()
        store.close()
        shutil.rmtree(tmp, ignore_errors=True)


# cold start: Llama-3-8B width cut to COLD_LAYERS, Serve's engine, the
# first four Serve prompts, 32 greedy tokens
COLD_LAYERS = 4
COLD_PROMPTS = SERVE_LENGTHS[:4]
COLD_TIMEOUT = 600
# the kernels each cold-start process must launch: the engine's (QKV and
# the MLP at decode and prefill, paged decode), the training step's (flash,
# the optimizer's two) and the weights' digest
COLD_KERNELS = ("fused_rmsnorm_qkv", "fused_mlp", "paged_decode_attention",
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv", "multi_tensor_norm",
                "multi_tensor_adam", "multi_tensor_digest")


def _cache_counts():
    return {r: _counter_sum("paddle_tpu_compile_cache_total", result=r)
            for r in ("hit", "miss", "store", "deserialize_error")}


def _cold_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n) for n in COLD_PROMPTS]


def _serve_cold(eng, prompts):
    """Serve `prompts` (32 greedy tokens each); ``(tokens, seconds of the
    first engine step, which samples the first token)``."""
    rids = [eng.add_request(p, max_new_tokens=32) for p in prompts]
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    out = eng.run()
    toks = []
    for rid in rids:
        if eng.request_status(rid) != "ok" or len(out[rid][1]) != 32:
            raise AssertionError(f"cold_start: request {rid} "
                                 f"{eng.request_status(rid)}")
        toks.append([int(t) for t in out[rid][1]])
    return toks, first


def cold_child(role, bundle_dir, out_path, dev=None):
    """One cold-start process (A or B) on `dev` (the card); writes its
    results to `out_path` as JSON."""
    spawn = float(os.environ["PTT_COLD_SPAWN"])
    res = {"role": role, "import_s": time.time() - spawn}
    from paddle_tpu_torch import compile_cache as CC
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.analysis.passes import cost_model
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.robustness.recovery import params_digest
    counted = []
    orig = cost_model.count_cost

    def counting(*a, **kw):        # the counted warm-ups (cost model runs)
        counted.append(1)
        return orig(*a, **kw)
    cost_model.count_cost = counting
    dev = dev or torch.device("cuda", 0)
    res["package"] = os.path.dirname(kernels.__file__)
    t_load = time.perf_counter()
    got = None
    if role == "B":              # the bundle first: it holds the libraries
        got = CC.load_bundle(bundle_dir, device=dev)
        res["installed"] = sorted(got["installed"])
        res["bundle_skipped"] = got["skipped"]
        res["bundle_kernels"] = len(got["kernels"])
    t0 = time.perf_counter()
    res["nvcc_s"] = _build.build_all()
    res["build_s"] = time.perf_counter() - t0
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = COLD_LAYERS
    seed(0)
    model = LlamaForCausalLM(cfg, device=dev)
    if got is not None:
        model.set_state_dict(got["state_dict"])
        del got
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t_load - res["build_s"]
    kernels.reset_launch_counts()
    eng = ContinuousBatchingEngine(model, **SERVE_ENGINE)
    t0 = time.perf_counter()
    warm = eng.aot_warmup()
    torch.cuda.synchronize()
    res["capture_s"] = time.perf_counter() - t0
    res["warm_cached"] = {k: v["cached"] for k, v in warm.items()}
    prompts = _cold_prompts(cfg.vocab_size)
    res["tokens"], res["first_step_s"] = _serve_cold(eng, prompts)
    res["to_first_token_s"] = time.time() - spawn   # ~ the first step's end
    eng.close()
    del eng
    only = {}
    if role == "B":
        # a third, empty cache: cache_only captures nothing and the
        # engine serves eagerly (before the training step moves the
        # weights); its lookups are kept out of B's counts
        before = _cache_counts()
        own = os.environ["PADDLE_TPU_COMPILE_CACHE_DIR"]
        os.environ["PADDLE_TPU_COMPILE_CACHE_DIR"] = os.environ[
            "PTT_COLD_EMPTY_CACHE"]
        CC.reset_memory()
        eng = ContinuousBatchingEngine(model, **SERVE_ENGINE)
        warm = eng.aot_warmup(cache_only=True)
        res["cache_only"] = {k: {"eager": v.get("eager", False),
                                 "graph": v["graph"]}
                             for k, v in warm.items()}
        res["cache_only_tokens"], _ = _serve_cold(eng, prompts)
        eng.close()
        del eng
        only = {k: v - before[k] for k, v in _cache_counts().items()}
        os.environ["PADDLE_TPU_COMPILE_CACHE_DIR"] = own
        CC.reset_memory()
    res["weights_digest"] = params_digest(
        {n: p.detach() for n, p in model.named_parameters()})
    step = TrainStep(model, AdamW(learning_rate=1e-4, multi_precision=True))
    ids = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                            (TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    # torch's own one-off: the first call of a torch.library custom op
    # (the training kernels' ptt:: ops; serving's hits call none) imports
    # torch._dynamo (torch/_compile.py), which A's counted serving
    # warm-up has paid already; timed apart, so that the train compile
    # compares a hit with a miss
    t0 = time.perf_counter()
    importlib.import_module("torch._dynamo")
    res["dynamo_import_s"] = time.perf_counter() - t0
    res["train_compile_s"], info, res["train_parts"] = timed_compile(
        step, batch, CC)
    res["train_cached"] = info.cached
    if role == "A":
        t0 = time.perf_counter()
        man = CC.bundle(bundle_dir, state_dict=model.state_dict(),
                        device=dev)
        res["bundle_s"] = time.perf_counter() - t0
        res["bundle_entries"] = len(man["executables"])
        res["bundle_kernels"] = len(man["kernels"])
    res["loss"] = step(batch).detach().float().cpu().numpy().tobytes().hex()
    torch.cuda.synchronize()
    res["launches"] = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    res["nvcc_runs"] = _build.nvcc_runs()
    res["counted_warmups"] = len(counted)
    res["compile_total"] = _counter_sum("paddle_tpu_compile_total")
    res["cache"] = {k: v - only.get(k, 0)
                    for k, v in _cache_counts().items()}
    res["cache_only_counts"] = only
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(out_path, "w") as f:
        json.dump(res, f)


def timed_compile(step, batch, CC):
    """``step.compile(batch)``: its wall seconds, its CompileInfo, and
    its parts: the cache lookup, the warm-ups (A: the counted one and
    one more; B, a hit: two uncounted), each body run outside the
    capture (synchronized), and the capture."""
    parts = {"lookup_s": 0.0, "bodies_s": []}
    lookup, capture, body = CC.lookup, step._capture, step._body

    def timed_lookup(*a, **kw):
        t = time.perf_counter()
        try:
            return lookup(*a, **kw)
        finally:
            parts["lookup_s"] += time.perf_counter() - t

    def timed_capture(*a, **kw):
        out = capture(*a, **kw)
        parts["warmup_s"], parts["capture_s"] = out[2]
        return out

    def timed_body(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            return body(*a, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = body(*a, **kw)
        torch.cuda.synchronize()
        parts["bodies_s"].append(time.perf_counter() - t)
        return out

    CC.lookup, step._capture, step._body = \
        timed_lookup, timed_capture, timed_body
    try:
        t0 = time.perf_counter()
        info = step.compile(batch)
        return time.perf_counter() - t0, info, parts
    finally:
        CC.lookup = lookup
        del step._capture, step._body


def _run_cold(role, script, cwd, bundle_dir, tmp, env_extra):
    out_path = os.path.join(tmp, f"{role}.json")
    env = dict(os.environ, PTT_COLD_SPAWN=repr(time.time()),
               PADDLE_TPU_COMPILE_CACHE="1", **env_extra)
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, script, "--cold-start-child", role,
                        bundle_dir, out_path], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=COLD_TIMEOUT)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"cold_start: process {role} exited "
                             f"{p.returncode}:\n{p.stderr[-4000:]}")
    with open(out_path) as f:
        res = json.load(f)
    res["process_wall_s"] = wall
    return res


def cold_start():
    """The cold start from a bundle (module docstring, 15): runs the two
    processes, checks the gates, emits the phase; returns both
    processes' launches."""
    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="ptt_cold_")
    try:
        bundle_dir = os.path.join(tmp, "bundle")
        a = _run_cold("A", os.path.join(repo, "chip_smoke.py"), repo,
                      bundle_dir, tmp, {"PADDLE_TPU_COMPILE_CACHE_DIR":
                                        os.path.join(tmp, "cache_a")})
        root = os.path.join(tmp, "copy")
        shutil.copytree(os.path.join(repo, "paddle_tpu_torch"),
                        os.path.join(root, "paddle_tpu_torch"),
                        ignore=shutil.ignore_patterns("build",
                                                      "__pycache__"))
        shutil.copy(os.path.join(repo, "chip_smoke.py"), root)
        b = _run_cold("B", os.path.join(root, "chip_smoke.py"), root,
                      bundle_dir, tmp, {
                          "PADDLE_TPU_COMPILE_CACHE_DIR":
                              os.path.join(tmp, "cache_b"),
                          "PTT_COLD_EMPTY_CACHE":
                              os.path.join(tmp, "cache_c")})
        gates = {
            "b_from_the_copy": b["package"].startswith(root),
            "b_nvcc_runs": b["nvcc_runs"] == 0,
            "b_counted_warmups": b["counted_warmups"] == 0,
            "b_compile_total": b["compile_total"] == 0,
            "b_misses": b["cache"]["miss"] == 0
            and b["cache"]["deserialize_error"] == 0,
            "b_hits_equal_a_stores": b["cache"]["hit"] == a["cache"]["store"]
            and a["cache"]["store"] > 0,
            "b_all_cached": all(b["warm_cached"].values())
            and b["train_cached"],
            # the hit skips the counted warm-up: never much slower than
            # A's miss (a hit path gone wrong would be)
            "b_train_hit_not_slower": b["train_compile_s"]
            <= 2 * a["train_compile_s"],
            "weights": a["weights_digest"] == b["weights_digest"],
            "tokens": a["tokens"] == b["tokens"],
            "loss": a["loss"] == b["loss"],
            "cache_only_eager": all(v["eager"] and not v["graph"]
                                    for v in b["cache_only"].values()),
            "cache_only_tokens": b["cache_only_tokens"] == a["tokens"],
        }
        for role, r in (("A", a), ("B", b)):
            for name in COLD_KERNELS:
                gates[f"{role}_{name}_launched"] = r["launches"][name] > 0
        for r in (a, b):
            r.pop("cache_only_tokens", None)
            r["first_tokens"] = [t[:4] for t in r.pop("tokens")]
        emit("cold_start", model="llama3_8b", layers=COLD_LAYERS,
             prompts=COLD_PROMPTS, engine=SERVE_ENGINE,
             train_batch=[TRAIN_B, TRAIN_S],
             train_compile_s={"A": a["train_compile_s"],
                              "B": b["train_compile_s"]},
             dynamo_import_s={"A": a["dynamo_import_s"],
                              "B": b["dynamo_import_s"]},
             train_parts={"A": a["train_parts"], "B": b["train_parts"]},
             A=a, B=b, gates=gates)
        bad = [k for k, ok in gates.items() if not ok]
        if bad:
            raise AssertionError(f"cold_start: gates failed {bad}")
        return {"A": a["launches"], "B": b["launches"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)



# -- phase 16: the op surface on the card ------------------------------------

# the eager timings before the op hook existed, on this card (PERF.md
# section 5): Transformer-base's bf16 forward and Train-GPT's eager
# step; the hook's fast path should not move them
HOOK_REF = {"transformer_ms": 13.5, "train_gpt_s": 0.1236}


def _surface_rand(shape, lo=-1.0, hi=1.0):
    """The JAX package's OpTest inputs (``paddle_tpu/testing:_rand``): a
    generator seeded by the shape and dtype."""
    import zlib
    seed = zlib.crc32(repr((tuple(shape), str(np.float32))).encode())
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def surface_dsl(seed=0):
    """The schema's input DSL (``kind: expr`` entries' ``inputs``)."""
    rng = np.random.default_rng(seed)

    def rand_(*shape, lo=-1.0, hi=1.0, dtype=np.float32):
        return rng.uniform(lo, hi, shape).astype(dtype)

    def randint(lo, hi, shape, dtype=np.int64):
        return rng.integers(lo, hi, shape).astype(dtype)

    def mask(*shape, p=0.5):
        return rng.uniform(0, 1, shape) < p

    def perm(n):
        return rng.permutation(n).astype(np.int64)

    def sorted_(*shape, lo=-1.0, hi=1.0):
        return np.sort(rng.uniform(lo, hi, shape).astype(np.float32), -1)

    def posdef(n):
        a = rng.standard_normal((n, n)).astype(np.float32)
        return a @ a.T + n * np.eye(n, dtype=np.float32)

    return {"np": np, "rand": rand_, "randint": randint, "mask": mask,
            "perm": perm, "sorted": sorted_, "posdef": posdef}


# inputs (the DSL) and attrs of the schema entries whose test is "skip"
# or that carry no oracle, so every generated op runs
SCHEMA_EXTRA = {
    "gcd": ({"x": "randint(1, 20, (3, 4))", "y": "randint(1, 20, (3, 4))"},
            {}),
    "lcm": ({"x": "randint(1, 20, (3, 4))", "y": "randint(1, 20, (3, 4))"},
            {}),
    "ldexp": ({"x": "rand(3, 4)", "y": "randint(-3, 3, (3, 4))"}, {}),
    "inner": ({"x": "rand(3, 4)", "y": "rand(2, 4)"}, {}),
    "outer": ({"x": "rand(3)", "y": "rand(4)"}, {}),
    "kron": ({"x": "rand(2, 2)", "y": "rand(2, 3)"}, {}),
    "lerp": ({"x": "rand(3, 4)", "y": "rand(3, 4)", "weight": "rand(3, 4)"},
             {}),
    "all": ({"x": "mask(3, 4)"}, {"axis": 1}),
    "any": ({"x": "mask(3, 4)"}, {"axis": 1}),
    "addmm": ({"input": "rand(3, 5)", "x": "rand(3, 4)",
               "y": "rand(4, 5)"}, {"beta": 0.5, "alpha": 2.0}),
    "bitwise_and": ({"x": "randint(0, 16, (3, 4))",
                     "y": "randint(0, 16, (3, 4))"}, {}),
    "bitwise_or": ({"x": "randint(0, 16, (3, 4))",
                    "y": "randint(0, 16, (3, 4))"}, {}),
    "bitwise_xor": ({"x": "randint(0, 16, (3, 4))",
                     "y": "randint(0, 16, (3, 4))"}, {}),
    "bitwise_not": ({"x": "randint(0, 16, (3, 4))"}, {}),
    "bitwise_left_shift": ({"x": "randint(0, 16, (3, 4))",
                            "y": "randint(0, 3, (3, 4))"}, {}),
    "bitwise_right_shift": ({"x": "randint(0, 16, (3, 4))",
                             "y": "randint(0, 3, (3, 4))"}, {}),
    "take": ({"x": "rand(3, 4)", "index": "randint(-12, 12, (5,))"}, {}),
    "vander": ({"x": "rand(4)"}, {"n": 3}),
    "cdist": ({"x": "rand(3, 4)", "y": "rand(5, 4)"}, {}),
    "diag_embed": ({"x": "rand(2, 3)"}, {"offset": 1}),
    "fill_diagonal": ({"x": "rand(4, 3)"}, {"value": 2.0}),
    "concat": ({"x": "[rand(2, 3), rand(4, 3)]"}, {}),
    "stack": ({"x": "[rand(2, 3), rand(2, 3)]"}, {"axis": 1}),
    "hstack": ({"x": "[rand(2, 3), rand(2, 1)]"}, {}),
    "vstack": ({"x": "[rand(2, 3), rand(1, 3)]"}, {}),
    "dstack": ({"x": "[rand(2, 3), rand(2, 3)]"}, {}),
    "column_stack": ({"x": "[rand(3), rand(3)]"}, {}),
    "row_stack": ({"x": "[rand(3), rand(3)]"}, {}),
    "bincount": ({"x": "randint(0, 5, (10,))"}, {}),
    "qr": ({"x": "rand(4, 3)"}, {}),
    "svd": ({"x": "rand(4, 3)"}, {}),
    "eigh": ({"x": "posdef(4)"}, {}),
    "multi_dot": ({"tensors": "[rand(3, 4), rand(4, 5), rand(5, 2)]"}, {}),
    "householder_product": ({"x": "rand(4, 3)", "tau": "rand(3)"}, {}),
    "slice": ({"x": "rand(4, 5)"}, {"axes": [0, 1], "starts": [1, 0],
                                    "ends": [3, -1]}),
}
# decompositions: vectors are defined up to sign or phase, so a case
# holds the products (and the values)
RECON = {"qr", "svd", "eigh", "eig", "eigvals"}
# ops whose outputs are copies or positions of inputs: equal exactly
EXACT = {"sort", "argsort", "topk", "kthvalue", "mode", "argmax",
         "argmin", "cummax", "cummin", "searchsorted", "bucketize",
         "unique", "unique_consecutive", "median-min", "nonzero",
         "masked_select", "where-nonzero", "gather", "gather_nd",
         "index_select", "take_along_axis", "masked_argmax"}


def schema_case(name, spec):
    """(inputs, attrs, rtol, atol) of a schema entry's first case: its
    test's inputs where it has them (SCHEMA_EXTRA's for the others)."""
    kind = spec.get("kind", "skip")
    if name in SCHEMA_EXTRA:
        ns = surface_dsl()
        src, attrs = SCHEMA_EXTRA[name]
        return ({n: eval(e, dict(ns)) for n, e in src.items()},  # noqa: S307
                dict(attrs), spec.get("rtol"), spec.get("atol"))
    lo, hi = spec.get("lo", -1.0), spec.get("hi", 1.0)
    if kind == "expr":
        ns = surface_dsl()
        inputs = {n: eval(e, dict(ns))  # noqa: S307 — in-repo schema
                  for n, e in (spec.get("inputs") or {}).items()}
    elif kind == "binary":
        inputs = {"x": _surface_rand((3, 4), lo, hi),
                  "y": _surface_rand((3, 4), lo, hi)}
    else:
        inputs = {a: _surface_rand((3, 4), lo, hi) for a in spec["args"]}
    return inputs, dict(spec.get("attrs") or {}), spec.get("rtol"), \
        spec.get("atol")


class AsTensor:
    """A case input that the JAX package must get as its Tensor."""

    def __init__(self, v):
        self.v = v


def surface_cases():
    """The hand-written ops' cases: (module, op, args, kwargs, id, rtol,
    atol), one at least per public function of creation, manipulation,
    linalg, search, stat, array_ops, logic's predicates and math's
    hand-written ops, from a seeded numpy generator.  Sorts run on
    inputs with ties; median on an even count; shapes as lists and as
    tensors; ``name=`` given once.  tests/test_torch_ops_surface.py holds
    these cases against the JAX package."""
    rng = np.random.default_rng(19)

    def R(*shape, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def I(lo, hi, *shape):
        return rng.integers(lo, hi, shape).astype(np.int64)

    def B(*shape):
        return rng.uniform(0, 1, shape) < 0.5

    def PD(n):
        a = rng.standard_normal((n, n)).astype(np.float32)
        return (a @ a.T + n * np.eye(n)).astype(np.float32)

    def T(*shape):
        return I(0, 3, *shape).astype(np.float32)

    out = []

    def C(mod_, op_, *args, id=None, rtol=1e-5, atol=1e-6, **kwargs):
        out.append((mod_, op_, args, kwargs, id or op_, rtol, atol))

    pd4, pd3, sq = PD(4), PD(3), R(3, 3)
    mask_rows = B(3, 4)
    mask_rows[:, 0] = True
    nan = R(3, 6)
    nan[0, 1] = nan[2, 4] = np.nan
    C("creation", "to_tensor", R(3, 4))
    C("creation", "zeros", [2, 3])
    C("creation", "ones", np.array([2, 3]), id="ones-shape-tensor")
    C("creation", "full", [2, 3], 7)
    C("creation", "zeros_like", R(2, 3))
    C("creation", "ones_like", R(2, 3), dtype="int32")
    C("creation", "full_like", R(2, 3), 0.25)
    C("creation", "empty", [2, 2], dtype="float32")
    C("creation", "empty_like", R(2, 3))
    C("creation", "arange", 1, 10, 3)
    C("creation", "linspace", 0.0, 1.0, 5)
    C("creation", "logspace", 0.0, 2.0, 4)
    C("creation", "eye", 3, 4)
    C("creation", "diag", R(4), 1, 2.0)
    C("creation", "diagflat", R(2, 2))
    C("creation", "tril", R(4, 4), -1)
    C("creation", "triu", R(4, 4), 1)
    C("creation", "meshgrid", R(2), R(3))
    C("creation", "assign", R(3, 4))
    C("creation", "clone", R(3, 4))
    C("creation", "tril_indices", 4, 5, 1)
    C("creation", "triu_indices", 4, None, -1)
    C("creation", "complex", R(3), R(3))
    C("creation", "polar", R(3, lo=0.1), R(3))
    C("manipulation", "reshape", R(3, 4), [2, -1], name="r")
    C("manipulation", "reshape", R(3, 4), np.array([6, 2]),
      id="reshape-shape-tensor")
    C("manipulation", "cast", R(3, 4, lo=-4, hi=4), "int32")
    C("manipulation", "flatten", R(2, 3, 4), 1)
    C("manipulation", "transpose", R(2, 3, 4), [2, 0, 1])
    C("manipulation", "moveaxis", R(2, 3, 4), 0, 2)
    C("manipulation", "swapaxes", R(2, 3, 4), 0, 2)
    C("manipulation", "t", R(2, 3, 4))
    C("manipulation", "squeeze", R(3, 1, 4, 1), [1, 3])
    C("manipulation", "unsqueeze", R(3, 4), [0, -1])
    C("manipulation", "concat", [R(2, 3), R(4, 3)], 0)
    C("manipulation", "stack", [R(2, 3), R(2, 3)], 1)
    C("manipulation", "unstack", R(3, 4), 1)
    C("manipulation", "split", R(6, 4), [2, -1], 0)
    C("manipulation", "chunk", R(5, 4), 2)
    C("manipulation", "tile", R(2, 3), [2, 1])
    C("manipulation", "expand", R(1, 3), [4, -1])
    C("manipulation", "expand_as", R(1, 3), R(4, 3))
    C("manipulation", "broadcast_to", R(3, 1), [3, 4])
    C("manipulation", "broadcast_tensors", [R(3, 1), R(1, 4)])
    C("manipulation", "flip", R(3, 4), [0, 1])
    C("manipulation", "rot90", R(3, 4), 3)
    C("manipulation", "roll", R(3, 4), [1, 2], [0, 1])
    C("manipulation", "slice", R(4, 5), [0, 1], [1, 0], [3, -1])
    C("manipulation", "strided_slice", R(8, 4), [0], [7], [0], [-2])
    C("manipulation", "gather", R(5, 4), I(0, 5, 3))
    C("manipulation", "gather_nd", R(4, 5), I(0, 4, 3, 1))
    C("manipulation", "take_along_axis", R(3, 5), I(0, 5, 3, 2), 1)
    C("manipulation", "put_along_axis", R(3, 5),
      np.array([[0, 3], [1, 4], [2, 0]]), R(3, 2), 1)
    C("manipulation", "scatter", R(5, 3), np.array([0, 2, 2]), R(3, 3),
      overwrite=False)
    C("manipulation", "scatter_nd_add", R(4, 5), I(0, 4, 3, 1), R(3, 5))
    C("manipulation", "scatter_nd", I(0, 4, 3, 1), R(3, 5), [4, 5])
    C("manipulation", "index_select", R(5, 4), I(0, 4, 3), 1)
    C("manipulation", "index_sample", R(3, 5), I(0, 5, 3, 2))
    C("manipulation", "index_add", R(5, 3), np.array([0, 2, 2]), 0, R(3, 3))
    C("manipulation", "index_put", R(4, 5),
      (np.array([0, 2]), np.array([1, 3])), R(2))
    C("manipulation", "repeat_interleave", R(3, 4), 2, 1)
    C("manipulation", "unbind", R(3, 4), 1)
    C("manipulation", "as_complex", R(3, 2))
    C("manipulation", "as_real",
      (R(3, 4) + 1j * R(3, 4)).astype(np.complex64))
    C("manipulation", "masked_select", R(3, 4), B(3, 4))
    C("manipulation", "masked_fill", R(3, 4), B(3, 4), 0.5)
    C("manipulation", "where", B(3, 4), R(3, 4), R(3, 4))
    C("manipulation", "where", B(3, 4), id="where-nonzero")
    C("manipulation", "pad", R(2, 3, 4), [1, 2], mode="reflect")
    C("manipulation", "pad", R(2, 3), [1, 0, 2, 1], mode="constant",
      value=0.5, id="pad-constant")
    C("manipulation", "crop", R(4, 5), [2, 3], [1, 1])
    C("manipulation", "unique", I(0, 5, 10), True, True, True)
    C("manipulation", "unique_consecutive", np.array([1, 1, 2, 2, 3, 1, 1]),
      True, True)
    C("manipulation", "rot90_", R(3, 4), 1)
    C("manipulation", "view", R(3, 4), [4, 3])
    C("manipulation", "numel", R(3, 4))
    C("manipulation", "shard_index", I(0, 10, 6), 10, 2, 0)
    C("manipulation", "atleast_1d", np.float32(2.0))
    C("manipulation", "atleast_2d", R(3))
    C("manipulation", "atleast_3d", R(3, 4))
    C("manipulation", "column_stack", [R(3), R(3)])
    C("manipulation", "row_stack", [R(3), R(3)])
    C("manipulation", "hstack", [R(2, 3), R(2, 1)])
    C("manipulation", "vstack", [R(2, 3), R(1, 3)])
    C("manipulation", "dstack", [R(2, 3), R(2, 3)])
    C("manipulation", "hsplit", R(4, 6), 3)
    C("manipulation", "vsplit", R(6, 4), 3)
    C("manipulation", "dsplit", R(2, 3, 4), 2)
    C("manipulation", "tensor_split", R(5, 4), 2)
    C("manipulation", "block_diag", [R(2, 2), R(3, 1)])
    C("manipulation", "select_scatter", R(3, 4), R(3), 1, 2)
    C("manipulation", "slice_scatter", R(6, 4), R(3, 4), [0], [0], [6], [2])
    C("manipulation", "rank", R(3, 4))
    C("manipulation", "masked_scatter", R(3, 4), B(3, 4), R(12))
    C("manipulation", "view_as", R(3, 4), R(2, 6))
    C("linalg", "matmul", R(2, 3, 4), R(2, 5, 4), transpose_y=True)
    C("linalg", "mm", R(3, 4), R(4, 5))
    C("linalg", "bmm", R(2, 3, 4), R(2, 4, 5))
    C("linalg", "dot", R(3, 4), R(3, 4))
    C("linalg", "mv", R(3, 4), R(4))
    C("linalg", "dist", R(3, 4), R(3, 4), 3.0)
    C("linalg", "norm", R(3, 4), 2.0, 1)
    C("linalg", "norm", R(3, 4), id="norm-fro")
    C("linalg", "cross", R(2, 3), R(2, 3))
    C("linalg", "cholesky", pd4, True, rtol=1e-4, atol=1e-5)
    C("linalg", "cholesky_solve", R(4, 2),
      np.linalg.cholesky(pd4).astype(np.float32), rtol=1e-4, atol=1e-5)
    C("linalg", "triangular_solve", np.triu(pd4), R(4, 2), transpose=True,
      rtol=1e-4, atol=1e-5)
    C("linalg", "solve", pd4, R(4, 2), rtol=1e-4, atol=1e-5)
    C("linalg", "lstsq", R(5, 3), R(5, 2), rtol=1e-4, atol=1e-5)
    C("linalg", "inverse", pd4, rtol=1e-4, atol=1e-5)
    C("linalg", "pinv", R(4, 3), rtol=1e-4, atol=1e-5)
    C("linalg", "det", pd3, rtol=1e-4, atol=1e-4)
    C("linalg", "slogdet", pd3, rtol=1e-4, atol=1e-5)
    C("linalg", "matrix_rank", R(4, 3))
    C("linalg", "matrix_power", pd3, 3, rtol=1e-4, atol=1e-3)
    C("linalg", "qr", R(4, 3))
    C("linalg", "svd", R(4, 3))
    C("linalg", "eig", sq)
    C("linalg", "eigh", pd4)
    C("linalg", "eigvals", sq)
    C("linalg", "eigvalsh", pd4, rtol=1e-5, atol=1e-5)
    C("linalg", "lu", R(4, 4))
    C("linalg", "multi_dot", [R(3, 4), R(4, 5), R(5, 2)])
    C("linalg", "histogram", R(20), 5)
    C("linalg", "bincount", I(0, 5, 10))
    C("linalg", "corrcoef", R(3, 8))
    C("linalg", "cov", R(3, 8))
    C("linalg", "einsum", "ij,jk->ik", R(3, 4), R(4, 5))
    C("linalg", "tensordot", R(3, 4, 5), R(4, 5, 2), 2)
    C("linalg", "vecdot", R(3, 4), R(3, 4))
    C("linalg", "cartesian_prod", R(2), R(3))
    C("linalg", "combinations", R(4), 2)
    C("linalg", "pdist", R(4, 3))
    C("linalg", "matrix_exp", R(3, 3, lo=-0.5, hi=0.5))
    C("search", "argmax", R(3, 4), 1)
    C("search", "argmin", R(3, 4))
    C("search", "argsort", T(3, 6), -1, True)
    C("search", "argsort", T(3, 6), -1, True, False, id="argsort-unstable")
    C("search", "sort", T(3, 6), -1, True)
    C("search", "topk", T(3, 6), 3)
    C("search", "topk", T(3, 6), 2, 0, False, id="topk-smallest")
    C("search", "kthvalue", T(3, 6), 2)
    C("search", "mode", T(3, 6))
    C("search", "nonzero", B(3, 4))
    C("search", "masked_argmax", R(3, 4), mask_rows, 1)
    C("search", "searchsorted", np.sort(R(3, 8), -1), R(3, 5))
    C("search", "bucketize", R(3, 4), np.sort(R(6)))
    C("search", "index_fill", R(4, 3), np.array([0, 2]), 0, 0.5)
    C("stat", "var", R(3, 4), 1, False)
    C("stat", "std", R(3, 4))
    C("stat", "median", R(3, 6), 1)
    C("stat", "median", T(3, 6), 1, mode="min", id="median-min")
    C("stat", "nanmedian", nan, 1)
    C("stat", "quantile", R(3, 5), [0.25, 0.5], 1)
    C("stat", "nanquantile", nan, 0.5, 1)
    C("stat", "histogramdd", R(20, 2), 3)
    C("math", "mod", R(3, 4, lo=-3, hi=3), R(3, 4, lo=0.5, hi=2))
    C("math", "floor_mod", R(3, 4, lo=-3, hi=3), R(3, 4, lo=0.5, hi=2))
    C("math", "rsqrt_", R(3, 4, lo=0.5, hi=2))
    C("math", "multiplex", [R(3, 4), R(3, 4)], np.array([[0], [1], [0]]))
    C("math", "renorm", R(3, 4), 2.0, 0, 1.0)
    C("math", "cumulative_trapezoid", R(3, 5), axis=1)
    C("math", "histogram_bin_edges", R(20), 4)
    C("logic", "is_tensor", AsTensor(R(3)))
    C("logic", "is_floating_point", AsTensor(R(3)))
    C("logic", "is_integer", AsTensor(I(0, 3, 3)))
    C("logic", "is_complex", AsTensor(R(3)))
    C("array_ops", "create_array", "float32", [R(2), R(2)])
    C("array_ops", "array_write", R(2), 0, [R(2)])
    C("array_ops", "array_read", [R(2), R(3)], 1)
    C("array_ops", "array_length", [R(2), R(3)])
    return out


def to_device(v, dev):
    """A case's numpy inputs as tensors on `dev` (lists and tuples kept)."""
    if isinstance(v, AsTensor):
        v = v.v
    if isinstance(v, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(v)).to(dev)
    if isinstance(v, (list, tuple)):
        return type(v)(to_device(a, dev) for a in v)
    return v


def leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in leaves(o)]
    return [out]


def _np_out(t):
    t = t.detach().cpu().resolve_conj()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def recon_check(op, x, ref, got):
    """Decompositions against a reference run (numpy leaves `ref`): the
    values and the products they must reproduce, up to sign or phase."""
    got = [_np_out(g) for g in leaves(got)]

    def close(a, b, what, tol=1e-4):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)

    def csort(v):
        v = np.asarray(v)
        return v[np.lexsort((v.imag, v.real))]

    if op == "qr":
        close(got[0] @ got[1], x, "q @ r")
        close(np.abs(got[1]), np.abs(ref[1]), "|r|")
    elif op == "svd":
        close(got[1], ref[1], "s", 1e-5)
        close((got[0] * got[1]) @ got[2], x, "u s vh")
    elif op == "eigh":
        close(got[0], ref[0], "w", 1e-5)
        close(got[1] @ np.diag(got[0]) @ got[1].T, x, "v w v^T")
    elif op == "eig":
        close(csort(got[0]), csort(ref[0]), "w")
        close(x.astype(np.complex64) @ got[1], got[1] * got[0], "A v = v w")
    elif op == "eigvals":
        close(csort(got[0]), csort(ref[0]), "w")


def compare_out(what, ref, got, rtol, atol, exact=False):
    """Raise unless `got` equals the reference run `ref` leaf for leaf:
    dtype and shape, integers and bools exactly, floats within (rtol,
    atol) or exactly with `exact`."""
    rl, gl = leaves(ref), leaves(got)
    if len(rl) != len(gl):
        raise AssertionError(f"{what}: {len(gl)} outputs, {len(rl)} wanted")
    for i, (r, g) in enumerate(zip(rl, gl)):
        if not isinstance(g, torch.Tensor):
            if g != r:
                raise AssertionError(f"{what} out{i}: {g} != {r}")
            continue
        if g.dtype != r.dtype or tuple(g.shape) != tuple(r.shape):
            raise AssertionError(f"{what} out{i}: {g.dtype} "
                                 f"{tuple(g.shape)} against {r.dtype} "
                                 f"{tuple(r.shape)}")
        gn, rn = _np_out(g), _np_out(r)
        if exact or gn.dtype == bool or np.issubdtype(gn.dtype, np.integer):
            np.testing.assert_array_equal(gn, rn, err_msg=what)
        else:
            np.testing.assert_allclose(gn, rn, rtol=rtol, atol=atol,
                                       err_msg=what)


RANDOM_CASES = (("rand", ([64, 32],), {}), ("randn", ([64, 32],), {}),
                ("standard_normal", ([64],), {}),
                ("normal", (), {"mean": 1.0, "std": 2.0, "shape": [64]}),
                ("uniform", ([64],), {"min": -2.0, "max": 3.0}),
                ("randint", (0, 10, [64]), {}),
                ("randint_like", ("x", 0, 5), {}), ("randperm", (64,), {}),
                ("shuffle", ("x",), {}), ("bernoulli", ("p",), {}),
                ("poisson", ("lam",), {}),
                ("multinomial", ("probs", 2), {}),
                ("rand_like", ("x",), {}), ("randn_like", ("x",), {}),
                ("exponential_", ("x",), {"lam": 2.0}))


def op_surface(dev):
    """Every op of the surface on CUDA tensors against the port's CPU run
    on the same inputs: the 304 generated ops (their schema tests' first
    case, SCHEMA_EXTRA's for the rest) within their entry's tolerance
    (fp32's 1e-5 / 1e-6 where it states none), the hand-written ops'
    surface_cases() within theirs, sort-like ops and gathers exactly,
    decompositions through their products; the random ops' shapes and
    dtypes against the CPU's and their draws repeated under seed on the
    card.  Counts by module; any failure by name fails the phase."""
    import paddle_tpu_torch as tp
    from paddle_tpu_torch.ops import (array_ops, creation, generated_math,
                                      linalg, logic, manipulation, search,
                                      stat)
    from paddle_tpu_torch.ops import math as omath
    from paddle_tpu_torch.ops import random as orandom
    mods = {"creation": creation, "manipulation": manipulation,
            "linalg": linalg, "search": search, "stat": stat,
            "math": omath, "logic": logic, "array_ops": array_ops}
    t0 = time.perf_counter()
    counts, failures = {}, []

    def run(label, fn, args, kwargs):
        tp.set_device("cpu")
        try:
            ref = fn(*to_device(args, "cpu"), **kwargs)
        finally:
            tp.set_device("gpu")
        got = fn(*to_device(args, dev), **kwargs)
        for g in leaves(got):
            if isinstance(g, torch.Tensor) and \
                    g.device.type != torch.device(dev).type:
                raise AssertionError(f"{label}: output on {g.device}")
        return ref, got

    for name, spec in generated_math.OP_TESTS.items():
        inputs, attrs, rtol, atol = schema_case(name, spec)
        label = f"generated.{name}"
        try:
            ref, got = run(label, getattr(generated_math, name),
                           list(inputs.values()), attrs)
            if name in RECON:
                recon_check(name, next(iter(inputs.values())),
                            [_np_out(r) for r in leaves(ref)], got)
            else:
                compare_out(label, ref, got, rtol or 1e-5, atol or 1e-6,
                            exact=name in EXACT)
            counts["generated"] = counts.get("generated", 0) + 1
        except Exception as e:  # noqa: BLE001 — listed, then raised
            failures.append({"op": label, "error": repr(e)[:300]})
    for mod, op, args, kwargs, cid, rtol, atol in surface_cases():
        label = f"{mod}.{cid}"
        try:
            ref, got = run(label, getattr(mods[mod], op), args, kwargs)
            if op in RECON:
                recon_check(op, args[0], [_np_out(r) for r in leaves(ref)],
                            got)
            else:
                compare_out(label, ref, got, rtol, atol,
                            exact=op in EXACT or cid in EXACT)
            counts[mod] = counts.get(mod, 0) + 1
        except Exception as e:  # noqa: BLE001 — listed, then raised
            failures.append({"op": label, "error": repr(e)[:300]})
    named = {"x": np.random.default_rng(4).standard_normal(
        (64, 8)).astype(np.float32),
        "p": np.full((64,), 0.3, np.float32),
        "lam": np.full((64,), 3.0, np.float32),
        "probs": np.array([0.1, 0.2, 0.3, 0.4], np.float32)}
    for op, args, kwargs in RANDOM_CASES:
        label = f"random.{op}"
        fn = getattr(orandom, op)
        try:
            draws = []
            for device in ("cpu", dev, dev):
                tp.set_device("cpu" if device == "cpu" else "gpu")
                try:
                    tp.seed(7)
                    real = [to_device(named[a], device)
                            if isinstance(a, str) else a for a in args]
                    draws.append(fn(*real, **kwargs))
                finally:
                    tp.set_device("gpu")
            cpu, a, b = draws
            if a.device.type != torch.device(dev).type or \
                    a.dtype != cpu.dtype or \
                    a.shape != cpu.shape:
                raise AssertionError(f"{a.device} {a.dtype} "
                                     f"{tuple(a.shape)} against the CPU's "
                                     f"{cpu.dtype} {tuple(cpu.shape)}")
            if not torch.equal(a, b):
                raise AssertionError("two draws under seed(7) differ")
            counts["random"] = counts.get("random", 0) + 1
        except Exception as e:  # noqa: BLE001 — listed, then raised
            failures.append({"op": label, "error": repr(e)[:300]})
    emit("op_surface", counts=counts, total=sum(counts.values()),
         failures=failures, seconds=time.perf_counter() - t0)
    if failures:
        raise AssertionError(f"op_surface: {len(failures)} ops failed: "
                             f"{[f['op'] for f in failures]}")
    return counts


# -- phase 17: AMP, Paddle's dygraph recipe on the Train cell's model --------

AMP_STEPS = 3
# the plain Train cell's step (PERF.md section 5), beside which the
# AMP steps are printed
TRAIN_STEP_REF_S = 0.2923
# AMP's loss against its reference on the same weights and batch
AMP_LOSS_TOL = 2e-2
# the fp32 first designs under O1 (gemm_tile.cuh's gemm_kernel<float>)
AMP_FAMILIES = ("gemm_kernel", "flash_fwd_hopper", "flash_dq_hopper",
                "flash_dkv_hopper", "adam_kernel")


@contextlib.contextmanager
def quiet():
    """Swallow what a block prints (the operator stats' table)."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        yield


def amp_stats_cpu(level, layers):
    """The operator stats (op -> dtype -> calls) of the recipe's forward
    on the CPU: a tiny fp32 Llama of `layers` layers under
    auto_cast(level, bfloat16), decorated first at O2."""
    from paddle_tpu_torch import amp, seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=128, intermediate_size=256,
                           num_attention_heads=2, num_key_value_heads=1,
                           num_hidden_layers=layers)
    seed(0)
    model = LlamaForCausalLM(cfg, device="cpu")
    if level == "O2":
        amp.decorate(model, level="O2", dtype="bfloat16")
    ids = torch.randint(0, cfg.vocab_size, (2, 16))
    with quiet(), amp.debugging.collect_operator_stats() as s:
        with amp.auto_cast(level=level, dtype="bfloat16"):
            model.loss(ids, ids)
    return s.dtypes


def amp_expected_stats(level, layers):
    """A card step's stats from the CPU's at one and two layers: the
    per-layer ops times `layers` plus the rest."""
    one, two = amp_stats_cpu(level, 1), amp_stats_cpu(level, 2)
    out = {}
    for op in set(one) | set(two):
        for dt in set(one.get(op, {})) | set(two.get(op, {})):
            a, b = one.get(op, {}).get(dt, 0), two.get(op, {}).get(dt, 0)
            out.setdefault(op, {})[dt] = a - (b - a) + layers * (b - a)
    return out


def amp_steps(level, model, opt, scaler, batch, kernels):
    """AMP_STEPS of the recipe: ``with auto_cast: loss = model.loss``,
    ``scaler.scale(loss).backward()``, ``scaler.step(opt)``,
    ``opt.clear_grad()``; the first under the operator stats."""
    from paddle_tpu_torch import amp
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, stats = [], [], None
    for i in range(AMP_STEPS):
        t0 = time.perf_counter()
        collect = amp.debugging.collect_operator_stats() if i == 0 \
            else contextlib.nullcontext()
        with quiet(), collect as s:
            with amp.auto_cast(level=level, dtype="bfloat16"):
                loss = model.loss(batch["input_ids"], batch["labels"])
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            stats = s.dtypes
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {fn.__name__: dict(fn.launches_by_dtype)
                for fn in kernels.BY_DTYPE}
    launches["multi_tensor_adam"] = kernels.multi_tensor_adam.launches
    return losses, times, stats, peak, launches


def amp_gates(phase, level, losses, ref_loss, scaler, stats, launches,
              layers):
    """The phase's checks: finite losses and scale, the first loss
    within AMP_LOSS_TOL of its reference, the stats a CPU run predicts
    (white ops bf16, black fp32), and the launches by wrapper and dtype,
    exact (QKV and the MLP fp32 at O1, bf16 at O2; flash bf16 both)."""
    if not (np.all(np.isfinite(losses)) and
            np.isfinite(scaler.get_loss_scaling())):
        raise AssertionError(f"{phase}: non-finite loss {losses} or scale "
                             f"{scaler.get_loss_scaling()}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if rel > AMP_LOSS_TOL:
        raise AssertionError(f"{phase}: first loss {losses[0]} vs "
                             f"{ref_loss}: {rel:.3g} > {AMP_LOSS_TOL}")
    want = amp_expected_stats(level, layers)
    if stats != want:
        raise AssertionError(f"{phase}: operator stats {stats}, the CPU "
                             f"run predicts {want}")
    for op in ("linear", "scaled_dot_product_attention"):
        if set(stats.get(op, {})) != {"bfloat16"}:
            raise AssertionError(f"{phase}: white op {op} ran {stats}")
    if set(stats.get("rms_norm", {})) != {"float32"}:
        raise AssertionError(f"{phase}: black rms_norm ran {stats}")
    n = layers * AMP_STEPS
    gemm = "float32" if level == "O1" else "bfloat16"
    want_l = {"fused_rmsnorm_qkv": {gemm: n}, "fused_mlp": {gemm: n},
              "fused_ffn": {}, "flash_attention_fwd": {"bfloat16": n},
              "flash_attention_bwd_dq": {"bfloat16": n},
              "flash_attention_bwd_dkv": {"bfloat16": n},
              "multi_tensor_adam": AMP_STEPS}
    if launches != want_l:
        raise AssertionError(f"{phase}: launches {launches}, expected "
                             f"{want_l}")
    return rel


def amp_skip_check(model, opt, scaler, batch):
    """An inf written into one gradient: ``scaler.step`` must leave every
    parameter bitwise equal and multiply the scale by decr_ratio."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        loss = model.loss(batch["input_ids"], batch["labels"])
    scaler.scale(loss).backward()
    params = [p for p in model.parameters()]
    params[len(params) // 2].grad.view(-1)[0] = float("inf")
    before = [p.detach().clone() for p in params]
    scale0 = scaler.get_loss_scaling()
    scaler.step(opt)
    opt.clear_grad()
    same = all(torch.equal(a, p.detach()) for a, p in zip(before, params))
    want = max(scale0 * scaler._decr_ratio, 1.0)
    if not same or not scaler._found_inf or \
            scaler.get_loss_scaling() != want:
        raise AssertionError(f"amp_o1: the inf step changed parameters "
                             f"({not same}) or the scale "
                             f"{scaler.get_loss_scaling()} != {want}")
    del before
    return {"skipped": True, "params_bitwise_equal": same,
            "scale_before": scale0, "scale_after": scaler.get_loss_scaling()}


def amp_phases(dev, kernels):
    """Paddle's dygraph AMP recipe on the Train cell's model:
    LlamaConfig.llama3_8b() width, 4 of 32 layers, b=4, s=2048, built in
    fp32 from seed 0, AdamW.  amp_o1: auto_cast(O1, bf16) + GradScaler,
    AMP_STEPS steps; its first loss against an fp32 forward on the same
    weights and batch; the skip check; one more step profiled (the fp32
    first designs' share).  amp_o2: decorate(model, AdamW, O2, bf16) (a
    fresh optimizer, fp32 masters), the same loop; its first loss
    against the plain bf16 model's (norms bf16, where O2 runs them in
    fp32).  Returns each level's launches by wrapper and dtype."""
    from paddle_tpu_torch import amp, seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = TRAIN_LAYERS
    cfg.dtype = "float32"
    seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    tokens = TRAIN_B * TRAIN_S
    flops_tok = 6 * n_params + 12 * TRAIN_LAYERS * TRAIN_S * cfg.hidden_size
    out = {}
    with torch.no_grad():
        ref32 = float(model.loss(batch["input_ids"], batch["labels"]))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    scaler = amp.GradScaler()
    losses, times, stats, peak, launches = amp_steps(
        "O1", model, opt, scaler, batch, kernels)
    rel = amp_gates("amp_o1", "O1", losses, ref32, scaler, stats, launches,
                    TRAIN_LAYERS)
    skip = amp_skip_check(model, opt, scaler, batch)

    def one_step():
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model.loss(batch["input_ids"], batch["labels"])
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
    prof = profile_call(one_step, "amp_o1_profile", AMP_FAMILIES, top_n=12,
                        steps=1)
    busy = prof["device_busy_s"] or float("nan")
    fp32_ms = prof["port_kernels"]["gemm_kernel"]["ms"]
    dt = float(np.median(times[1:]))
    # fp32 parameters, gradients and AdamW's two moments: 16 bytes each
    emit("amp_o1", level="O1", dtype="bfloat16", params=n_params,
         param_dtype="float32", layers=TRAIN_LAYERS, batch=TRAIN_B,
         seq=TRAIN_S, recipe="auto_cast(O1) + GradScaler + AdamW",
         model_build_s=build_s, fp32_forward_loss=ref32, losses=losses,
         first_loss_rel_err=rel, loss_tol=AMP_LOSS_TOL,
         scale=scaler.get_loss_scaling(), skip_check=skip, step_s=times,
         step_s_median=dt, train_cell_step_s=TRAIN_STEP_REF_S,
         tokens_per_s=tokens / dt,
         mfu=flops_tok * tokens / dt / BF16_FLOP_PER_S,
         peak_mem_gb=peak, reckoned_state_gb=16 * n_params / 2 ** 30,
         operator_stats=stats, launches_by_dtype=launches,
         fp32_kernels_ms=fp32_ms,
         fp32_kernels_share_of_device=fp32_ms / 1e3 / busy,
         fp32_kernels_share_of_step=fp32_ms / 1e3 / prof["wall_s"])
    out["amp_o1"] = launches
    del opt, scaler
    torch.cuda.empty_cache()

    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    with torch.no_grad():
        ref_bf16 = float(model.loss(batch["input_ids"], batch["labels"]))
    scaler = amp.GradScaler()
    losses, times, stats, peak, launches = amp_steps(
        "O2", model, opt, scaler, batch, kernels)
    rel = amp_gates("amp_o2", "O2", losses, ref_bf16, scaler, stats,
                    launches, TRAIN_LAYERS)
    masters = all(opt._accumulators[id(p)]["_master"].dtype == torch.float32
                  for p in model.parameters())
    if not masters or any(p.dtype != torch.bfloat16
                          for p in model.parameters()):
        raise AssertionError("amp_o2: decorate left fp32 parameters or no "
                             "fp32 masters")
    dt = float(np.median(times[1:]))
    emit("amp_o2", level="O2", dtype="bfloat16", params=n_params,
         param_dtype="bfloat16", masters="float32", layers=TRAIN_LAYERS,
         batch=TRAIN_B, seq=TRAIN_S,
         recipe="decorate(O2) + auto_cast(O2) + GradScaler + AdamW",
         plain_bf16_forward_loss=ref_bf16, losses=losses,
         first_loss_rel_err=rel, loss_tol=AMP_LOSS_TOL,
         scale=scaler.get_loss_scaling(), step_s=times, step_s_median=dt,
         train_cell_step_s=TRAIN_STEP_REF_S, tokens_per_s=tokens / dt,
         mfu=flops_tok * tokens / dt / BF16_FLOP_PER_S, peak_mem_gb=peak,
         operator_stats=stats, launches_by_dtype=launches)
    out["amp_o2"] = launches
    del model, opt, scaler
    torch.cuda.empty_cache()
    return out


def kernel_amp_fp32(FB, dev, timer, T=TRAIN_B * TRAIN_S):
    """The fp32 first designs that O1 puts on a user path: the QKV
    kernel's training variant and the MLP pair at the Train step's T,
    against their plain versions, timed beside them, the fp32 library
    chain (F.rms_norm then the products; the MLP's three products) and
    the bound at the fp32 rate (TF32 off)."""
    g = torch.Generator(device=dev).manual_seed(T + 19)
    dt = torch.float32
    F_ = torch.nn.functional
    x = rand(g, (T, D), dt, dev)
    wn = rand(g, (D,), dt, dev, 0.1) + 1
    s = (2.0 / (D + DQ)) ** 0.5
    wq, wk, wv = (rand(g, (D, n), dt, dev, s) for n in (DQ, DKV, DKV))
    got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS, residuals=True)
    ref = FB.qkv_reference(x, wn, wq, wk, wv, EPS, residuals=True)
    err = max(check_close(f"fused_rmsnorm_qkv train fp32 {n}", a, b_, dt)
              for n, a, b_ in zip(("q", "k", "v", "xn", "inv"), got, ref))
    del got, ref

    def qkv_lib():
        xn = F_.rms_norm(x, (D,), wn, EPS)
        return xn @ wq, xn @ wk, xn @ wv
    qkv = {"ms": timer(lambda: FB.fused_rmsnorm_qkv(
        x, wn, wq, wk, wv, EPS, residuals=True), iters=5),
        "plain_ms": timer(lambda: FB.qkv_reference(
            x, wn, wq, wk, wv, EPS, residuals=True), iters=3, warmup=1),
        "library_ms": timer(qkv_lib, iters=5), "max_abs_err": err,
        "shape": f"T={T} d={D} dq={DQ} dkv={DKV} fp32",
        "kernel_path": "tile"}
    qkv["bound_ms"], qkv["bound_by"] = bound_ms(
        *qkv_io(T, item=4, train=True), FP32_FLOP_PER_S)
    del wq, wk, wv
    s = (2.0 / (D + F)) ** 0.5
    wg, wu = rand(g, (D, F), dt, dev, s), rand(g, (D, F), dt, dev, s)
    wd = rand(g, (F, D), dt, dev, s)
    err = check_close("fused_mlp fp32 T=8192", FB.fused_mlp(x, wg, wu, wd),
                      FB.mlp_reference(x, wg, wu, wd), dt)
    mlp = {"ms": timer(lambda: FB.fused_mlp(x, wg, wu, wd), iters=5),
           "plain_ms": timer(lambda: FB.mlp_reference(x, wg, wu, wd),
                             iters=3, warmup=1),
           "library_ms": timer(lambda: (F_.silu(x @ wg) * (x @ wu)) @ wd,
                               iters=5),
           "max_abs_err": err, "shape": f"T={T} d={D} f={F} fp32",
           "kernel_path": "tile"}
    mlp["bound_ms"], mlp["bound_by"] = bound_ms(*mlp_io(T, item=4),
                                                FP32_FLOP_PER_S)
    return {"fused_rmsnorm_qkv_train_fp32": qkv, "fused_mlp_train_fp32": mlp}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # the port itself: an ImportError here (script copied alone) is fatal
    from paddle_tpu_torch.ops import kernels
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import cross_entropy as CE
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    from paddle_tpu_torch.ops.kernels import grouped_matmul as GM
    from paddle_tpu_torch.ops.kernels import multi_tensor as MT
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.distributed import moe as TM
    from paddle_tpu_torch.ops.kernels import quant_matmul as QM
    from paddle_tpu_torch.ops.kernels import rmsnorm as RN
    from paddle_tpu_torch.inference.kv_cache import _quantize_kv
    from paddle_tpu_torch.quantization.serving import quantize_linear_weight

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
    # -Xptxas -v of the Hopper kernels, compiled beside the build
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ptxas = pool.submit(_build.ptxas_report, PTXAS_SOURCES,
                            PTXAS_KERNELS)
        nvcc_s = _build.build_all()
        emit("build", nvcc_s=nvcc_s, cached=nvcc_s == 0.0,
             seconds=time.perf_counter() - t0, dir=str(_build.BUILD_DIR))
        report = ptxas.result()
        emit("ptxas", seconds=time.perf_counter() - t0, kernels=report)
        spills = {k: v for k, v in report.items()
                  if v.get("spill_stores") or v.get("spill_loads")
                  or any("wgmma" in n for n in v.get("notes", ()))}
        if spills or {v["kernel"] for v in report.values()} != \
                set(PTXAS_KERNELS):
            raise AssertionError(f"ptxas: spills or serialised wgmma "
                                 f"{spills}, or a kernel missing from "
                                 f"{sorted(report)}")

    timer = Timer(dev)
    res = {"fused_rmsnorm_qkv": {T: kernel_qkv(FB, dev, timer, T)
                                 for T in (1, 8, 16, 256)},
           "fused_mlp": {T: kernel_mlp(FB, dev, timer, T)
                         for T in (1, 8, 16, 256)},
           "paged_decode_attention": {8: kernel_paged(PA, dev, timer)}}
    emit("kernels", results={k: {str(t): v for t, v in r.items()}
                             for k, r in res.items()})
    train_rows = kernel_flash(FA, dev, timer)
    train_rows["fused_rmsnorm_qkv_train"] = kernel_qkv_train(FB, dev, timer)
    train_rows["fused_rmsnorm_qkv_fwd_T8192"] = kernel_qkv(
        FB, dev, timer, TRAIN_B * TRAIN_S, plain_iters=3)
    train_rows["fused_mlp_train"] = kernel_mlp(FB, dev, timer,
                                               TRAIN_B * TRAIN_S,
                                               plain_iters=3)
    train_rows.update(kernel_amp_fp32(FB, dev, timer))
    emit("kernels_train", results=train_rows)
    quant_rows = kernel_quant_rows(QM, quantize_linear_weight, dev, timer)
    quant_rows["paged_decode_attention_int8"] = kernel_paged_int8(
        PA, _quantize_kv, dev, timer)
    emit("kernels_quant", results=quant_rows)
    moe_rows = kernels_moe(GM, TM, dev, timer)
    emit("kernels_moe", results=moe_rows)
    ce_rows = kernels_ce(CE, dev, timer)
    emit("kernels_ce", results=ce_rows)
    ffn_rows = kernels_ffn(FB, dev, timer)
    emit("kernels_ffn", results=ffn_rows)
    dec_rows = kernel_decoder(FB, dev, timer)
    norm_rows = kernel_rmsnorm(RN, dev, timer)
    emit("kernels_decoder", results={"fused_decoder_block": dec_rows,
                                     "fused_rmsnorm": norm_rows})
    mt_rows = kernel_multi_tensor(MT, dev, timer)
    emit("kernels_multi_tensor", results=mt_rows)
    del timer
    torch.cuda.empty_cache()
    op_surface(dev)
    torch.cuda.empty_cache()

    card, host, prompt = parity(dev)
    parity_quant(card, host, prompt, kernels)
    parity_int8w(card, host, prompt, kernels)
    static_parity(card, host, prompt)
    concat_cache(card, kernels)
    ptq_qat(card, host, kernels)
    del card, host
    torch.cuda.empty_cache()
    train_parity(dev)
    torch.cuda.empty_cache()
    launches, model, prompts, bf16_tokens, eager = serve(dev, kernels)
    torch.cuda.empty_cache()
    quant_launches = serve_quant(dev, kernels, model, prompts, bf16_tokens)
    torch.cuda.empty_cache()
    int8w_launches = serve_int8w(kernels, model, prompts, bf16_tokens)
    torch.cuda.empty_cache()
    graphed = {}
    graphed["serve_graph"], chunk_launches = serve_graph(
        dev, kernels, model, prompts, bf16_tokens, eager)
    serve_spec(kernels, model)
    graphed["serve_static"] = serve_static(kernels, model, prompts,
                                           bf16_tokens)
    fleet_launches = serve_fleet(kernels, model, prompts, bf16_tokens)
    graphed["generate"] = generate_phase(
        kernels, model, "llama3_8b", 4, 512, 64,
        (kernels.SERVING[0], kernels.SERVING[1]))
    score_launches = score_decoder(model, kernels)
    torch.cuda.empty_cache()
    import tempfile
    with tempfile.TemporaryDirectory() as ledger:
        reports = device_profile(dev, kernels, ledger)
        measured_tier(model, kernels, ledger, reports)
    del model
    torch.cuda.empty_cache()
    generate_gpt(dev, kernels)
    train_launches, train_peak = train(dev, kernels)
    torch.cuda.empty_cache()
    graph_launches = train_graph(dev, kernels)
    torch.cuda.empty_cache()
    train_state(dev)
    torch.cuda.empty_cache()
    amp_launches = amp_phases(dev, kernels)
    torch.cuda.empty_cache()
    decoder_parity(dev, kernels)
    torch.cuda.empty_cache()
    dec_launches = train_decoder(dev, kernels, train_peak)
    torch.cuda.empty_cache()
    moe_parity(GM, TM, dev)
    torch.cuda.empty_cache()
    moe_launches = train_moe(dev, kernels)
    torch.cuda.empty_cache()
    gpt_parity(dev, kernels)
    torch.cuda.empty_cache()
    gpt_launches = train_gpt(dev, kernels)
    torch.cuda.empty_cache()
    gpt_graph_launches = train_gpt_graph(dev, kernels)
    torch.cuda.empty_cache()
    drill_launches, digest_row = recovery_drill(dev, kernels)
    torch.cuda.empty_cache()
    cold_launches = cold_start()
    ffn_launches = transformer_infer(dev, kernels)
    torch.cuda.empty_cache()
    norm_launches = norm_residual(dev, kernels)
    torch.cuda.empty_cache()
    demo_phase()

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
        # QKV and the MLP split-K at T = 8, wgmma at 256; paged split
        entry["launches_by_path"] = launches["launches_by_path"][name]
        # the launches one replay of each captured decode program makes,
        # and one replay of Serve's prefill chunk
        entry["graph_launches_a_replay"] = {
            k: v.get(name, 0) for k, v in graphed.items()}
        entry["graph_launches_a_replay"]["serve_graph.prefill_chunk"] = \
            chunk_launches.get(name, 0)
        entry["launches_serve_fleet"] = fleet_launches[name]
        if name == "fused_mlp":
            entry["path"] = decode["path"]
            entry["prefill_T256"]["path"] = by_t[256]["path"]
            entry["split_launches"] = decode["launches"]
        else:
            entry["kernel_path"] = decode["kernel_path"]
        if name == "fused_rmsnorm_qkv":   # the scoring forward's shape
            entry["prefill_T256"]["kernel_path"] = by_t[256]["kernel_path"]
        if name != "paged_decode_attention":
            entry["decode_T1_T16"] = {T: {k: by_t[T][k] for k in keys}
                                      for T in (1, 16)}
            entry["forward_T8192"] = {
                k: train_rows["fused_rmsnorm_qkv_fwd_T8192"][k]
                for k in keys}
        line.append(entry)
    flash_src = "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu"
    train_where = {
        "flash_attention_fwd": (
            flash_src, "paddle_tpu/ops/pallas/flash_attention.py:71"),
        "flash_attention_bwd_dq": (
            flash_src, "paddle_tpu/ops/pallas/flash_attention.py:192"),
        "flash_attention_bwd_dkv": (
            flash_src, "paddle_tpu/ops/pallas/flash_attention.py:242"),
        "fused_rmsnorm_qkv_train": (
            "paddle_tpu_torch/ops/kernels/csrc/fused_block.cu",
            "paddle_tpu/ops/pallas/fused_block.py:249"),
        "fused_mlp_train": (
            "paddle_tpu_torch/ops/kernels/csrc/fused_block.cu",
            "paddle_tpu/ops/pallas/fused_block.py:494"),
    }
    for name, (src, rep) in train_where.items():
        row = train_rows[name]
        wrapper = name.removesuffix("_train")
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": rep, "launches": train_launches[wrapper],
                 **{k: row[k] for k in keys}, "shape": row["shape"],
                 "path": "train"}
        if name.startswith("flash"):   # GPT-2 medium's shape, train_gpt's
            gpt = train_rows[name + "_gpt"]
            entry["gpt_shape"] = {"launches": gpt_launches[name],
                                  **{k: gpt[k] for k in keys},
                                  "shape": gpt["shape"],
                                  "path": "train_gpt"}
        if "_bwd_" in name:            # the reduction before each backward
            entry["flash_delta_ms"] = train_rows["flash_delta"]["ms"]
            entry["gpt_shape"]["flash_delta_ms"] = \
                train_rows["flash_delta_gpt"]["ms"]
        # AMP's steps (amp_o1, amp_o2): this wrapper's launches by dtype
        for phase, got in amp_launches.items():
            entry[f"launches_{phase}"] = got[wrapper]
        line.append(entry)
    # the fp32 first designs that amp_o1 launches (QKV's training variant
    # and the MLP at T = 8192): launches from amp_o1's steps
    for name, rep in (("fused_rmsnorm_qkv_train_fp32",
                       "paddle_tpu/ops/pallas/fused_block.py:249"),
                      ("fused_mlp_train_fp32",
                       "paddle_tpu/ops/pallas/fused_block.py:494")):
        row = train_rows[name]
        wrapper = name.removesuffix("_train_fp32")
        line.append({"name": name, "route": "cuda",
                     "source": "paddle_tpu_torch/ops/kernels/csrc/"
                               "fused_block.cu", "replaces": rep,
                     "launches": amp_launches["amp_o1"][wrapper].get(
                         "float32", 0),
                     **{k: row[k] for k in keys}, "shape": row["shape"],
                     "path": "amp_o1 (auto_cast O1: fp32, a gray op)",
                     "kernel_path": row["kernel_path"],
                     "launches_amp_o1": amp_launches["amp_o1"][wrapper],
                     "launches_amp_o2": amp_launches["amp_o2"][wrapper]})
    # the quantized serving path: the gate/up shape at decode stands for
    # the quant matmul (its other shapes are in the kernels_quant line);
    # launches from each engine's serve_quant run
    src = "paddle_tpu_torch/ops/kernels/csrc/"
    # (the prefill chunk's T = 256 beside it, on the wgmma design)
    prefill = {"quant_matmul": "int8 T=256 gate_proj/up_proj bfloat16",
               "quant_matmul_fp8": "fp8 T=256 gate_proj/up_proj bfloat16"}
    for name, row, rep, n, path in (
            ("quant_matmul", "int8 T=8 gate_proj/up_proj",
             "paddle_tpu/ops/pallas/quant_matmul.py:133",
             quant_launches["int8"]["quant_matmul_by_mode"]["int8"],
             "serve_quant int8 weights"),
            ("quant_matmul_fp8", "fp8 T=8 gate_proj/up_proj bfloat16",
             "paddle_tpu/ops/pallas/quant_matmul.py:133",
             quant_launches["fp8"]["quant_matmul_by_mode"]["fp8"],
             "serve_quant fp8 weights"),
            ("paged_decode_attention_int8", "paged_decode_attention_int8",
             "paddle_tpu/ops/pallas/paged_attention.py:145",
             quant_launches["int8"]["paged_decode_attention_int8"],
             "serve_quant int8 KV")):
        r = quant_rows[row]
        cu = "paged_attention.cu" if name.startswith("paged") else \
            "quant_matmul.cu"
        wmode = "fp8" if name == "quant_matmul_fp8" else "int8"
        entry = {"name": name, "route": "cuda", "source": src + cu,
                 "replaces": rep, "launches": n, **{k: r[k] for k in keys},
                 "shape": r["shape"], "path": path,
                 "graph_launches_a_replay": quant_launches[wmode][
                     "graph_launches_a_replay"].get(
                         name.removesuffix("_fp8"), 0),
                 "chunk_launches_a_replay": quant_launches[wmode][
                     "chunk_launches_a_replay"].get(
                         name.removesuffix("_fp8"), 0)}
        if name == "paged_decode_attention_int8":
            entry["launches_serve_fleet"] = fleet_launches[name]
        if name.startswith("paged"):
            entry["kernel_path"] = r["kernel_path"]
            entry["launches_by_path"] = quant_launches["int8"]["paged_by_path"]
        if name == "quant_matmul":
            # the engine's int8_weights path (serve_int8w): the eager
            # run's launches and one replay of each captured program
            entry["int8_weights"] = {
                "launches": int8w_launches["launches"],
                **{k: v.get(name, 0) for k, v in int8w_launches.items()
                   if k.endswith("a_replay")}}
        if name in prefill:
            entry["kernel_path"] = r["path"]
            entry["launches_by_path"] = \
                quant_launches[wmode]["quant_matmul_by_path"]
            pre = quant_rows[prefill[name]]
            entry["prefill_T256"] = {**{k: pre[k] for k in keys},
                                     "kernel_path": pre["path"]}
        line.append(entry)
    # the MoE training path: the slice's routed shape; launches from the
    # einsum run (the config's default), the index run's beside them
    r = moe_rows["routed bf16"]
    line.append({"name": "grouped_expert_ffn", "route": "cuda",
                 "source": src + "grouped_matmul.cu",
                 "replaces": "paddle_tpu/ops/pallas/grouped_matmul.py:121",
                 "launches": moe_launches["einsum"]["grouped_expert_ffn"],
                 **{k: r[k] for k in keys}, "shape": r["shape"],
                 "path": "train_moe einsum dispatch",
                 "kernel_path": r["path"],
                 "fp32_kernel_path": moe_rows["fp32 C=64"]["path"],
                 "launches_index_dispatch":
                     moe_launches["index"]["grouped_expert_ffn"]})
    # the GPT training path: the step's shape; launches from train_gpt
    for name, rep_ in (("cross_entropy_fwd",
                        "paddle_tpu/ops/pallas/cross_entropy.py:75"),
                       ("cross_entropy_bwd",
                        "paddle_tpu/ops/pallas/cross_entropy.py:145")):
        r = ce_rows["bf16 T=8192 V=50304"][name]
        line.append({"name": name, "route": "cuda",
                     "source": src + "cross_entropy.cu", "replaces": rep_,
                     "launches": gpt_launches[name],
                     **{k: r[k] for k in keys}, "shape": r["shape"],
                     "path": "train_gpt"})
    # the nn.Transformer path: relu bf16 at its FFN shape; launches from
    # transformer_infer
    r, r8 = ffn_rows["relu bf16"], ffn_rows["relu bf16 T=8"]
    line.append({"name": "fused_ffn", "route": "cuda",
                 "source": src + "fused_block.cu",
                 "replaces": "paddle_tpu/ops/pallas/fused_block.py:494",
                 "launches": ffn_launches["fused_ffn"],
                 **{k: r[k] for k in keys}, "shape": r["shape"],
                 "path": "transformer_infer",
                 "decode_T8": {**{k: r8[k] for k in keys},
                               "kernel_path": r8["path"]}})
    # the decoder tier: the block at the train shape (bf16), launches from
    # train_decoder's forwards, score_decoder's beside them; the rmsnorm
    # kernel at T=8192 d=4096 bf16 with a residual, launches from
    # train_decoder's recompute (norm2, no residual), norm_residual's beside
    r = dec_rows["bfloat16"]
    line.append({"name": "fused_decoder_block", "route": "cuda",
                 "source": src + "fused_decoder.cu",
                 "replaces": "paddle_tpu/ops/pallas/fused_block.py:830",
                 "launches": dec_launches["fused_decoder_block"],
                 **{k: r[k] for k in keys}, "shape": r["shape"],
                 "path": "train_decoder", "kernel_path": r["path"],
                 "fp32_kernel_path": dec_rows["float32"]["path"],
                 "launches_score_decoder": score_launches})
    r = norm_rows[f"T={NORM_T} d={D} bfloat16 residual"]
    r0 = norm_rows[f"T={NORM_T} d={D} bfloat16"]
    line.append({"name": "fused_rmsnorm", "route": "cuda",
                 "source": src + "rmsnorm.cu",
                 "replaces": "paddle_tpu/ops/pallas/rmsnorm.py:39",
                 "launches": dec_launches["fused_rmsnorm"],
                 **{k: r[k] for k in keys}, "shape": r["shape"],
                 "path": "train_decoder (norm2 of the recompute)",
                 "launches_norm_residual": norm_launches,
                 "no_residual": {k: r0[k] for k in keys}})
    # the optimizer step's two port-side kernels (no pallas_call stands
    # behind them: XLA fuses the reference's per-leaf norm and update);
    # launches from train's eager steps, train_gpt's beside them, and the
    # launches each captured graph holds (once a replay)
    for name, rep_ in (("multi_tensor_norm",
                        "paddle_tpu/jit/train_step.py:538"),
                       ("multi_tensor_adam",
                        "paddle_tpu/optimizer/optimizers.py:144")):
        r = mt_rows[name]
        line.append({"name": name, "route": "cuda",
                     "source": src + "multi_tensor.cu", "replaces": rep_,
                     "launches": train_launches[name],
                     **{k: r[k] for k in keys}, "shape": r["shape"],
                     "path": "train (eager), train_graph (one graph)",
                     "bitwise": r["bitwise"],
                     "launches_train_gpt": gpt_launches[name],
                     "graph_launches_a_replay": {
                         "train_graph": graph_launches[name],
                         "train_gpt_graph": gpt_graph_launches[name]}})
    # the recovery drill's digest (the SDC sentinels' check): the drill's
    # shape, the Train model's beside it; launches from the drill and
    # from both cold-start processes (the weights' digest)
    r = digest_row
    line.append({"name": "multi_tensor_digest", "route": "cuda",
                 "source": src + "multi_tensor.cu",
                 "replaces": "paddle_tpu/robustness/recovery.py:503",
                 "launches": drill_launches["multi_tensor_digest"],
                 **{k: r[k] for k in keys}, "shape": r["shape"],
                 "path": "recovery_drill (TrainStep's SDC hook and the "
                         "sentinels)", "bitwise": r["bitwise"],
                 "train_shape": {
                     **{k: mt_rows["multi_tensor_digest_train"][k]
                        for k in keys},
                     "shape": mt_rows["multi_tensor_digest_train"][
                         "shape"]}})
    # every kernel the two new paths launched, on its row
    for entry in line:
        w = entry["name"].removesuffix("_train").removesuffix("_fp8")
        for phase, got in amp_launches.items():
            if w in got:
                entry.setdefault(f"launches_{phase}", got[w])
        if drill_launches.get(w):
            entry["launches_recovery_drill"] = drill_launches[w]
        if cold_launches["A"].get(w) or cold_launches["B"].get(w):
            entry["launches_cold_start"] = {
                k: v.get(w, 0) for k, v in cold_launches.items()}
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-start-child"]:
        if not torch.cuda.is_available():
            sys.exit(2)
        cold_child(*sys.argv[2:5])
        sys.exit(0)
    sys.exit(main())
