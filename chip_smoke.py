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
            dk/dv, the fp32 flash forward and its split pre-pass, the QKV
            row pass and wgmma GEMM, the MLP / fused_ffn wgmma GEMM and
            split-K, the quant matmul's split-K and wgmma kernels, the
            rmsnorm's register design):
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
            within a stated tolerance, and PARITY_NEW greedy tokens.  Then
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
            DRILL_STEPS steps, a peer snapshot, a checkpoint and an SDC
            check every DRILL_EVERY, recovery.rank_kill at DRILL_KILL (5,
            3, 4: one snapshot; the reference's drill takes 8 steps and
            kills at 7); then a fresh captured step
            restored from the peer snapshot and, with recovery.peer_fetch
            armed, from disk, each resumed to the last step: losses bitwise equal
            to the uninterrupted run's on both paths.  A train.sdc_flip on
            one of three sentinels detected, blamed and quarantined; with
            two, the replay breaks the tie.  multi_tensor_digest on the
            parameters bitwise equal to its plain version and to the
            JAX package's formula in numpy, timed beside its bound.
            Snapshot bytes, ship and restore seconds, MTTR, checkpoint
            write and read GB/s.
15. cold start  cold_start (after recovery_drill): two fresh processes
            at Llama-3-8B width, COLD_LAYERS (2) of 32 layers, bf16,
            Serve's paged engine.  A (the repo, an empty cache) runs aot_warmup, serves
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
            and MLP: 4 a step each, all on the 3xTF32 design), an inf
            written into one gradient skipping the step (every parameter
            bitwise equal, the scale halved), then one step profiled: the
            fp32 kernels' device share (the split pre-pass, the row pass
            and the 3xTF32 GEMMs).  amp_o2: decorate(model, AdamW, O2,
            bf16), the same loop, the first loss against the plain bf16
            model's, bf16 QKV and MLP, fp32 masters.  Step time and peak
            beside the Train cell's 0.2923 s.  kernels_train carries the
            fp32 QKV training variant and MLP at T = 8192 and fused_ffn's
            fp32 row (the design each launched, the bound at its rate
            and the fp32 CUDA cores' beside it, the errors against
            float64 beside the plain version's, the memory a call
            allocates, the fp32 library chain) and the kernels line
            their rows and every AMP wrapper's launches_amp_o1 / _o2.

18. sparse_embed (after norm_residual) the Train cell's model (Llama-
            3-8B width, 4 of 32 layers, bf16, b=4, s=2048) in eager steps
            (``autograd.backward(loss)``, ``AdamW(multi_precision=True,
            lazy_mode=True)``) on batches A, B, A, B (B: A with its last
            sequence new), run twice from the same weights: dense
            embedding, then ``sparse_embed``.  Gates: step 1's loss
            equal; the embedding's gradient a sparse COO tensor of b*s
            rows, the port's and torch's ``coalesce()`` within k - 1 bf16
            roundings of an fp32 sum (exact for a row met once); memory
            allocated after backward lower in the sparse run by
            SPARSE_SAVE_GB; the fp32 master and moments of the touched
            rows after every step against a float64 reference of the
            lazy rule on the gradient it took (SPARSE_MOMENT_TOL,
            SPARSE_MASTER_ULPS), the watched rows it did not touch
            (batch A's at B's steps, a sample that no batch touches)
            bitwise kept, the dense rule changing them; the same state
            against the dense rule's: the dense run's after step 1 on
            the rows met once, and multi_tensor_adam replayed on the
            sparse run's gradients after every step on the rows every
            step touched (SPARSE_DENSE_*); the untouched bf16
            rows unchanged, every other parameter within the bf16
            tolerance of the dense run's; each batch's loss falling; QKV,
            the MLP (wgmma, never the tile) and flash launched each step,
            multi_tensor_adam once.  Reported: step seconds and peak
            memory of each run, the sparse rule's CUDA-event ms, its
            bound from its bytes and its kernel launches, unique rows.
            Then a 2-layer sparse_embed model's TrainStep.compile runs
            the embedding dense in its graph: two replays bitwise equal
            to the dense model's.
19. autograd grad(create_graph=True) (a gradient penalty through a
            2-layer MLP at d=4096, fp32), a user PyLayer, jacobian and
            hessian on CUDA tensors against the same calls on the CPU,
            within AUTOGRAD_TOL relative (TF32 off).
20. resnet50 vision.models.resnet50() (25.6 M parameters, fp32) on the
            card, on the CPU in fp32 and in float64, from one state, at
            b=RESNET_PARITY_B, RESNET_PARITY_HW^2: a training-mode pass,
            then an eval-mode pass on the running statistics it left.
            The CPU runs take the card's side of every ReLU and of the
            stem pool (KinkPattern; the elements where their own choice
            differed reported).  The logits, the loss and the running
            statistics within RESNET_TOL of the CPU's fp32 run (cuDNN
            sums in other orders); a sample of gradients in both passes
            within RESNET_TOL of float64's, or RESNET_F64_FACTOR times
            the CPU fp32 run's own error.  Then eager training steps at
            b=RESNET_B, 224 x 224, with Momentum(0.9, weight_decay=1e-4):
            images/s, step seconds, peak memory; the loss goes through
            the CE kernels (the only ones launched: once a step each,
            gated), held against their plain versions on the step's
            logits within CE_TOL.
21. rnn     nn.LSTM(1024, 1024, num_layers=2) and nn.GRU at s=128, b=32:
            outputs, final states and the input's gradient on the card
            against the CPU within RNN_TOL relative; forward and
            backward timed.

22. losses  every loss functional of nn/functional/loss.py but the two
            kernel-routed ones, each reduction, flash_attn_unpadded and
            flash_attention
            (loss_cases(), the cases tests/test_torch_losses.py holds
            against the JAX package) on CUDA tensors against the same
            call on the CPU: values and input gradients within LOSS_TOL;
            each loss layer equal to its functional on the card.
23. hapi    paddle's Model.fit fed by io.DataLoader.  hapi_resnet50:
            Model(vision.models.resnet50()) in fp32, Momentum(0.1, 0.9,
            weight_decay=1e-4), nn.CrossEntropyLoss(), Accuracy(topk=(1,
            5)), HAPI_RESNET_TRAIN training and HAPI_RESNET_EVAL
            evaluation batches of RESNET_B seeded host images (224 x 224),
            fit(epochs=1, num_workers=2, LRScheduler, EarlyStopping,
            ModelCheckpoint), then evaluate, predict(stack_outputs=True),
            save / load and summary.  Gates: the pool's batches (workers
            from a fork server) bitwise equal to one process's; the first two fit
            losses within HAPI_RESNET_LOSS_TOL of the eager step's on the
            same weights and batches; the CE launches exact (forward: the
            train steps and every evaluated batch, backward: the train
            steps); Accuracy equal to a torch.topk count over predict's
            logits; the save / load round trip bitwise, weights and
            optimizer state; summary's count equal to the parameters'.
            hapi_gpt: GPT-2 medium (24 layers, bf16, b=8, s=1024,
            AdamW(multi_precision)) fitted on HAPI_GPT_BATCHES batches of
            the native token feed (write_token_file, TokenFileDataset
            shuffled, seed 0) through a user adapter giving (input_ids,
            labels) and DataLoader(batch_size=None).  Gates: every batch
            fit consumed bitwise equal to a numpy rebuild of the feed's
            windows; flash forward / dq / dk-dv 24 and the CE pair 1 a
            step; the losses within HAPI_GPT_LOSS_TOL of TrainStep's on
            the same weights and batches.  Each reports its step seconds
            beside the resnet50 and train_gpt phases' of the same run.
24. deploy  to_static -> jit.save (a torch.export program of the pure
            function, ptt:: ops as nodes) -> inference.create_predictor.
            kernels_deploy: the fp32 flash forward (3xTF32 on wgmma) at
            ERNIE's shape (b=8, s=1024, 12 heads, head_dim 64, unpadded)
            and at b=2 s=2048 16 / 4 heads head_dim 128 causal, against
            its plain version and float64 (TF32X3_F64_FACTOR), timed
            beside fp32 SDPA and its split pre-pass.  deploy_ernie:
            ERNIE-3.0-medium-zh (fp32) behind FasterTokenizer over a
            seeded 40000-entry vocab, saved at [None, 1024] and [None,
            128] (the loaded program holding no pad), run at
            batch 8 and 32 through the handles.  deploy_dit: DiT-XL/2
            (fp32, dynamic batch) at batch 8.  deploy_llama: Llama-3-8B
            width, 2 layers, bf16, at [1, 1024] through a PredictorPool
            of 2.  Gates: the predictor's outputs equal the eager port's
            (bitwise, or within 1e-6 of the largest); launches from the
            loaded program exact (ERNIE s=1024: flash 6; s=128 and DiT:
            none; Llama: QKV, MLP, flash 2 each); ERNIE row 0 within
            FLASH_TOL of the CPU's plain version; the pool's slots equal.
            Each artifact reports its trace, write and load seconds, its
            bytes, the predictor run's, the program's and the eager
            forward's device ms (CUDA events, median of DEPLOY_RUNS).
            deploy_dy2static: to_static functions exported on this torch:
            a traced `if` holds torch.cond; whether while_loop traces is
            recorded.

Every phase's wall seconds follow it on a line of their own
(``{"phase": "phase_s", "name": ..., "seconds": ...}``).  Then the
kernels line, the card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
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
TF32X3_FLOP_PER_S = 495e12 / 3   # fp32 products as three TF32 passes
D, DQ, DKV, F = 4096, 4096, 1024, 14336
EPS = 1e-5
# kernel vs plain version, (atol, rtol): fp32 differs by summation order
# only; bf16 outputs carry a final bf16 rounding (2^-8 relative) of fp32
# sums taken in another order, and bf16-rounded intermediates (xn, h)
TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (3e-2, 3e-2),
       torch.float16: (5e-4, 2 ** -10)}
# (fp16: AMP float16's kernels.  Kernel and plain version round fp32
# values that differ by summation order, so they differ by at most one
# fp16 step, 2^-10 of the value: rtol 2^-10 passes it at any magnitude.
# A bf16 rounding is up to 2^-9 of the value, twice that, and an
# intermediate at bf16 grade moves near-zero outputs past atol:
# kernel_amp_fp16's bf16 controls must fail the limit, FP16_CONTROL_MIN)
# the flash rows' bf16 limits, (atol, rtol).  Each output is a bf16
# rounding of an fp32 sum, so kernel and plain version may differ by one
# bf16 step, at most 2^-7 of the value; atol covers the P and dS
# roundings that the kernel's running max and summation order move.
# fwd and dq values are small (a causal row over n keys has |out| ~
# sqrt(e/n), 0.035 median at s=2048); dk and dv reach ~8.
FLASH_TOL = {"fwd": (4e-3, 2 ** -7), "dq": (4e-3, 2 ** -7),
             "dkv": (8e-3, 2 ** -7)}
# the same bounds in fp16, whose rounding step (2^-11 relative, P and dS
# rounded to fp16) is 2^-3 of bf16's
FLASH_TOL_FP16 = {k: (a / 8, r / 8) for k, (a, r) in FLASH_TOL.items()}
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
                 "rmsnorm_regs_kernel", "tf32x3_gemm_kernel",
                 "tf32_split_t_kernel", "tf32_split_kernel",
                 "flash_fwd_tf32x3", "flash_split_vt_kernel")
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


# the eager resnet50 and the train_gpt steps' medians in this run, read
# by the hapi phase
REF_STEP_S = {}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


@contextlib.contextmanager
def timed(name):
    """Print the block's wall seconds on a line of its own (a
    ``phase_s`` line naming it)."""
    t0 = time.perf_counter()
    yield
    emit("phase_s", name=name, seconds=time.perf_counter() - t0)


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


def fp32_rate(path):
    """The peak rate of an fp32 QKV / MLP / fused_ffn launch's products on
    `path`: the tensor cores' TF32 rate over three passes on ``tf32x3``,
    the CUDA cores' fp32 rate on the tile."""
    return TF32X3_FLOP_PER_S if path == "tf32x3" else FP32_FLOP_PER_S


def call_alloc_bytes(fn):
    """The most device memory `fn` held at once beyond what was allocated
    before it (its outputs and the buffers it allocated for the call),
    from the caching allocator's peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated() - base


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


def limit_share(got, ref, tol):
    """The largest share of its limit atol + rtol |ref| (`tol`) that an
    element of `got` takes against `ref`."""
    atol, rtol = tol
    g, r = got.float(), ref.float()
    return float(((g - r).abs() / (atol + rtol * r.abs())).max())


def bf16_grade(t):
    """`t` rounded to bf16 and back: its values at bf16's precision."""
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_controls(refs, mids):
    """Two bf16-grade controls of an fp16 row, as shares of TOL[float16]
    against the plain outputs `refs`: the outputs rounded to bf16
    ("output", an epilogue at bf16 grade) and `mids`, the plain version
    with its intermediate (xn, h) rounded to bf16 ("intermediate", a row
    pass or an h at bf16 grade).  The row's limit must reject both."""
    tol = TOL[torch.float16]
    return {"output": max(limit_share(bf16_grade(r), r, tol) for r in refs),
            "intermediate": max(limit_share(m, r, tol)
                                for m, r in zip(mids, refs))}


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
        if dtype == torch.float32:
            return check_close(what, got, ref, dtype)
        tol = FLASH_TOL if dtype == torch.bfloat16 else FLASH_TOL_FP16
        return check_close(what, got, ref, dtype, tol[row],
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
    """The three kernels timed in bf16 (or fp16, the tensors' dtype) at
    one shape beside their plain versions and
    F.scaled_dot_product_attention (forward; its autograd backward, dq,
    dk and dv together, for the two backward rows), with their bounds;
    and flash_delta, the reduction before every backward."""
    F_ = torch.nn.functional
    q, k, v, do, lse, delta = tensors
    tag = {torch.bfloat16: "bf16", torch.float16: "fp16"}[q.dtype]
    tols = FLASH_TOL if q.dtype == torch.bfloat16 else FLASH_TOL_FP16
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
        out[f"tolerance_{tag}"] = dict(zip(("atol", "rtol"), tols[row]))
        out[f"limit_used_{tag}"] = used[row]
        out["flops"] = flops
        out["shape"] = f"b={b} s={s} h={h} hk={hk} d={FD} causal {tag}"
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
        "shape": f"b={b} s={s} h={h} d={FD} {tag} -> fp32 [b, h, s]"}
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
                                             torch.bfloat16, ignored=40),
            # ResNet-50's training step (resnet50): b = 64, 1000 classes
            "fp32 T=64 V=1000": kernel_ce(CE, dev, timer, RESNET_B, 1000,
                                          torch.float32)}


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
    ref = FB.ffn_reference(x, w1, b1, w2, b2, act)
    err = check_close(what, got, ref, dtype, None, used)
    ctl = None
    if dtype == torch.float16:          # the control: h rounded to bf16
        hb = FB._act(act, x.float() @ w1.float() + b1.float()).to(
            torch.bfloat16).to(dtype)
        ctl = bf16_controls([ref], [(hb.float() @ w2.float()
                                     + b2.float()).to(dtype)])
        del hb
    del ref
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
        fp32_rate(path) if dtype == torch.float32 else BF16_FLOP_PER_S)
    out["max_abs_err"] = err
    out["tolerance"] = dict(zip(("atol", "rtol"), TOL[dtype]))
    out["limit_used"] = used[what]
    if ctl is not None:
        out["bf16_control_limit_used"] = ctl
    if path == "tf32x3":
        out["call_alloc_bytes"] = call_alloc_bytes(kernel)
    else:
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

# greedy tokens of the parity phases' drives (the CPU side decodes each
# through the full-width 2-layer model; the gate is the last chunk's
# logits, the tokens are reported)
PARITY_NEW = 2


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
    got, toks = drive(card, prompt, 256, PARITY_NEW)
    ref, ref_toks = drive(host, prompt, 256, PARITY_NEW)
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
        got, toks = drive(card, prompt, 256, PARITY_NEW, quant_kv=kvq)
        launched = {fn.__name__: fn.launches
                    for fn in kernels.SERVING + kernels.SERVING_QUANT}
        ref, ref_toks = drive(host, prompt, 256, PARITY_NEW,
                              quant_kv=kvq)
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
    got, toks = drive(card, prompt, 256, PARITY_NEW)
    launched = {fn.__name__: fn.launches
                for fn in kernels.SERVING + kernels.SERVING_QUANT}
    ref, ref_toks = drive(host, prompt, 256, PARITY_NEW)
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


# new tokens a request in a serving profile window (the profiler's event
# processing grows with the window)
PROFILE_NEW = 8


def profile(eng, cfg, rng, phase="profile"):
    """Where a serving window's time goes: 8 requests (64-token prompts,
    PROFILE_NEW new tokens) under torch.profiler; device time by kernel, the
    decode kernels' device ms per decode step, and the device's busy
    share of the window's wall time.  Run after the measured serve run,
    so profiling costs nothing there."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for _ in range(8):
        eng.add_request(rng.integers(0, cfg.vocab_size, 64),
                        max_new_tokens=PROFILE_NEW)
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
    res = dict(requests=8, prompt=64, new_tokens=PROFILE_NEW, wall_s=wall,
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
    REF_STEP_S["train_gpt"] = dt
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


def mt_adam_case(MT, dev, timer, params, g):
    """multi_tensor_adam over `params` (16-bit, with fp32 masters and
    moments; gradients of the parameters' dtype) against its plain
    version on the same inputs: the max error and whether every output
    is bitwise equal (the plain version runs a tensor at a time on
    copies, its results kept on the card, 27 GB beside the 31 GB of
    state, before the kernel's one launch updates the originals); then the
    kernel, the plain version and a PyTorch yardstick (torch._fused_adamw_
    on the fp32 masters with fp32 gradients, whose op order differs: a
    timing only) timed, and the bound (bytes: grad, moments and master
    read once, param, moments and master written once; with a master the
    kernel never reads the 16-bit param).  multi_tensor_ab.py times the
    update against another tree's (the first design's).  Returns (row,
    grads)."""
    dt = params[0].dtype
    n = sum(p.numel() for p in params)
    grads = [rand(g, p.shape, dt, dev, 0.01) for p in params]
    kw = dict(lr=torch.tensor(MT_LR, device=dev),
              step=torch.tensor(MT_STEP, dtype=torch.int32, device=dev),
              scale=torch.tensor(0.5, device=dev),
              keep=torch.tensor(True, device=dev), **MT_ARGS,
              weight_decays=[MT_WD] * len(params))
    masters = [p.float() for p in params]
    m = [rand(g, p.shape, torch.float32, dev, 1e-3) for p in params]
    v = [rand(g, p.shape, torch.float32, dev, 1e-3).square_() for p in params]
    state = (params, m, v, masters)

    def plain_update(ps, gs, ms_, vs, mast):
        for p, gg, mm, vv, ma in zip(ps, gs, ms_, vs, mast):
            MT.adam_reference(p, gg, mm, vv, ma, weight_decay=MT_WD,
                              **{k: x for k, x in kw.items()
                                 if k != "weight_decays"})

    # one update, then the plain version on copies of the updated state
    # and the kernel's second update: 27 GB of copies at a time
    n0 = MT.multi_tensor_adam.launches
    MT.multi_tensor_adam(params, grads, m, v, masters, **kw)
    plain = []
    for i in range(len(params)):
        one = [t[i].clone() for t in state]
        plain_update([one[0]], [grads[i]], [one[1]], [one[2]], [one[3]])
        plain.append(one)
    MT.multi_tensor_adam(params, grads, m, v, masters, **kw)
    if MT.multi_tensor_adam.launches != n0 + 2:
        raise AssertionError("multi_tensor_adam: not one launch a call")
    names = ("params", "moment1", "moment2", "master")
    err, bitwise = dict.fromkeys(names, 0.0), dict.fromkeys(names, True)
    for i, ref in enumerate(plain):
        for name, t, r in zip(names, (x[i] for x in state), ref):
            if torch.equal(t, r):         # the error of equal bits is 0
                continue
            bitwise[name] = False
            err[name] = max(err[name],
                            float((t.float() - r.float()).abs().max()))
    del plain
    for name in names:
        if not bitwise[name]:
            raise AssertionError(f"multi_tensor_adam {dt}: {name} differs "
                                 f"from its plain version (max abs err "
                                 f"{err[name]})")
    adam_bytes, adam_ops = adam_io(params, grads, masters)
    ms = timer(lambda: MT.multi_tensor_adam(params, grads, m, v, masters,
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
    tag = str(dt).replace("torch.", "")
    row = {"shape": f"{len(params)} tensors, {n} params: {tag} with fp32 "
                    f"master and moments, {tag} grads",
           "max_abs_err": err["params"], "errors": err, "bitwise": bitwise,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library": "torch._fused_adamw_ (fp32 masters, fp32 grads; other "
                      "op order)", "bound_ms": b, "bound_by": by,
           "bound_share": b / ms, "tb_per_s": adam_bytes / ms / 1e9}
    del masters, m, v, state
    torch.cuda.empty_cache()
    return row, grads


def kernel_multi_tensor(MT, dev, timer):
    """Both multi-tensor kernels on the Train model's parameter set (1.92
    B bf16 parameters with fp32 masters and moments, bf16 gradients):
    the update by mt_adam_case, then the norm against its plain version
    (the max error, two launches bitwise equal), timed beside it, a
    PyTorch yardstick (torch._foreach_norm in fp32, then the norm of
    those) and its bound (bytes: every gradient read once); the digest;
    then AMP float16's set (the same parameters in fp16, fp32 masters,
    fp16 gradients): the update again and the norm of the fp16
    gradients against its plain version."""
    cfg, model = train_model(dev)
    params = [p.detach() for p in model.parameters()]
    n = sum(p.numel() for p in params)
    g = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    rows["multi_tensor_adam"], grads = mt_adam_case(MT, dev, timer, params,
                                                    g)
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
    del grads
    torch.cuda.empty_cache()
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.half()
    params = [p.detach() for p in model.parameters()]
    row, grads = mt_adam_case(MT, dev, timer, params, g)
    rows["multi_tensor_adam_fp16"] = row
    norm, ref = MT.multi_tensor_norm(grads), MT.norm_reference(grads)
    rel = float((norm - ref).abs() / ref)
    if not rel <= MT_TOL["norm_rel"]:
        raise AssertionError(f"multi_tensor_norm fp16: {float(norm)} against "
                             f"{float(ref)} (rel {rel})")
    norm_bytes, norm_ops = norm_io(grads)
    b, by = bound_ms(norm_bytes, norm_ops, FP32_FLOP_PER_S)
    rows["multi_tensor_norm_fp16"] = {
        "shape": f"{len(params)} fp16 grads, {n} elements",
        "max_abs_err": float((norm - ref).abs()), "rel_err": rel,
        "ms": timer(lambda: MT.multi_tensor_norm(grads)),
        "plain_ms": timer(lambda: MT.norm_reference(grads), iters=3,
                          warmup=1),
        "library_ms": timer(lambda: torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=torch.float32)))),
        "bound_ms": b, "bound_by": by}
    del model, params, grads
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


def pinned_copies(tensors, into=None):
    """Host copies of `tensors` in pinned memory (`into`'s buffers reused
    when given): Train's 27 GB state crosses PCIe at its full rate, where
    pageable copies took ~40 s a graph phase."""
    if into is None:
        into = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
    for h, t in zip(into, tensors):
        h.copy_(t)
    return into


def same_bits(tensors, host):
    """Whether each tensor's bytes equal its host copy's (the copy brought
    to the tensor's device one tensor at a time)."""
    return all(torch.equal(t.reshape(-1).view(torch.uint8),
                           h.to(t.device).reshape(-1).view(torch.uint8))
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
    eager_state = pinned_copies(state_tensors(step))
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
    del ref
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
    before = pinned_copies(state_tensors(step), into=eager_state)
    nan_loss = float(step(batch))
    unchanged = same_bits(state_tensors(step), before)
    del before, eager_state
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
DRILL_STEPS, DRILL_KILL, DRILL_EVERY = 5, 4, 3


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
COLD_LAYERS = 2
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
# the fp32 kernels under O1: QKV's and the MLP's 3xTF32 design (the split
# pre-pass, QKV's row pass, the GEMMs) and the tile (gemm_tile.cuh's
# gemm_kernel<float>, which O1 at T > 16 no longer launches)
AMP_FP32_FAMILIES = ("tf32x3_gemm_kernel", "tf32_split_t_kernel",
                     "tf32_split_kernel", "qkv_rows_kernel", "gemm_kernel")
AMP_FAMILIES = AMP_FP32_FAMILIES + ("flash_fwd_hopper", "flash_dq_hopper",
                                    "flash_dkv_hopper", "adam_kernel")


@contextlib.contextmanager
def quiet():
    """Swallow what a block prints (the operator stats' table)."""
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        yield


def amp_stats_cpu(level, layers, dtype="bfloat16"):
    """The operator stats (op -> dtype -> calls) of the recipe's forward
    on the CPU: a tiny fp32 Llama of `layers` layers under
    auto_cast(level, dtype), decorated first at O2."""
    from paddle_tpu_torch import amp, seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=128, intermediate_size=256,
                           num_attention_heads=2, num_key_value_heads=1,
                           num_hidden_layers=layers)
    seed(0)
    model = LlamaForCausalLM(cfg, device="cpu")
    if level == "O2":
        amp.decorate(model, level="O2", dtype=dtype)
    ids = torch.randint(0, cfg.vocab_size, (2, 16))
    with quiet(), amp.debugging.collect_operator_stats() as s:
        with amp.auto_cast(level=level, dtype=dtype):
            model.loss(ids, ids)
    return s.dtypes


def amp_expected_stats(level, layers, dtype="bfloat16"):
    """A card step's stats from the CPU's at one and two layers: the
    per-layer ops times `layers` plus the rest."""
    one, two = amp_stats_cpu(level, 1, dtype), amp_stats_cpu(level, 2, dtype)
    out = {}
    for op in set(one) | set(two):
        for dt in set(one.get(op, {})) | set(two.get(op, {})):
            a, b = one.get(op, {}).get(dt, 0), two.get(op, {}).get(dt, 0)
            out.setdefault(op, {})[dt] = a - (b - a) + layers * (b - a)
    return out


def amp_steps(level, model, opt, scaler, batch, kernels, dtype="bfloat16",
              steps=None):
    """`steps` (AMP_STEPS) of the recipe at `dtype`: ``with auto_cast:
    loss = model.loss``, ``scaler.scale(loss).backward()``,
    ``scaler.step(opt)``, ``opt.clear_grad()``; the first under the
    operator stats.  Returns the losses, each step's seconds, the stats,
    the peak memory (GiB), the launches by wrapper and dtype, QKV's and
    the MLP's by design, and whether the scaler skipped each step."""
    from paddle_tpu_torch import amp
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, stats, skips = [], [], None, []
    for i in range(steps or AMP_STEPS):
        t0 = time.perf_counter()
        collect = amp.debugging.collect_operator_stats() if i == 0 \
            else contextlib.nullcontext()
        with quiet(), collect as s:
            with amp.auto_cast(level=level, dtype=dtype):
                loss = model.loss(batch["input_ids"], batch["labels"])
        scaler.scale(loss).backward()
        scaler.step(opt)
        skips.append(bool(scaler._found_inf))
        opt.clear_grad()
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            stats = s.dtypes
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {fn.__name__: dict(fn.launches_by_dtype)
                for fn in kernels.BY_DTYPE}
    paths = {fn.__name__: dict(fn.launches_by_path)
             for fn in (kernels.fused_rmsnorm_qkv, kernels.fused_mlp)}
    # the steps the scaler skipped (an overflow), which launch no update
    launches["skipped_steps"] = sum(skips)
    return losses, times, stats, peak, launches, paths, skips


def amp_step_median(phase, times, skips):
    """The median seconds of the steps after the first that the scaler
    did not skip (a skipped step launches no update and moves no
    parameter); raises unless at least two such steps were timed."""
    timed = [t for t, skip in zip(times[1:], skips[1:]) if not skip]
    if len(timed) < 2:
        raise AssertionError(f"{phase}: {len(timed)} timed steps that the "
                             f"scaler did not skip (skips {skips}), fewer "
                             "than 2")
    return float(np.median(timed))


def amp_gates(phase, level, losses, ref_loss, scaler, stats, launches,
              layers, paths, dtype="bfloat16", steps=None):
    """The phase's checks: finite losses and scale, the first loss
    within AMP_LOSS_TOL of its reference, the stats a CPU run predicts
    (white ops in `dtype`, black fp32), the launches by wrapper and
    dtype, exact (QKV and the MLP fp32 at O1, `dtype` at O2; flash
    `dtype` both; the update under its parameters' dtype, fp32 at O1),
    and QKV's and the MLP's by design, exact (3xTF32 at O1, wgmma at
    O2)."""
    steps = steps or AMP_STEPS
    if not (np.all(np.isfinite(losses)) and
            np.isfinite(scaler.get_loss_scaling())):
        raise AssertionError(f"{phase}: non-finite loss {losses} or scale "
                             f"{scaler.get_loss_scaling()}")
    rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    if rel > AMP_LOSS_TOL:
        raise AssertionError(f"{phase}: first loss {losses[0]} vs "
                             f"{ref_loss}: {rel:.3g} > {AMP_LOSS_TOL}")
    want = amp_expected_stats(level, layers, dtype)
    if stats != want:
        raise AssertionError(f"{phase}: operator stats {stats}, the CPU "
                             f"run predicts {want}")
    for op in ("linear", "scaled_dot_product_attention"):
        if set(stats.get(op, {})) != {dtype}:
            raise AssertionError(f"{phase}: white op {op} ran {stats}")
    if set(stats.get("rms_norm", {})) != {"float32"}:
        raise AssertionError(f"{phase}: black rms_norm ran {stats}")
    n = layers * steps
    # bf16 has fp32's range: no step may overflow; fp16 may skip a step
    # at the scaler's first scale (amp_step_median times only the steps
    # it did not skip, and wants two of them)
    if launches["skipped_steps"] >= (1 if dtype == "bfloat16" else steps):
        raise AssertionError(f"{phase}: the scaler skipped "
                             f"{launches['skipped_steps']} of {steps} steps")
    gemm = "float32" if level == "O1" else dtype
    want_l = {"fused_rmsnorm_qkv": {gemm: n}, "fused_mlp": {gemm: n},
              "fused_ffn": {}, "flash_attention_fwd": {dtype: n},
              "flash_attention_bwd_dq": {dtype: n},
              "flash_attention_bwd_dkv": {dtype: n},
              "multi_tensor_adam": {gemm: steps - launches["skipped_steps"]}
              if steps > launches["skipped_steps"] else {},
              "skipped_steps": launches["skipped_steps"]}
    if launches != want_l:
        raise AssertionError(f"{phase}: launches {launches}, expected "
                             f"{want_l}")
    design = "tf32x3" if level == "O1" else "wgmma"
    for name, got in paths.items():
        if got[design] != n or sum(got.values()) != n:
            raise AssertionError(f"{phase}: {name} launched {got}, expected "
                                 f"{n} on {design}")
    return rel


def amp_skip_check(model, opt, scaler, batch, phase="amp_o1", level="O1",
                   dtype="bfloat16"):
    """An inf written into one gradient: ``scaler.step`` must leave every
    parameter bitwise equal and multiply the scale by decr_ratio."""
    from paddle_tpu_torch import amp
    with amp.auto_cast(level=level, dtype=dtype):
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
        raise AssertionError(f"{phase}: the inf step changed parameters "
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
    losses, times, stats, peak, launches, paths, skips = amp_steps(
        "O1", model, opt, scaler, batch, kernels)
    rel = amp_gates("amp_o1", "O1", losses, ref32, scaler, stats, launches,
                    TRAIN_LAYERS, paths)
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
    fp32_ms = sum(prof["port_kernels"][f]["ms"] for f in AMP_FP32_FAMILIES)
    dt = amp_step_median("amp_o1", times, skips)
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
         launches_by_path=paths, fp32_kernels_ms=fp32_ms,
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
    losses, times, stats, peak, launches, paths, skips = amp_steps(
        "O2", model, opt, scaler, batch, kernels)
    rel = amp_gates("amp_o2", "O2", losses, ref_bf16, scaler, stats,
                    launches, TRAIN_LAYERS, paths)
    masters = all(opt._accumulators[id(p)]["_master"].dtype == torch.float32
                  for p in model.parameters())
    if not masters or any(p.dtype != torch.bfloat16
                          for p in model.parameters()):
        raise AssertionError("amp_o2: decorate left fp32 parameters or no "
                             "fp32 masters")
    dt = amp_step_median("amp_o2", times, skips)
    emit("amp_o2", level="O2", dtype="bfloat16", params=n_params,
         param_dtype="bfloat16", masters="float32", layers=TRAIN_LAYERS,
         batch=TRAIN_B, seq=TRAIN_S,
         recipe="decorate(O2) + auto_cast(O2) + GradScaler + AdamW",
         plain_bf16_forward_loss=ref_bf16, losses=losses,
         first_loss_rel_err=rel, loss_tol=AMP_LOSS_TOL,
         scale=scaler.get_loss_scaling(), step_s=times, step_s_median=dt,
         train_cell_step_s=TRAIN_STEP_REF_S, tokens_per_s=tokens / dt,
         mfu=flops_tok * tokens / dt / BF16_FLOP_PER_S, peak_mem_gb=peak,
         operator_stats=stats, launches_by_dtype=launches,
         launches_by_path=paths)
    out["amp_o2"] = launches
    del model, opt, scaler
    torch.cuda.empty_cache()
    out.update(amp_fp16_phases(dev, kernels, cfg, batch, flops_tok))
    return out


# the steps of each float16 level (the bf16 levels take AMP_STEPS)
AMP_FP16_STEPS = 3


def amp_fp16_phases(dev, kernels, cfg, batch, flops_tok):
    """The recipe at ``dtype="float16"`` on a fresh fp32 model from seed
    0 (amp_phases' config and batch).  amp_o1_fp16: auto_cast(O1, fp16)
    + GradScaler, AMP_FP16_STEPS steps, the first loss against the fp32
    forward, flash launched in fp16 and QKV / the MLP in fp32 (3xTF32),
    then the skip check (an inf gradient: no parameter moves, the scale
    halves).  amp_o2_fp16: decorate(O2, fp16) with a fresh AdamW (fp32
    masters), the same loop, its first loss against the plain fp16
    model's, QKV, the MLP, flash and the update launched in fp16, and
    the skip check again.  Returns each level's launches."""
    from paddle_tpu_torch import amp, seed
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    seed(0)
    model = LlamaForCausalLM(cfg, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = TRAIN_B * TRAIN_S
    out = {}
    with torch.no_grad():
        ref32 = float(model.loss(batch["input_ids"], batch["labels"]))
    for level in ("O1", "O2"):
        phase = f"amp_{level.lower()}_fp16"
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        if level == "O2":
            model, opt = amp.decorate(model, opt, level="O2",
                                      dtype="float16")
            with torch.no_grad():
                ref = float(model.loss(batch["input_ids"],
                                       batch["labels"]))
        else:
            ref = ref32
        scaler = amp.GradScaler()
        losses, times, stats, peak, launches, paths, skips = amp_steps(
            level, model, opt, scaler, batch, kernels, "float16",
            AMP_FP16_STEPS)
        rel = amp_gates(phase, level, losses, ref, scaler, stats, launches,
                        TRAIN_LAYERS, paths, "float16", AMP_FP16_STEPS)
        if level == "O2" and (any(p.dtype != torch.float16
                                  for p in model.parameters()) or
                              any(opt._accumulators[id(p)]["_master"].dtype
                                  != torch.float32
                                  for p in model.parameters())):
            raise AssertionError(f"{phase}: decorate left non-fp16 "
                                 "parameters or no fp32 masters")
        skip = amp_skip_check(model, opt, scaler, batch, phase, level,
                              "float16")
        dt = amp_step_median(phase, times, skips)
        emit(phase, level=level, dtype="float16", params=n_params,
             param_dtype="float32" if level == "O1" else "float16",
             masters=None if level == "O1" else "float32",
             layers=TRAIN_LAYERS, batch=TRAIN_B, seq=TRAIN_S,
             recipe=("auto_cast(O1, float16)" if level == "O1" else
                     "decorate(O2, float16) + auto_cast(O2, float16)")
             + " + GradScaler + AdamW",
             reference_loss=ref, reference=("fp32 forward" if level == "O1"
                                            else "plain fp16 forward"),
             losses=losses, first_loss_rel_err=rel, loss_tol=AMP_LOSS_TOL,
             scale=scaler.get_loss_scaling(), skip_check=skip,
             step_s=times, step_skipped=skips, step_s_median=dt,
             train_cell_step_s=TRAIN_STEP_REF_S, tokens_per_s=tokens / dt,
             mfu=flops_tok * tokens / dt / BF16_FLOP_PER_S,
             peak_mem_gb=peak, operator_stats=stats,
             launches_by_dtype=launches, launches_by_path=paths)
        out[phase] = launches
        del opt, scaler
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return out


def launched_path(fn, before):
    """The one design `fn` launched since its ``launches_by_path`` was
    `before` (raises unless exactly one launch was counted)."""
    moved = {k: v - before.get(k, 0) for k, v in fn.launches_by_path.items()
             if v != before.get(k, 0)}
    if list(moved.values()) != [1]:
        raise AssertionError(f"{fn.__name__}: launches by design moved by "
                             f"{moved}, expected one launch")
    return next(iter(moved))


def f64_errors(got, plain, ref64):
    """Largest abs errors of the kernel's and the plain version's outputs
    against the float64 ones, and their ratio (the kernel's over the
    plain's; the 3xTF32 rows must stay within FB.TF32X3_F64_FACTOR)."""
    torch.cuda.synchronize()
    e = max(float((g.double() - r).abs().max()) for g, r in zip(got, ref64))
    e32 = max(float((p.double() - r).abs().max())
              for p, r in zip(plain, ref64))
    return {"max_abs_err_f64": e, "plain_max_abs_err_f64": e32,
            "f64_ratio": e / e32}


def kernel_amp_fp32(FB, dev, timer, T=TRAIN_B * TRAIN_S):
    """The fp32 kernels that O1 puts on a user path: the QKV kernel's
    training variant and the MLP pair at the Train step's T (3xTF32 on
    wgmma), against their plain versions and against the
    same functions in float64 (within FB.TF32X3_F64_FACTOR of the plain
    version's own error), timed beside them and the fp32 library chain
    (F.rms_norm then the products; the MLP's three products), with the
    bound at the rate of the design each launched (``launches_by_path``;
    3xTF32: 165 TFLOP/s) and, beside it, the fp32 CUDA cores' (67, the
    tile's), and the memory a call allocates (its outputs and split
    operands); and fused_ffn's fp32 row (Transformer-base width at
    T = 8192)."""
    g = torch.Generator(device=dev).manual_seed(T + 19)
    dt = torch.float32
    F_ = torch.nn.functional
    x = rand(g, (T, D), dt, dev)
    wn = rand(g, (D,), dt, dev, 0.1) + 1
    s = (2.0 / (D + DQ)) ** 0.5
    wq, wk, wv = (rand(g, (D, n), dt, dev, s) for n in (DQ, DKV, DKV))
    n0 = dict(FB.fused_rmsnorm_qkv.launches_by_path)
    got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS, residuals=True)
    path = launched_path(FB.fused_rmsnorm_qkv, n0)
    ref = FB.qkv_reference(x, wn, wq, wk, wv, EPS, residuals=True)
    err = max(check_close(f"fused_rmsnorm_qkv train fp32 {n}", a, b_, dt)
              for n, a, b_ in zip(("q", "k", "v", "xn", "inv"), got, ref))
    xf = x.double()
    xn64 = (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + EPS)) \
        * wn.double()
    f64 = f64_errors(got[:3], ref[:3],
                     [xn64 @ w.double() for w in (wq, wk, wv)])
    del got, ref, xf, xn64

    def qkv_lib():
        xn = F_.rms_norm(x, (D,), wn, EPS)
        return xn @ wq, xn @ wk, xn @ wv
    qkv = {"ms": timer(lambda: FB.fused_rmsnorm_qkv(
        x, wn, wq, wk, wv, EPS, residuals=True), iters=5),
        "plain_ms": timer(lambda: FB.qkv_reference(
            x, wn, wq, wk, wv, EPS, residuals=True), iters=3, warmup=1),
        "library_ms": timer(qkv_lib, iters=5), "max_abs_err": err,
        "shape": f"T={T} d={D} dq={DQ} dkv={DKV} fp32",
        "kernel_path": path, **f64,
        "call_alloc_bytes": call_alloc_bytes(lambda: FB.fused_rmsnorm_qkv(
            x, wn, wq, wk, wv, EPS, residuals=True))}
    qkv["bound_ms"], qkv["bound_by"] = bound_ms(
        *qkv_io(T, item=4, train=True), fp32_rate(path))
    qkv["bound_ms_fp32_cores"], _ = bound_ms(
        *qkv_io(T, item=4, train=True), FP32_FLOP_PER_S)
    del wq, wk, wv
    s = (2.0 / (D + F)) ** 0.5
    wg, wu = rand(g, (D, F), dt, dev, s), rand(g, (D, F), dt, dev, s)
    wd = rand(g, (F, D), dt, dev, s)
    n0 = dict(FB.fused_mlp.launches_by_path)
    y = FB.fused_mlp(x, wg, wu, wd)
    mpath = launched_path(FB.fused_mlp, n0)
    plain = FB.mlp_reference(x, wg, wu, wd)
    err = check_close("fused_mlp fp32 T=8192", y, plain, dt)
    xf = x.double()
    g64 = xf @ wg.double()
    h64 = g64 * torch.sigmoid(g64) * (xf @ wu.double())
    del g64
    mf64 = f64_errors([y], [plain], [h64 @ wd.double()])
    del y, plain, xf, h64
    mlp = {"ms": timer(lambda: FB.fused_mlp(x, wg, wu, wd), iters=5),
           "plain_ms": timer(lambda: FB.mlp_reference(x, wg, wu, wd),
                             iters=3, warmup=1),
           "library_ms": timer(lambda: (F_.silu(x @ wg) * (x @ wu)) @ wd,
                               iters=5),
           "max_abs_err": err, "shape": f"T={T} d={D} f={F} fp32",
           "kernel_path": mpath, **mf64,
           "call_alloc_bytes": call_alloc_bytes(
               lambda: FB.fused_mlp(x, wg, wu, wd))}
    mlp["bound_ms"], mlp["bound_by"] = bound_ms(*mlp_io(T, item=4),
                                                fp32_rate(mpath))
    mlp["bound_ms_fp32_cores"], _ = bound_ms(*mlp_io(T, item=4),
                                             FP32_FLOP_PER_S)
    del x, wg, wu, wd
    ffn = kernel_ffn(FB, dev, timer, "relu", dt)
    ffn["bound_ms_fp32_cores"], _ = bound_ms(*ffn_io(T, 4, TD, TF_),
                                             FP32_FLOP_PER_S)
    gf = torch.Generator(device=dev).manual_seed(T + 23)
    x = rand(gf, (T, TD), dt, dev)
    w1, w2 = rand(gf, (TD, TF_), dt, dev, TD ** -0.5), \
        rand(gf, (TF_, TD), dt, dev, TF_ ** -0.5)
    b1, b2 = rand(gf, (TF_,), dt, dev, 0.1), rand(gf, (TD,), dt, dev, 0.1)
    x64, a, c, b, e = (t.double() for t in (x, w1, b1, w2, b2))
    ffn.update(f64_errors([FB.fused_ffn(x, w1, w2, b1, b2, "relu")],
                          [FB.ffn_reference(x, w1, b1, w2, b2, "relu")],
                          [torch.relu(x64 @ a + c) @ b + e]))
    return {"fused_rmsnorm_qkv_train_fp32": qkv, "fused_mlp_train_fp32": mlp,
            "fused_ffn_fp32": ffn}


def amp_fp32_gates(FB, rows):
    """kernel_amp_fp32's checks, once its rows are printed: each row on
    the 3xTF32 design, its error against float64 within
    FB.TF32X3_F64_FACTOR times the plain fp32 version's."""
    factor = FB.TF32X3_F64_FACTOR
    for name, row in rows.items():
        if row.get("kernel_path", row.get("path")) != "tf32x3":
            raise AssertionError(f"{name}: fp32 at T = 8192 not on the "
                                 f"3xTF32 design: {row}")
        if row["f64_ratio"] > factor:
            raise AssertionError(f"{name}: error against float64 "
                                 f"{row['max_abs_err_f64']}, over "
                                 f"{factor}x the plain fp32 version's "
                                 f"{row['plain_max_abs_err_f64']}")


# the overflow check's MLP: T rows, every 8th scaled so that h = silu(g) u
# passes fp16's 65504 in some elements: g, u ~ N(0, 100) there, |g u| >
# 6.55 sigma^2 for ~2e-4 of a row's elements (~100 of the scaled rows'),
# while y = h wd stays ~N(0, 8.7e3), far inside fp16 where h is finite
FP16_OVERFLOW_T, FP16_OVERFLOW_SCALE = 256, 150.0
# the least share of TOL[float16]'s limit that each bf16-grade control of
# an fp16 row must take: past 1, so the row would fail it
FP16_CONTROL_MIN = 1.0


def kernel_amp_fp16(FA, FB, dev, timer, T=TRAIN_B * TRAIN_S):
    """The kernels that AMP float16 reaches on the Train step, in fp16 at
    its shapes: flash forward, dq and dk/dv at b=4 s=2048 h=32 hk=8 d=128
    causal (flash_parity / flash_timed, within FLASH_TOL_FP16); QKV's
    training variant and the MLP at T = 8192, and fused_ffn's relu row
    (Transformer-base width), each on the wgmma design within
    TOL[float16], timed beside its plain version and the fp16 library
    chain (F.rms_norm and cuBLAS products; SDPA), bound at the fp16
    tensor-core rate (989 TFLOP/s); and the MLP at FP16_OVERFLOW_T rows
    whose h overflows: the kernel's non-finite outputs exactly where the
    plain version's are (nothing saturates), the rest within
    TOL[float16].  QKV, the MLP and fused_ffn record the share of
    TOL[float16]'s limit they take and that of two bf16-grade controls
    (bf16_controls), each of which must pass FP16_CONTROL_MIN."""
    h = torch.float16
    F_ = torch.nn.functional
    used = {}
    shape = (FB_, FS, FH, FHK)
    errs, tensors = flash_parity(FA, dev, h, *shape, used)
    rows = {k + "_fp16": r for k, r in
            flash_timed(FA, timer, tensors, shape, errs, used).items()}
    del tensors
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(T + 29)
    x = rand(g, (T, D), h, dev)
    wn = rand(g, (D,), h, dev, 0.1) + 1
    s = (2.0 / (D + DQ)) ** 0.5
    wq, wk, wv = (rand(g, (D, n), h, dev, s) for n in (DQ, DKV, DKV))
    n0 = dict(FB.fused_rmsnorm_qkv.launches_by_path)
    got = FB.fused_rmsnorm_qkv(x, wn, wq, wk, wv, EPS, residuals=True)
    path = launched_path(FB.fused_rmsnorm_qkv, n0)
    ref = FB.qkv_reference(x, wn, wq, wk, wv, EPS, residuals=True)
    what = "fused_rmsnorm_qkv train fp16 "
    err = max(check_close(what + n, a, b_,
                          torch.float32 if n == "inv" else h, None,
                          None if n == "inv" else used)
              for n, a, b_ in zip(("q", "k", "v", "xn", "inv"), got, ref))
    qkv_used = max(used.pop(what + n) for n in ("q", "k", "v", "xn"))
    # the control: xn rounded to bf16 before the products
    xn_b = ((x.float() * ref[4]) * wn.float()).to(torch.bfloat16).to(h)
    qkv_ctl = bf16_controls(ref[:4], [(xn_b.float() @ w.float()).to(h)
                                      for w in (wq, wk, wv)] + [xn_b])
    del got, ref, xn_b

    def qkv_lib():
        xn = F_.rms_norm(x, (D,), wn, EPS)
        return xn @ wq, xn @ wk, xn @ wv
    qkv = {"ms": timer(lambda: FB.fused_rmsnorm_qkv(
        x, wn, wq, wk, wv, EPS, residuals=True)),
        "plain_ms": timer(lambda: FB.qkv_reference(
            x, wn, wq, wk, wv, EPS, residuals=True), iters=3, warmup=1),
        "library_ms": timer(qkv_lib),
        "library": "F.rms_norm then three fp16 products (cuBLAS)",
        "max_abs_err": err, "tolerance": dict(zip(("atol", "rtol"), TOL[h])),
        "limit_used": qkv_used, "bf16_control_limit_used": qkv_ctl,
        "shape": f"T={T} d={D} dq={DQ} dkv={DKV} fp16", "kernel_path": path}
    qkv["bound_ms"], qkv["bound_by"] = bound_ms(*qkv_io(T, train=True))
    rows["fused_rmsnorm_qkv_train_fp16"] = qkv
    del wq, wk, wv
    s = (2.0 / (D + F)) ** 0.5
    wg, wu = rand(g, (D, F), h, dev, s), rand(g, (D, F), h, dev, s)
    wd = rand(g, (F, D), h, dev, s)
    n0 = dict(FB.fused_mlp.launches_by_path)
    y = FB.fused_mlp(x, wg, wu, wd)
    mpath = launched_path(FB.fused_mlp, n0)
    ref = FB.mlp_reference(x, wg, wu, wd)
    err = check_close("fused_mlp fp16 T=8192", y, ref, h, None, used)
    # the control: h rounded to bf16 before the down product
    gx, ux = x.float() @ wg.float(), x.float() @ wu.float()
    hb = (gx * torch.sigmoid(gx) * ux).to(torch.bfloat16).to(h)
    del gx, ux
    mlp_ctl = bf16_controls([ref], [(hb.float() @ wd.float()).to(h)])
    del y, ref, hb
    mlp = {"ms": timer(lambda: FB.fused_mlp(x, wg, wu, wd)),
           "plain_ms": timer(lambda: FB.mlp_reference(x, wg, wu, wd),
                             iters=3, warmup=1),
           "library_ms": timer(lambda: (F_.silu(x @ wg) * (x @ wu)) @ wd),
           "library": "silu(x @ wg) * (x @ wu) @ wd (cuBLAS, fp16)",
           "max_abs_err": err,
           "tolerance": dict(zip(("atol", "rtol"), TOL[h])),
           "limit_used": used.pop("fused_mlp fp16 T=8192"),
           "bf16_control_limit_used": mlp_ctl,
           "shape": f"T={T} d={D} f={F} fp16", "kernel_path": mpath}
    mlp["bound_ms"], mlp["bound_by"] = bound_ms(*mlp_io(T))
    rows["fused_mlp_train_fp16"] = mlp
    # the overflow: rows 0, 8, 16, ... of x scaled
    xo = x[:FP16_OVERFLOW_T].clone()
    xo[::8] *= FP16_OVERFLOW_SCALE
    got, ref = FB.fused_mlp(xo, wg, wu, wd), FB.mlp_reference(xo, wg, wu, wd)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(ref)
    if not bad.any() or not torch.equal(~torch.isfinite(got), bad):
        raise AssertionError(f"fused_mlp fp16 overflow: kernel non-finite "
                             f"{int((~torch.isfinite(got)).sum())}, plain "
                             f"{int(bad.sum())}, not the same elements")
    keep = ~bad.any(-1)
    mlp["overflow"] = {
        "rows": FP16_OVERFLOW_T, "scaled_rows": FP16_OVERFLOW_T // 8,
        "scale": FP16_OVERFLOW_SCALE, "nonfinite_rows": int((~keep).sum()),
        "nonfinite_same_elements": True,
        "max_abs_err_finite_rows": check_close(
            "fused_mlp fp16 overflow rows", got[keep], ref[keep], h)}
    del x, xo, wg, wu, wd, got, ref
    torch.cuda.empty_cache()
    rows["fused_ffn_fp16"] = kernel_ffn(FB, dev, timer, "relu", h)
    for name in ("fused_rmsnorm_qkv_train_fp16", "fused_mlp_train_fp16",
                 "fused_ffn_fp16"):
        if rows[name].get("kernel_path", rows[name].get("path")) != "wgmma":
            raise AssertionError(f"{name}: not on the wgmma design "
                                 f"{rows[name]}")
        ctl = rows[name]["bf16_control_limit_used"]
        if min(ctl.values()) <= FP16_CONTROL_MIN:
            raise AssertionError(f"{name}: TOL[float16] passes a bf16-grade "
                                 f"control (shares of its limit {ctl})")
    return rows


# -- phases 18-21: autograd, sparse embeddings, the conv side ---------------

SPARSE_STEPS = 4
SPARSE_SAVE_GB = 0.9        # the 1.05 GB dense gradient less the rows
                            # (decimal GB, 1e9 bytes)
SPARSE_GRAPH_LAYERS, SPARSE_GRAPH_STEPS = 2, 2
SPARSE_UNTOUCHED = 2048     # rows neither batch touches, watched too
SPARSE_STATE = ("_master", "moment1", "moment2")
# The lazy rule's fp32 state against a float64 reference of the rule on
# the coalesced gradient it took and its own previous state: the
# moments within SPARSE_MOMENT_TOL of their row's largest magnitude (a
# few fp32 roundings a step); the master within SPARSE_MASTER_ULPS
# units in its last place, plus lr * 2^-21 (Adam's update is ~1 at the
# first steps, and its fp32 roundings scale with lr).
SPARSE_MOMENT_TOL = 1e-6
SPARSE_MASTER_ULPS = 2
# The same state against the dense rule's (multi_tensor_adam, AdamW's
# kernel for a dense gradient): the dense run's after step 1 on the rows
# met once (the same bf16 gradient row in both runs; a row met k times
# sums k - 1 bf16 roundings apart, which Adam's first update g / (|g| +
# eps) amplifies where g nearly cancels), and the dense rule replayed
# on the sparse run's own gradients, densified, after every step on the
# rows every step touched.  The kernel forms 1 - beta^t from fp32 betas with powf
# (1 - beta2 is 1.3e-5 from 0.001, and powf's ulp near 1 is ~1.5e-5 of
# 1 - beta2^4), which moves its update by up to ~1.4e-5 of lr a step
# (|update| <= ~1): the master's unit here is t x (an ulp plus
# lr * 2^-15) after t steps, each step rounding the two masters apart
# by up to an ulp and the difference carried into the next.
SPARSE_DENSE_MOMENT_TOL = 1e-6
SPARSE_DENSE_MASTER_ULPS = 2
SPARSE_DENSE_STEP_REL = 2 ** -15


def _leaf(t, device):
    """A fresh leaf copy of `t` on `device` that requires grad (`to` of
    a tensor already there would return `t` itself)."""
    return t.detach().to(device).clone().requires_grad_(True)


def _scaled_err(got, ref):
    """The largest |got - ref| over the largest |ref| (fp32, on the
    host)."""
    g, r = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((g - r).abs().max() / r.abs().max().clamp_min(1e-30))


def _row_err(got, ref):
    """The largest, over rows, of a row's largest |got - ref| over its
    largest |ref| (float64)."""
    d = (got.double() - ref.double()).abs().amax(1)
    return float((d / ref.double().abs().amax(1).clamp_min(1e-300)).max()) \
        if len(d) else 0.0


def _ulp_err(got, ref, lr, rel=2 ** -21, steps=1):
    """The largest |got - ref| in units of `steps` times (got's last fp32
    place plus lr * rel) (float64)."""
    if not got.numel():
        return 0.0
    a = got.float().abs()
    ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()
    return float(((got.double() - ref.double()).abs()
                  / (steps * (ulp + lr * rel))).max())


def sparse_rule_bytes(rows, unique, d):
    """The lazy AdamW rule's least traffic: the raw bf16 rows read once
    (values and int64 indices), the touched rows of the fp32 moments and
    master read and written once, the bf16 weight rows written once."""
    return rows * (d * 2 + 8) + unique * d * (3 * 4 * 2 + 2)


def coalesce_check(g):
    """The port's coalesce and torch's (its bf16 ``coalesce()``) of the
    sparse COO gradient `g` against an fp32 sum of the same rows: the
    same unique rows, and each element within k - 1 bf16 roundings
    (2^-8 each) of the sum of its k values' magnitudes, so a row met
    once is exact.  Returns the unique rows and each side's largest
    share of its limit."""
    from paddle_tpu_torch.core.sparse_grad import RowSparseGrad
    rs = RowSparseGrad.of(g)
    uniq, k = torch.unique(rs.rows, return_counts=True)
    vals = rs.values.float()
    ref = RowSparseGrad(rs.rows, vals, rs.shape).coalesce().values
    mag = RowSparseGrad(rs.rows, vals.abs(), rs.shape).coalesce().values
    limit = ((k - 1)[:, None] * 2 ** -8 + 2 ** -22) * mag
    limit = limit.clamp_min(torch.finfo(torch.float32).tiny)
    out = {"unique_rows": int(uniq.shape[0]),
           "rows_met_more_than_once": int((k > 1).sum()),
           "most_occurrences": int(k.max())}
    for side, c in (("port", rs.coalesce()),
                    ("torch", RowSparseGrad.of(g.coalesce()))):
        if not torch.equal(c.rows, uniq):
            raise AssertionError(f"sparse_embed: {side} coalesce's rows "
                                 f"differ from the unique ids")
        out[f"{side}_share_of_limit"] = float(
            ((c.values.float() - ref).abs() / limit).max())
    return out


def sparse_run(model, opt, batches, init, kernels, sparse, watch):
    """SPARSE_STEPS eager steps of `model` from the weights `init` with a
    fresh `opt`, step i on batches[i % 2]: what the gates read (after
    each step, outside its time, the embedding's fp32 master and moments
    at the rows `watch` and the coalesced gradient the sparse rule took,
    on the host) and the sparse rule's timings."""
    from paddle_tpu_torch import autograd
    from paddle_tpu_torch.core.sparse_grad import RowSparseGrad
    emb = model.model.embed_tokens
    emb._sparse = sparse
    with torch.no_grad():
        for p, v in zip(model.parameters(), init):
            p.copy_(v)
    events, taken = [], []
    apply_sparse = opt._apply_sparse

    def timed(name, p, g, lr, step):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        g = g.coalesce()          # the rule's first op, timed with it
        apply_sparse(name, p, g, lr, step)
        e1.record()
        events.append((e0, e1))
        taken.append((g, lr, step, opt._decoupled_wd(name)))

    opt._apply_sparse = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = {"losses": [], "step_s": [], "states": [], "taken": []}
    out["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9
    for i in range(SPARSE_STEPS):
        batch = batches[i % len(batches)]
        t0 = time.perf_counter()
        loss = model.loss(batch["input_ids"], batch["labels"])
        autograd.backward(loss)
        if i == 0:
            torch.cuda.synchronize()
            out["allocated_after_backward_gb"] = \
                torch.cuda.memory_allocated() / 1e9     # decimal GB
            g = emb.weight.grad
            out["grad_layout"] = str(g.layout)
            if sparse:
                out["grad_rows"] = RowSparseGrad.of(g).nnz_rows
                out["coalesce"] = coalesce_check(g)
            del g
        opt.step()
        opt.clear_grad()
        out["losses"].append(float(loss.detach()))
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        st = opt._state_of(emb.weight)
        out["states"].append({k: st[k][watch].cpu() for k in SPARSE_STATE})
        if taken:
            g, lr, step, wd = taken.pop()
            out["taken"].append({"rows": g.rows.cpu(),
                                 "values": g.values.cpu(), "lr": float(lr),
                                 "step": int(step), "wd": float(wd)})
        if i == 0:
            out["after_step1"] = [p.detach().cpu()
                                  for p in model.parameters()]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launches"] = {fn.__name__: fn.launches
                       for fn in kernels.TRAINING + kernels.MULTI_TENSOR}
    out["launches_by_path"] = gemm_paths(kernels)
    out["rule_ms"] = [a.elapsed_time(b) for a, b in events]
    del opt._apply_sparse
    return out


def lazy_rule_errors(states, taken, start, betas, eps):
    """The sparse run's embedding state after each step (at the watched
    rows) against a float64 reference of the lazy AdamW rule from the
    step before's state (`start` before step 1) and the coalesced
    gradient the rule took.  Returns the moments' row errors, the
    master's in ulps, and whether every watched row the gradient did not
    touch kept its state bit for bit."""
    b1, b2 = betas
    errs = {"moment1": 0.0, "moment2": 0.0, "master_ulps": 0.0}
    untouched_kept = True
    prev = start
    for st, t in zip(states, taken):
        watch = start["rows"]
        pos = torch.searchsorted(watch, t["rows"])
        if not torch.equal(watch[pos], t["rows"]):
            raise AssertionError("sparse_embed: a gradient row outside the "
                                 "watched rows")
        hit = torch.zeros(len(watch), dtype=torch.bool)
        hit[pos] = True
        untouched_kept &= all(torch.equal(st[k][~hit], prev[k][~hit])
                              for k in SPARSE_STATE)
        g, s = t["values"].double(), t["step"]
        w = prev["_master"][pos].double()
        m = b1 * prev["moment1"][pos].double() + (1 - b1) * g
        v = b2 * prev["moment2"][pos].double() + (1 - b2) * g * g
        upd = (m / (1 - b1 ** s)) / ((v / (1 - b2 ** s)).sqrt() + eps)
        new = w - t["lr"] * (upd + t["wd"] * w)
        errs["moment1"] = max(errs["moment1"], _row_err(st["moment1"][pos],
                                                        m))
        errs["moment2"] = max(errs["moment2"], _row_err(st["moment2"][pos],
                                                        v))
        errs["master_ulps"] = max(errs["master_ulps"], _ulp_err(
            st["_master"][pos], new, t["lr"]))
        prev = st
    return errs, untouched_kept


def sparse_vs_dense(sp, dense, rows, lr, steps):
    """The sparse run's embedding state against the dense rule's at the
    watched rows selected by `rows` (a bool mask) after `steps` steps:
    moments' row errors, the master in SPARSE_DENSE units."""
    return {"moment1": _row_err(sp["moment1"][rows], dense["moment1"][rows]),
            "moment2": _row_err(sp["moment2"][rows], dense["moment2"][rows]),
            "master_ulps": _ulp_err(sp["_master"][rows],
                                    dense["_master"][rows], lr,
                                    SPARSE_DENSE_STEP_REL, steps)}


def dense_replay(weight, taken, watch):
    """AdamW's dense rule (multi_tensor_adam, as in the dense run) from
    the bf16 `weight` on the sparse run's coalesced gradients `taken`,
    each densified: the fp32 master and moments at the rows `watch`
    after each step (on the host)."""
    from paddle_tpu_torch.core.sparse_grad import RowSparseGrad
    from paddle_tpu_torch.optimizer import AdamW
    w = torch.nn.Parameter(weight.detach().clone())
    opt = AdamW(learning_rate=taken[0]["lr"], multi_precision=True,
                lazy_mode=True, parameters=[w])
    states = []
    for t in taken:
        w.grad = RowSparseGrad(t["rows"].to(w.device),
                               t["values"].to(w.device), tuple(w.shape),
                               coalesced=True).to_dense()
        opt.step()
        opt.clear_grad()
        st = opt._state_of(w)
        states.append({k: st[k][watch].cpu() for k in SPARSE_STATE})
    del opt, w
    torch.cuda.empty_cache()
    return states


def sparse_rule_launches(model, batch):
    """Device kernels one call of the sparse rule launches (a profiled
    extra step's rule on a scratch optimizer state)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import autograd
    from paddle_tpu_torch.core.sparse_grad import RowSparseGrad
    from paddle_tpu_torch.optimizer import AdamW
    emb = model.model.embed_tokens
    opt = AdamW(learning_rate=1e-4, multi_precision=True, lazy_mode=True,
                parameters=[emb.weight])
    autograd.backward(model.loss(batch["input_ids"], batch["labels"]))
    g = RowSparseGrad.of(emb.weight.grad)
    opt._state_of(emb.weight, "embed")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        opt._apply_sparse("embed", emb.weight, g, 1e-4, 1)
        torch.cuda.synchronize()
    model.clear_gradients()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    del opt
    return n


def sparse_graph(dev):
    """TrainStep.compile of a SPARSE_GRAPH_LAYERS-layer sparse_embed
    model runs the embedding dense inside its graph: its parameters after
    SPARSE_GRAPH_STEPS replays bitwise equal to the dense model's."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    ids = np.random.default_rng(1).integers(0, 128256, (TRAIN_B, TRAIN_S + 1))
    batch = {"input_ids": torch.as_tensor(ids[:, :-1]).to(dev),
             "labels": torch.as_tensor(ids[:, 1:]).to(dev)}
    host, losses = [], []
    for sparse in (True, False):
        cfg, model = train_model(dev, SPARSE_GRAPH_LAYERS)
        model.model.embed_tokens._sparse = sparse
        step = TrainStep(model, AdamW(learning_rate=1e-4,
                                      multi_precision=True))
        info = step.compile(batch)
        if not info.graph:
            raise AssertionError("sparse_embed: compile() captured no graph")
        losses.append([float(step(batch))
                       for _ in range(SPARSE_GRAPH_STEPS)])
        if any(p.grad is not None and p.grad.layout != torch.strided
               for p in model.parameters()):
            raise AssertionError("sparse_embed: a sparse gradient in the "
                                 "captured step")
        host.append([p.detach().cpu() for p in model.parameters()])
        del step, model
        torch.cuda.empty_cache()
    same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(*host))
    if not same or losses[0] != losses[1]:
        raise AssertionError(f"sparse_embed: the graphed sparse_embed "
                             f"model differs from the dense one: losses "
                             f"{losses}, parameters bitwise equal {same}")
    return {"layers": SPARSE_GRAPH_LAYERS, "replays": SPARSE_GRAPH_STEPS,
            "losses": losses[0], "bitwise_equal": same}


def sparse_embed(dev, kernels):
    """Phase 18 (see the module's docstring)."""
    from paddle_tpu_torch.optimizer import AdamW
    t0 = time.perf_counter()
    cfg, model = train_model(dev)
    build_s = time.perf_counter() - t0
    init = [p.detach().clone() for p in model.parameters()]
    V = cfg.vocab_size
    ids = np.random.default_rng(0).integers(0, V, (TRAIN_B, TRAIN_S + 1))
    ids_b = ids.copy()          # batch B: A with its last sequence new
    ids_b[-1] = np.random.default_rng(3).integers(0, V, TRAIN_S + 1)
    batches = [{"input_ids": torch.as_tensor(x[:, :-1]).to(dev),
                "labels": torch.as_tensor(x[:, 1:]).to(dev)}
               for x in (ids, ids_b)]
    count_a = np.bincount(ids[:, :-1].ravel(), minlength=V)
    count_b = np.bincount(ids_b[:, :-1].ravel(), minlength=V)
    free = np.flatnonzero((count_a == 0) & (count_b == 0))
    sample = np.random.default_rng(4).choice(free, SPARSE_UNTOUCHED,
                                             replace=False)
    watch = np.union1d(np.flatnonzero(count_a + count_b), sample)
    watch_t = torch.as_tensor(watch)
    ca, cb = count_a[watch], count_b[watch]
    names = [n for n, _ in model.named_parameters()]
    e = names.index("model.embed_tokens.weight")
    start = {"rows": watch_t,
             "_master": init[e][watch_t.to(dev)].float().cpu(),
             "moment1": torch.zeros(len(watch), cfg.hidden_size),
             "moment2": torch.zeros(len(watch), cfg.hidden_size)}
    runs = {}
    for sparse in (False, True):
        opt = AdamW(learning_rate=1e-4, multi_precision=True, lazy_mode=True,
                    parameters=model.parameters())
        betas, eps = (opt._beta1, opt._beta2), opt._eps
        runs[sparse] = sparse_run(model, opt, batches, init, kernels, sparse,
                                  watch_t.to(dev))
        del opt
        torch.cuda.empty_cache()
    dense, sp = runs[False], runs[True]
    n_rows = TRAIN_B * TRAIN_S
    save = dense["allocated_after_backward_gb"] - \
        sp["allocated_after_backward_gb"]
    mask = torch.zeros(V, dtype=torch.bool)
    mask[torch.as_tensor(np.flatnonzero(count_a))] = True
    w0 = init[e].cpu()
    untouched_same = torch.equal(sp["after_step1"][e][~mask], w0[~mask])
    other = max(
        check_close(f"sparse_embed {n}", sp["after_step1"][i].to(dev),
                    dense["after_step1"][i].to(dev), torch.bfloat16)
        for i, n in enumerate(names) if i != e)
    del w0
    lr = sp["taken"][0]["lr"]
    rule, untouched_kept = lazy_rule_errors(sp["states"], sp["taken"], start,
                                            betas, eps)
    replay = dense_replay(init[e], sp["taken"], watch_t.to(dev))
    s1, d1 = sp["states"][0], dense["states"][0]
    touched = torch.as_tensor(ca > 0)
    every = [touched] + [torch.as_tensor((ca > 0) & (cb > 0))] * (
        SPARSE_STEPS - 1)           # the rows every step so far touched
    vs_dense = {"dense_run_step1_rows_met_once": sparse_vs_dense(
        s1, d1, torch.as_tensor(ca == 1), lr, 1)}
    for i, (a, b) in enumerate(zip(sp["states"], replay)):
        vs_dense[f"replay_step{i + 1}_rows_every_step_touched"] = \
            sparse_vs_dense(a, b, every[i], lr, i + 1)
    # reported, not gated: the two runs' trajectories part after step 1
    # (a few bf16 embedding values round apart, so step 2's gradients
    # differ; the replay above shares the sparse run's)
    both = torch.as_tensor((ca == 1) & (cb == 1))
    dense_run_last = sparse_vs_dense(sp["states"][-1], dense["states"][-1],
                                     both, lr, SPARSE_STEPS)
    # rows of batch A that B lacks: step 2 leaves them alone in the
    # sparse run (lazy, checked above) and the dense rule decays their
    # moments; the dense run moves the master of rows no batch touches
    a_only = torch.as_tensor((ca > 0) & (cb == 0))
    none = torch.as_tensor((ca == 0) & (cb == 0))
    r2, r1 = replay[1]["moment1"][a_only], replay[0]["moment1"][a_only]
    dense_decays = {
        "replay_moment1_rows_a_only_step2_vs_b1_step1": _row_err(
            r2, betas[0] * r1.double()),
        "replay_moment1_rows_a_only_changed": not torch.equal(r2, r1),
        "dense_run_master_untouched_rows_moved": not torch.equal(
            d1["_master"][none], start["_master"][none])}
    del r2, r1, replay
    L = TRAIN_LAYERS * SPARSE_STEPS
    fails = []
    if dense["losses"][0] != sp["losses"][0]:
        fails.append(f"step-1 losses differ {dense['losses'][0]} vs "
                     f"{sp['losses'][0]}")
    if sp["grad_layout"] != "torch.sparse_coo" or sp["grad_rows"] != n_rows:
        fails.append(f"embedding grad {sp['grad_layout']} with "
                     f"{sp.get('grad_rows')} rows, expected {n_rows}")
    if dense["grad_layout"] != "torch.strided":
        fails.append(f"dense run's gradient {dense['grad_layout']}")
    co = sp["coalesce"]
    if not max(co["port_share_of_limit"], co["torch_share_of_limit"]) <= 1:
        fails.append(f"coalesce outside its bf16 limit: {co}")
    if co["unique_rows"] != int((count_a > 0).sum()):
        fails.append(f"coalesce kept {co['unique_rows']} rows")
    if save < SPARSE_SAVE_GB:
        fails.append(f"sparse run saves {save:.3f} GB after backward, "
                     f"expected >= {SPARSE_SAVE_GB}")
    if not untouched_same:
        fails.append("untouched embedding rows moved in the sparse run")
    if not untouched_kept:
        fails.append("the sparse rule changed the state of rows its "
                     "gradient did not touch")
    if not (rule["moment1"] <= SPARSE_MOMENT_TOL
            and rule["moment2"] <= SPARSE_MOMENT_TOL
            and rule["master_ulps"] <= SPARSE_MASTER_ULPS):
        fails.append(f"the lazy rule against its float64 reference {rule}")
    for k, errs in vs_dense.items():
        errs = errs if isinstance(errs, dict) else {"master_ulps": errs}
        if not (errs.get("moment1", 0) <= SPARSE_DENSE_MOMENT_TOL
                and errs.get("moment2", 0) <= SPARSE_DENSE_MOMENT_TOL
                and errs["master_ulps"] <= SPARSE_DENSE_MASTER_ULPS):
            fails.append(f"{k} against the dense rule {errs}")
    if not (dense_decays["replay_moment1_rows_a_only_changed"]
            and dense_decays["replay_moment1_rows_a_only_step2_vs_b1_step1"]
            <= SPARSE_MOMENT_TOL
            and dense_decays["dense_run_master_untouched_rows_moved"]):
        fails.append(f"the dense rule left untouched rows alone "
                     f"{dense_decays}: the comparison sees no lazy rule")
    ls = sp["losses"]
    if not (ls[2] < ls[0] and ls[3] < ls[1]):
        fails.append(f"sparse run's loss on a batch did not fall {ls}")
    got = sp["launches"]
    for name in ("fused_rmsnorm_qkv", "fused_mlp", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if got.get(name) != L:
            fails.append(f"{name} launched {got.get(name)}, expected {L}")
    if got["multi_tensor_adam"] != SPARSE_STEPS:
        fails.append(f"multi_tensor_adam launched "
                     f"{got['multi_tensor_adam']}, expected {SPARSE_STEPS}")
    for name in ("fused_rmsnorm_qkv", "fused_mlp"):
        paths = sp["launches_by_path"][name]
        if paths["wgmma"] != L or paths["tile"]:
            fails.append(f"{name} paths {paths}")
    if len(sp["rule_ms"]) != SPARSE_STEPS or dense["rule_ms"]:
        fails.append(f"sparse rule calls {len(sp['rule_ms'])} / dense "
                     f"{len(dense['rule_ms'])}")
    if fails:
        raise AssertionError("sparse_embed: " + "; ".join(fails))
    rule_launches = sparse_rule_launches(model, batches[0])
    d = cfg.hidden_size
    nbytes = sparse_rule_bytes(n_rows, co["unique_rows"], d)
    bound, by = bound_ms(nbytes, 0)
    rule_ms = float(np.median(sp["rule_ms"][1:]))
    del model, init
    torch.cuda.empty_cache()
    graph = sparse_graph(dev)
    result = {
        "layers": TRAIN_LAYERS, "dtype": cfg.dtype, "batch": TRAIN_B,
        "seq": TRAIN_S, "optimizer": "AdamW(lr=1e-4, multi_precision=True, "
        "lazy_mode=True)", "batches": "A, B, A, B (B: A with its last "
        "sequence new)", "model_build_s": build_s,
        "losses": {"dense": dense["losses"], "sparse": sp["losses"]},
        "step_s": {"dense": dense["step_s"], "sparse": sp["step_s"]},
        "step_s_median": {"dense": float(np.median(dense["step_s"][1:])),
                          "sparse": float(np.median(sp["step_s"][1:]))},
        "peak_gib": {"dense": dense["peak_gib"], "sparse": sp["peak_gib"]},
        "allocated_before_step1_gb": {
            "dense": dense["allocated_before_gb"],
            "sparse": sp["allocated_before_gb"]},
        "allocated_after_backward_gb": {
            "dense": dense["allocated_after_backward_gb"],
            "sparse": sp["allocated_after_backward_gb"]},
        "saved_gb": save, "grad_rows": sp["grad_rows"],
        "unique_rows": co["unique_rows"], "coalesce": co,
        "watched_rows": len(watch),
        "untouched_rows_bitwise_unchanged": untouched_same,
        "untouched_state_bitwise_kept": untouched_kept,
        "rule_vs_float64": rule, "rule_tol": {
            "moment": SPARSE_MOMENT_TOL, "master_ulps": SPARSE_MASTER_ULPS},
        "vs_dense": vs_dense, "vs_dense_tol": {
            "moment": SPARSE_DENSE_MOMENT_TOL,
            "master_ulps": SPARSE_DENSE_MASTER_ULPS,
            "master_step_rel": SPARSE_DENSE_STEP_REL},
        "dense_decays": dense_decays,
        f"dense_run_step{SPARSE_STEPS}_rows_met_once_in_each_batch":
            dense_run_last,
        "other_parameters_max_abs_err_vs_dense": other,
        "sparse_rule": {"ms": sp["rule_ms"], "ms_median": rule_ms,
                        "bound_ms": bound, "bound_by": by,
                        "bytes": nbytes, "launches_a_call": rule_launches,
                        "calls_a_step": 1},
        "launches": sp["launches"], "launches_by_path": {
            k: sp["launches_by_path"][k]
            for k in ("fused_rmsnorm_qkv", "fused_mlp")},
        "train_step_graph": graph}
    del runs, dense, sp, s1, d1
    emit("sparse_embed", **result)
    return result["launches"]


AUTOGRAD_TOL = 1e-4
AUTOGRAD_D, AUTOGRAD_B = 4096, 16


def autograd_phase(dev):
    """Phase 19: the autograd API on CUDA tensors against the CPU."""
    from paddle_tpu_torch import autograd, grad, nn
    cpu = torch.device("cpu")
    torch.manual_seed(0)
    errs = {}

    def close(what, got, ref):
        got = got if isinstance(got, (list, tuple)) else [got]
        ref = ref if isinstance(ref, (list, tuple)) else [ref]
        e = max(_scaled_err(g, r) for g, r in zip(got, ref))
        errs[what] = e
        if not e <= AUTOGRAD_TOL:
            raise AssertionError(f"autograd {what}: {e} of the largest "
                                 f"magnitude, limit {AUTOGRAD_TOL}")

    def mlp(device):
        m = nn.Sequential(nn.Linear(AUTOGRAD_D, AUTOGRAD_D, device=device),
                          nn.Tanh(),
                          nn.Linear(AUTOGRAD_D, 1, device=device))
        return m

    card, host = mlp(dev), mlp(cpu)
    host.set_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    x = torch.randn(AUTOGRAD_B, AUTOGRAD_D)
    outs = []
    t0 = time.perf_counter()
    for m, device in ((card, dev), (host, cpu)):
        xi = _leaf(x, device)
        (gx,) = grad(m(xi).sum(), xi, create_graph=True)
        penalty = (gx * gx).sum()
        gw = grad(penalty, [m[0].weight, m[2].weight])
        outs.append((gx, penalty, gw))
        if device == dev:
            torch.cuda.synchronize()
            penalty_s = time.perf_counter() - t0
    close("penalty_dx", outs[0][0], outs[1][0])
    close("penalty", outs[0][1], outs[1][1])
    close("penalty_dW", outs[0][2], outs[1][2])

    class Cube(autograd.PyLayer):
        @staticmethod
        def forward(ctx, v, k):
            ctx.save_for_backward(v)
            ctx.k = k
            return v * v * v * k

        @staticmethod
        def backward(ctx, gy):
            (v,) = ctx.saved_tensor
            return gy * 3 * v * v * ctx.k

    v0 = torch.randn(1024)
    res = []
    for device in (dev, cpu):
        v = _leaf(v0, device)
        (g1,) = grad(Cube.apply(v, 0.5).sum(), v, create_graph=True)
        (g2,) = grad(g1.sum(), v)
        res.append((g1, g2))
    close("pylayer_grad", res[0][0], res[1][0])
    close("pylayer_double_grad", res[0][1], res[1][1])

    A = torch.randn(6, 5)
    q = torch.randn(5, 5)
    q = q + q.T
    x5 = torch.randn(5)
    jh = []
    for device in (dev, cpu):
        xv = _leaf(x5, device)
        J = autograd.jacobian(torch.tanh(A.to(device) @ xv), xv)
        xb = _leaf(torch.randn(3, 4, generator=torch.Generator()
                               .manual_seed(1)), device)
        Jb = autograd.jacobian(torch.sin(xb) * xb, xb, batch_axis=0)
        H = autograd.hessian(0.5 * xv @ (q.to(device) @ xv)
                             + torch.sin(xv).sum(), xv)
        jh.append((J, Jb, H))
    close("jacobian", jh[0][0], jh[1][0])
    close("jacobian_batched", jh[0][1], jh[1][1])
    close("hessian", jh[0][2], jh[1][2])
    if tuple(jh[0][1].shape) != (3, 4, 4) or tuple(jh[0][2].shape) != (5, 5):
        raise AssertionError(f"autograd: shapes {jh[0][1].shape}, "
                             f"{jh[0][2].shape}")
    emit("autograd", d=AUTOGRAD_D, batch=AUTOGRAD_B,
         gradient_penalty_card_s=penalty_s, scaled_err=errs,
         tol=AUTOGRAD_TOL, matmul_allow_tf32=
         torch.backends.cuda.matmul.allow_tf32)


RESNET_TOL = 1e-3
RESNET_F64_FACTOR = 8       # the card's error against float64 over the
                            # CPU fp32 run's, where the latter exceeds TOL
# the parity batch: 16 images of 112 x 112, both BatchNorm modes.  The
# CPU runs take the card's side of every ReLU and of the stem pool
# (KinkPattern): left free, an input within rounding of a kink switches
# a whole gradient term, and fp32 runs land 2-16% from float64 in
# training mode (154 ReLUs switch at this batch) and up to 3e-3 in eval
# mode (one ReLU of the last block)
RESNET_PARITY_B, RESNET_PARITY_HW = 16, 112
RESNET_B, RESNET_STEPS = 64, 5
RESNET_GRADS = ("conv1.weight", "layer1.0.conv2.weight",
                "layer3.2.bn2.weight", "layer4.2.conv3.weight", "fc.weight",
                "fc.bias")
RESNET_STATS = ("bn1._mean", "bn1._variance", "layer4.2.bn3._mean",
                "layer4.2.bn3._variance")


def stat(m, name):
    """The buffer `name` (a state-dict name) of `m`."""
    return m.state_dict()[name]


def resnet_pass(m, x, y, device, dtype):
    """Logits, loss and RESNET_GRADS' gradients of one forward and
    backward of `m` (cleared first) on x, y."""
    from paddle_tpu_torch.nn import functional as F
    m.clear_gradients()
    logits = m(x.to(device, dtype))
    loss = F.cross_entropy(logits, y.to(device))
    loss.backward()
    params = dict(m.named_parameters())
    return {"logits": logits.detach(), "loss": loss.detach(),
            **{n: params[n].grad for n in RESNET_GRADS}}


class KinkPattern:
    """Which side of each kink the card's run took: the on/off of every
    ReLU (the stem's, read at bn1's output, and each residual block's,
    in call order) and the stem max-pool's chosen elements.  Recorded
    from the card's run and imposed on a CPU run, where each ReLU
    becomes a product with the recorded mask (the stem's: a value of
    the recorded sign with the input's gradient) and the pool a gather
    of the recorded elements: an input within rounding of a kink then
    cannot move a whole gradient term between the runs.  `flips` counts
    the elements where the CPU run's own choice differed."""

    def __init__(self):
        self.masks, self.i = [], 0
        self.flips = {"relu": 0, "pool": 0}
        self.stem = self.pool = None
        self.recording = True

    def _relu(self, x):
        from paddle_tpu_torch.nn import functional as F
        if self.recording:
            self.masks.append((x > 0).cpu())
            return F.relu(x)
        m = self.masks[self.i].to(x.device)
        self.i += 1
        self.flips["relu"] += int(((x > 0) != m).sum())
        return x * m.to(x.dtype)

    def _stem_relu(self, mod, args, out):
        if self.recording:
            self.stem = (out > 0).cpu()
            return None
        m = self.stem.to(out.device)
        self.flips["relu"] += int(((out > 0) != m).sum())
        a = out.detach().abs() + torch.finfo(out.dtype).tiny
        return out - out.detach() + torch.where(m, a, -a)

    def _max_pool(self, mod, args, out):
        x = args[0]
        if self.recording:     # ResNet's stem pool: 3 x 3, stride 2, pad 1
            v, idx = torch.nn.functional.max_pool2d(x, 3, 2, 1,
                                                    return_indices=True)
            if not torch.equal(v, out):
                raise AssertionError("resnet50: the stem pool is not a "
                                     "3 x 3 / 2 max-pool")
            self.pool = idx.cpu()
            return None
        got = x.flatten(2).gather(2, self.pool.to(x.device).flatten(
            2)).view_as(out)
        self.flips["pool"] += int((got != out).sum())
        return got

    @contextlib.contextmanager
    def on(self, model, recording):
        """`model`'s ReLUs and stem pool record (the card's run) or
        impose the pattern, for the block."""
        from paddle_tpu_torch.nn import functional as F
        blocks = [b for layer in (model.layer1, model.layer2, model.layer3,
                                  model.layer4) for b in layer]
        self.recording, self.i = recording, 0
        self.flips = {"relu": 0, "pool": 0}
        hooks = [model.bn1.register_forward_hook(self._stem_relu),
                 model.maxpool.register_forward_hook(self._max_pool)]
        for b in blocks:
            b._relu = self._relu
        try:
            yield
        finally:
            for h in hooks:
                h.remove()
            for b in blocks:
                b._relu = F.relu


def resnet_grads(runs, bad, tag):
    """RESNET_GRADS of the card (runs[0]) and the CPU's fp32 run
    (runs[1]) against float64 (runs[2]); an error over max(RESNET_TOL,
    RESNET_F64_FACTOR x the CPU's) goes into `bad`."""
    out = {}
    for n in RESNET_GRADS:
        card_e = _scaled_err(runs[0][n], runs[2][n])
        host_e = _scaled_err(runs[1][n], runs[2][n])
        limit = max(RESNET_TOL, RESNET_F64_FACTOR * host_e)
        out[n] = {"card_vs_f64": card_e, "cpu_fp32_vs_f64": host_e,
                  "limit": limit}
        if not card_e <= limit:
            bad[f"{tag} {n}"] = out[n]
    return out


def resnet_parity(dev):
    """ResNet-50 on the card, in fp32 on the CPU and in float64 on the
    CPU, from one state: a training-mode pass (BatchNorm on the batch's
    statistics, updating the running ones), then an eval-mode pass on
    the running statistics it left, the CPU runs taking the card's side
    of every ReLU and of the stem pool (KinkPattern).  The
    card's logits, loss and running statistics within RESNET_TOL of the
    CPU's fp32 ones (cuDNN sums in other orders), its gradients within
    resnet_grads' limit of float64's in both passes.  Returns the report
    and what failed."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.vision import models
    seed(0)
    cpu = torch.device("cpu")
    card = models.resnet50(device=dev)
    state = {k: v.cpu() for k, v in card.state_dict().items()}
    host = models.resnet50(device="cpu")
    host.set_state_dict(state)
    host64 = models.resnet50(device="cpu")
    host64.set_state_dict(state)
    host64.astype("float64")
    rng = np.random.default_rng(0)
    b, hw = RESNET_PARITY_B, RESNET_PARITY_HW
    x = torch.from_numpy(rng.standard_normal((b, 3, hw, hw)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 1000, b))
    runs = ((card, dev, torch.float32), (host, cpu, torch.float32),
            (host64, cpu, torch.float64))
    report, bad = {"batch": b, "image": hw}, {}
    for mode in ("train", "eval_after_train"):
        got, flips = [], {}
        pattern = KinkPattern()
        for (m, d, t), side in zip(runs, ("card", "cpu_fp32", "cpu_f64")):
            m.train(mode == "train")
            with pattern.on(m, recording=side == "card"):
                got.append(resnet_pass(m, x, y, d, t))
            if side != "card":
                flips[side] = pattern.flips
        errs = {k: _scaled_err(got[0][k], got[1][k])
                for k in ("logits", "loss")}
        if mode == "train":
            errs.update({k: _scaled_err(stat(runs[0][0], k),
                                        stat(runs[1][0], k))
                         for k in RESNET_STATS})
        bad.update({f"{mode} {k}": e for k, e in errs.items()
                    if not e <= RESNET_TOL})
        report[mode] = {"scaled_err_vs_cpu": errs,
                        "grads": resnet_grads(got, bad, mode),
                        "kinks_switched_against_the_card": flips}
        del got
    return card, report, bad


def resnet50_phase(dev, kernels):
    """Phase 20 (see the module's docstring)."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.kernels import cross_entropy as CE
    from paddle_tpu_torch.optimizer import Momentum
    card, parity, bad = resnet_parity(dev)
    if bad:
        raise AssertionError(f"resnet50: outside its limit: {bad}")
    n_params = sum(p.numel() for p in card.parameters())
    card.train()
    card.clear_gradients()
    opt = Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                   parameters=card.parameters())
    xb = torch.randn(RESNET_B, 3, 224, 224, device=dev)
    yb = torch.randint(0, 1000, (RESNET_B,), device=dev)

    def step():
        loss = F.cross_entropy(card(xb), yb)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    losses = [float(step().detach())]         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step().detach()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS
                if fn.launches}
    want = {"cross_entropy_fwd": RESNET_STEPS,
            "cross_entropy_bwd": RESNET_STEPS}
    if launches != want:
        raise AssertionError(f"resnet50: kernel launches {launches}, "
                             f"expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet50: non-finite loss {losses}")
    # the CE pair against its plain versions on the step's logits (these
    # launches come after the counts were read)
    with torch.no_grad():
        logits = card(xb)
    used = {}
    loss_k, lse = CE.cross_entropy_fwd(logits, yb)
    rloss, rlse = CE.ce_fwd_reference(logits, yb)
    cot = torch.full((RESNET_B,), 1.0 / RESNET_B, device=dev)
    ce_err = {
        "loss": check_close("resnet50 ce loss", loss_k, rloss, torch.float32,
                            CE_TOL["loss"], used),
        "lse": check_close("resnet50 ce lse", lse, rlse, torch.float32,
                           CE_TOL["lse"], used),
        "dx": check_close("resnet50 ce dx",
                          CE.cross_entropy_bwd(logits, yb, lse, cot),
                          CE.ce_bwd_reference(logits, yb, lse, cot),
                          torch.float32, CE_TOL["dx_fp32"], used)}
    dt = float(np.median(times))
    REF_STEP_S["resnet50"] = dt
    emit("resnet50", params=n_params, parity=parity, tol=RESNET_TOL,
         f64_factor=RESNET_F64_FACTOR, batch=RESNET_B, image=224,
         dtype="float32", optimizer="Momentum(lr=0.1, 0.9, "
         "weight_decay=1e-4)", step_s=times, step_s_median=dt,
         images_per_s=RESNET_B / dt, peak_gib=peak, losses=losses,
         launches=launches, ce_vs_plain={
             "shape": f"T={RESNET_B} V=1000 float32", "max_abs_err": ce_err,
             "share_of_limit": used},
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         cudnn_benchmark=torch.backends.cudnn.benchmark,
         cudnn_deterministic=torch.backends.cudnn.deterministic)
    del card, opt
    torch.cuda.empty_cache()
    return launches


RNN_TOL = 1e-4
RNN_H, RNN_S, RNN_B, RNN_ITERS = 1024, 128, 32, 3


def rnn_phase(dev):
    """Phase 21: LSTM and GRU on the card against the CPU, timed."""
    from paddle_tpu_torch import nn, seed
    out = {}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (RNN_B, RNN_S, RNN_H)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (RNN_B, RNN_S, RNN_H)).astype(np.float32))
    for name in ("LSTM", "GRU"):
        seed(0)
        card = getattr(nn, name)(RNN_H, RNN_H, num_layers=2, device=dev)
        host = getattr(nn, name)(RNN_H, RNN_H, num_layers=2, device="cpu")
        host.set_state_dict({k: v.cpu() for k, v in
                             card.state_dict().items()})
        res = {}
        for m, device, side in ((card, dev, "card"),
                                (host, torch.device("cpu"), "host")):
            xi = _leaf(x, device)
            o, finals = m(xi)
            (o * g.to(device)).sum().backward()
            last = finals[-1][0] if name == "LSTM" else finals[-1]
            res[side] = (o.detach(), last.detach(), xi.grad,
                         m.rnns[0].cell.weight_hh.grad)
        errs = {k: _scaled_err(a, b) for k, a, b in zip(
            ("out", "final_h", "dx", "dW_hh0"), res["card"], res["host"])}
        bad = {k: e for k, e in errs.items() if not e <= RNN_TOL}
        if bad:
            raise AssertionError(f"rnn {name}: outside {RNN_TOL} of the "
                                 f"largest magnitude: {bad}")
        xc, gc = _leaf(x, dev), g.to(dev)
        timer_f, timer_b = [], []
        for _ in range(RNN_ITERS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, _ = card(xc)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (o * gc).sum().backward()
            torch.cuda.synchronize()
            timer_f.append(t1 - t0)
            timer_b.append(time.perf_counter() - t1)
        out[name] = {"scaled_err": errs,
                     "forward_s": float(np.median(timer_f[1:])),
                     "backward_s": float(np.median(timer_b[1:])),
                     "tokens_per_s": RNN_B * RNN_S / float(
                         np.median(timer_f[1:]) + np.median(timer_b[1:]))}
        del card, host
    emit("rnn", hidden=RNN_H, layers=2, seq=RNN_S, batch=RNN_B,
         tol=RNN_TOL, loop="Python over the cell, the input projection "
         "of every step in one product", results=out)


# -- phase 22: the losses ----------------------------------------------------

# card against the CPU, fp32 values and input gradients: exp / log and the
# sums round differently on the card
LOSS_TOL = (1e-4, 1e-5)
LOSS_REDUCTIONS = ("mean", "sum", "none")


def loss_cases(seed=0):
    """``(id, functional name, numpy args, indices of the arguments whose
    gradient is compared, keyword arguments)``: every loss of
    ``nn/functional/loss.py`` but the kernel-routed two and
    ``flash_attn_unpadded``, at small shapes, with each reduction the
    function takes.  ``tests/test_torch_losses.py`` holds the same cases
    against the JAX package; the losses phase holds the card against the
    CPU.  Integer arrays are int64 (JAX takes them as int32)."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def u(*shape, lo=0.05, hi=0.95):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    def sign(*shape):
        return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(
            np.float32)

    def ints(hi, *shape):
        return rng.integers(0, hi, shape).astype(np.int64)

    def logp(*shape):
        x = f(*shape)
        return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32)

    def softmax(x, axis=-1):
        e = np.exp(x - x.max(axis, keepdims=True))
        return (e / e.sum(axis, keepdims=True)).astype(np.float32)

    x, y = f(6, 5), f(6, 5)
    lbl = ints(5, 6)
    lbl_ign = lbl.copy()
    lbl_ign[2] = -100
    cases = []
    for red in LOSS_REDUCTIONS:
        r = {"reduction": red}
        cases += [
            (f"mse_loss-{red}", "mse_loss", [x, y], [0, 1], r),
            (f"l1_loss-{red}", "l1_loss", [x, y], [0, 1], r),
            (f"smooth_l1_loss-{red}", "smooth_l1_loss", [x, y], [0, 1],
             {**r, "delta": 0.5}),
            (f"huber_loss-{red}", "huber_loss", [x, y], [0, 1],
             {**r, "delta": 0.7}),
            (f"nll_loss-{red}", "nll_loss", [logp(6, 5), lbl_ign], [0],
             {**r, "ignore_index": -100}),
            (f"nll_loss-weight-{red}", "nll_loss",
             [logp(6, 5), lbl_ign, u(5, lo=0.5, hi=2.0)], [0], r),
            (f"nll_loss-3d-{red}", "nll_loss", [logp(2, 5, 3), ints(5, 2, 3)],
             [0], r),
            (f"binary_cross_entropy-{red}", "binary_cross_entropy",
             [u(6, 5), (rng.random((6, 5)) < 0.5).astype(np.float32),
              u(6, 5, lo=0.5, hi=1.5)], [0], r),
            (f"binary_cross_entropy_with_logits-{red}",
             "binary_cross_entropy_with_logits",
             [x, u(6, 5, lo=0.0, hi=1.0)], [0], r),
            (f"binary_cross_entropy_with_logits-pos_weight-{red}",
             "binary_cross_entropy_with_logits",
             [x, u(6, 5, lo=0.0, hi=1.0), u(6, 5, lo=0.5, hi=1.5)], [0],
             {**r, "pos_weight": u(5, lo=0.5, hi=3.0)}),
            (f"kl_div-{red}", "kl_div", [logp(6, 5), softmax(y)], [0], r),
            (f"kl_div-log_target-{red}", "kl_div",
             [logp(6, 5), logp(6, 5)], [0, 1], {**r, "log_target": True}),
            (f"margin_ranking_loss-{red}", "margin_ranking_loss",
             [f(8), f(8), sign(8)], [0, 1], {**r, "margin": 0.1}),
            (f"hinge_embedding_loss-{red}", "hinge_embedding_loss",
             [f(8), sign(8)], [0], {**r, "margin": 0.8}),
            (f"cosine_embedding_loss-{red}", "cosine_embedding_loss",
             [f(6, 8), f(6, 8), np.where(sign(6) > 0, 1, -1)], [0, 1],
             {**r, "margin": 0.2}),
            (f"triplet_margin_loss-{red}", "triplet_margin_loss",
             [f(6, 8), f(6, 8), f(6, 8)], [0, 1, 2], r),
            (f"triplet_margin_loss-swap-p1-{red}", "triplet_margin_loss",
             [f(6, 8), f(6, 8), f(6, 8)], [0, 1, 2],
             {**r, "swap": True, "p": 1.0, "margin": 2.0}),
            (f"sigmoid_focal_loss-{red}", "sigmoid_focal_loss",
             [x, (rng.random((6, 5)) < 0.3).astype(np.float32)], [0], r),
            (f"poisson_nll_loss-{red}", "poisson_nll_loss",
             [f(6, 5, scale=0.5), rng.poisson(2.0, (6, 5)).astype(
                 np.float32)], [0], r),
            (f"poisson_nll_loss-full-{red}", "poisson_nll_loss",
             [u(6, 5, lo=0.5, hi=3.0), rng.poisson(2.0, (6, 5)).astype(
                 np.float32)], [0], {**r, "log_input": False, "full": True}),
            (f"gaussian_nll_loss-{red}", "gaussian_nll_loss",
             [x, y, u(6, 5, lo=0.2, hi=2.0)], [0, 1, 2], r),
            (f"gaussian_nll_loss-full-{red}", "gaussian_nll_loss",
             [x, y, u(6, 5, lo=0.2, hi=2.0)], [0, 2], {**r, "full": True}),
            (f"multi_margin_loss-{red}", "multi_margin_loss", [x, lbl], [0],
             r),
            (f"multi_margin_loss-p2-weight-{red}", "multi_margin_loss",
             [x, lbl], [0], {**r, "p": 2, "margin": 0.5,
                             "weight": u(5, lo=0.5, hi=2.0)}),
            (f"margin_cross_entropy-{red}", "margin_cross_entropy",
             [u(6, 5, lo=-0.9, hi=0.9), lbl], [0], r),
            (f"ctc_loss-{red}", "ctc_loss",
             [_ctc_logp(rng, 12, 2, 30), ints(29, 2, 4) + 1, np.array([12, 9]), np.array([4, 3])],
             [0], r),
        ]
    cases += [
        ("kl_div-batchmean", "kl_div", [logp(6, 5), softmax(y)], [0],
         {"reduction": "batchmean"}),
        ("softmax_with_cross_entropy", "softmax_with_cross_entropy",
         [x, lbl_ign[:, None]], [0], {}),
        ("softmax_with_cross_entropy-return_softmax",
         "softmax_with_cross_entropy", [x, lbl[:, None]], [0],
         {"return_softmax": True}),
        ("softmax_with_cross_entropy-soft", "softmax_with_cross_entropy",
         [x, softmax(y)], [0], {"soft_label": True}),
        ("softmax_with_cross_entropy-axis0", "softmax_with_cross_entropy",
         [f(5, 6), ints(5, 1, 6)], [0], {"axis": 0}),
        ("sigmoid_focal_loss-normalizer", "sigmoid_focal_loss",
         [x, (rng.random((6, 5)) < 0.3).astype(np.float32),
          np.array(4.0, np.float32)], [0], {"alpha": 0.4, "gamma": 1.5}),
        ("square_error_cost", "square_error_cost", [x, y], [0, 1], {}),
        ("log_loss", "log_loss", [u(6, 1), (rng.random((6, 1)) < 0.5)
                                  .astype(np.float32)], [0], {}),
        ("dice_loss", "dice_loss", [softmax(f(2, 4, 3)), ints(3, 2, 4, 1)],
         [0], {}),
        ("npair_loss", "npair_loss",
         [f(6, 8, scale=0.5), f(6, 8, scale=0.5),
          np.array([0, 1, 0, 2, 1, 3], np.float32)], [0, 1], {}),
        ("pairwise_distance", "pairwise_distance", [x, y], [0, 1], {}),
        ("pairwise_distance-p1-keepdim", "pairwise_distance", [x, y],
         [0, 1], {"p": 1.0, "keepdim": True}),
        ("pairwise_distance-inf", "pairwise_distance", [x, y], [0, 1],
         {"p": float("inf")}),
        ("pairwise_distance-neg_inf", "pairwise_distance", [x, y], [0, 1],
         {"p": float("-inf")}),
        ("margin_cross_entropy-return_softmax", "margin_cross_entropy",
         [u(6, 5, lo=-0.9, hi=0.9), lbl], [0],
         {"margin1": 0.9, "margin2": 0.3, "margin3": 0.1, "scale": 16.0,
          "return_softmax": True}),
    ]
    # JAX's CTC cases (tests/test_ctc_loss.py): full lengths, repeats,
    # and an infeasible alignment (more labels than frames) at ~1e30
    for T, b, K, L in ((16, 2, 97, 4), (25, 3, 40, 10), (12, 4, 30, 6),
                       (8, 2, 12, 3)):
        cases.append((f"ctc_loss-T{T}-L{L}", "ctc_loss",
                      [_ctc_logp(rng, T, b, K), ints(K - 2, b, L) + 1,
                       np.full((b,), T), np.full((b,), L)], [0],
                      {"reduction": "mean"}))
    cases += [
        ("ctc_loss-repeats", "ctc_loss",
         [_ctc_logp(rng, 12, 1, 10), np.array([[2, 2, 3, 3]]),
          np.array([12]), np.array([4])], [0], {"reduction": "sum"}),
        ("ctc_loss-infeasible", "ctc_loss",
         [_ctc_logp(rng, 3, 2, 10), np.array([[1, 2, 3, 4], [5, 6, 7, 8]]),
          np.array([3, 3]), np.array([4, 2])], [0], {"reduction": "none"}),
        ("ctc_loss-norm_by_times", "ctc_loss",
         [_ctc_logp(rng, 10, 2, 8), ints(7, 2, 3) + 1, np.array([10, 7]),
          np.array([3, 2])], [0], {"reduction": "mean",
                                   "norm_by_times": True}),
    ]
    # packed attention: 2 sequences of 3 + 4 queries over 5 + 6 keys
    cu_q, cu_k = np.array([0, 3, 7], np.int32), np.array([0, 5, 11], np.int32)
    qkv = [f(7, 2, 8), f(11, 2, 8), f(11, 2, 8)]
    same = [f(7, 2, 8), f(7, 2, 8), f(7, 2, 8)]
    for causal in (False, True):
        cases += [
            (f"flash_attn_unpadded-causal{int(causal)}",
             "flash_attn_unpadded", qkv + [cu_q, cu_k, 4, 6], [0, 1, 2],
             {"causal": causal, "return_softmax": True}),
            (f"flash_attn_unpadded-self-causal{int(causal)}",
             "flash_attn_unpadded", same + [cu_q, cu_q, 4, 4], [0, 1, 2],
             {"causal": causal, "scale": 0.3, "dropout": 0.0}),
        ]
    # paddle's flash_attention functional: (out, None) over [b, s, h, d]
    for causal in (False, True):
        cases.append((f"flash_attention-causal{int(causal)}",
                      "flash_attention", [f(2, 6, 2, 8), f(2, 6, 2, 8),
                                          f(2, 6, 2, 8)], [0, 1, 2],
                      {"causal": causal}))
    return cases


def loss_layer_cases(seed=1):
    """``(layer, constructor kwargs, functional name, numpy args,
    functional kwargs)``: each loss layer of ``nn/loss_layers.py`` against
    its functional on the same inputs (bitwise: one code path)."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, y = f(6, 5), f(6, 5)
    lbl = rng.integers(0, 5, 6)
    p = rng.uniform(0.05, 0.95, (6, 5)).astype(np.float32)
    t = (rng.random((6, 5)) < 0.5).astype(np.float32)
    sign = np.where(rng.random(8) < 0.5, -1.0, 1.0).astype(np.float32)
    logp = _ctc_logp(rng, 10, 2, 8)
    return [
        ("CrossEntropyLoss", {"reduction": "sum"}, "cross_entropy",
         [x, lbl], {"reduction": "sum"}),
        ("MSELoss", {"reduction": "sum"}, "mse_loss", [x, y],
         {"reduction": "sum"}),
        ("L1Loss", {}, "l1_loss", [x, y], {}),
        ("NLLLoss", {"ignore_index": 1, "reduction": "none"}, "nll_loss",
         [np.log(p), lbl], {"ignore_index": 1, "reduction": "none"}),
        ("BCELoss", {"reduction": "sum"}, "binary_cross_entropy", [p, t],
         {"reduction": "sum"}),
        ("BCEWithLogitsLoss", {"reduction": "none"},
         "binary_cross_entropy_with_logits", [x, t], {"reduction": "none"}),
        ("KLDivLoss", {"reduction": "batchmean"}, "kl_div", [np.log(p), p],
         {"reduction": "batchmean"}),
        ("SmoothL1Loss", {"delta": 0.5}, "smooth_l1_loss", [x, y],
         {"delta": 0.5}),
        ("MarginRankingLoss", {"margin": 0.3}, "margin_ranking_loss",
         [f(8), f(8), sign], {"margin": 0.3}),
        ("HingeEmbeddingLoss", {"margin": 0.5}, "hinge_embedding_loss",
         [f(8), sign], {"margin": 0.5}),
        ("CosineEmbeddingLoss", {"margin": 0.1}, "cosine_embedding_loss",
         [f(8, 4), f(8, 4), sign], {"margin": 0.1}),
        ("TripletMarginLoss", {"swap": True}, "triplet_margin_loss",
         [f(6, 4), f(6, 4), f(6, 4)], {"swap": True}),
        ("CTCLoss", {"blank": 0, "reduction": "sum"}, "ctc_loss",
         [logp, rng.integers(1, 8, (2, 3)), np.array([10, 8]),
          np.array([3, 2])], {"blank": 0, "reduction": "sum"}),
    ]


def _ctc_logp(rng, T, b, K):
    raw = rng.standard_normal((T, b, K)).astype(np.float32)
    return (raw - np.log(np.exp(raw).sum(-1, keepdims=True))).astype(
        np.float32)


def loss_cot(shape, seed=5):
    """The cotangent of a loss case's first output."""
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def loss_run(name, args, diff, kw, device):
    """A loss case through the port on `device`: its float outputs and
    the gradients of ``sum(out[0] * cot)`` in the `diff` arguments, as
    CPU tensors."""
    from paddle_tpu_torch.nn import functional as F
    ts = [torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
          else a for a in args]
    for i in diff:
        ts[i] = ts[i].clone().requires_grad_(True)
    tkw = {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
           else v for k, v in kw.items()}
    out = getattr(F, name)(*ts, **tkw)
    outs = out if isinstance(out, tuple) else (out,)
    cot = torch.from_numpy(loss_cot(tuple(outs[0].shape))).to(device)
    grads = torch.autograd.grad((outs[0] * cot).sum(),
                                [ts[i] for i in diff]) if diff else ()
    return ([o.detach().cpu() for o in outs if o is not None],
            [g.cpu() for g in grads])


def losses_phase(dev):
    """Phase 22: every loss case and layer on CUDA tensors against the
    port's CPU run on the same inputs."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    cpu = torch.device("cpu")
    rtol, atol = LOSS_TOL
    worst, bad, n_grads = {}, {}, 0
    for cid, name, args, diff, kw in loss_cases():
        card = loss_run(name, args, diff, kw, dev)
        host = loss_run(name, args, diff, kw, cpu)
        for what, got, ref in (("out", card[0], host[0]),
                               ("grad", card[1], host[1])):
            for i, (g, r) in enumerate(zip(got, ref)):
                if g.shape != r.shape or not torch.allclose(
                        g, r, rtol=rtol, atol=atol, equal_nan=True):
                    bad[f"{cid} {what}{i}"] = float((g - r).abs().max()) \
                        if g.shape == r.shape else "shape"
                    continue
                scale = float(r.abs().max()) or 1.0
                worst[name] = max(worst.get(name, 0.0),
                                  float((g - r).abs().max()) / scale)
            n_grads += len(got) if what == "grad" else 0
    layers = 0
    for layer, ckw, name, args, fkw in loss_layer_cases():
        ts = [torch.from_numpy(a).to(dev) for a in args]
        got = getattr(nn, layer)(**ckw)(*ts)
        if not torch.equal(got, getattr(F, name)(*ts, **fkw)):
            bad[f"layer {layer}"] = "differs from its functional"
        layers += 1
    if bad:
        raise AssertionError(f"losses: outside {LOSS_TOL} of the CPU: "
                             f"{bad}")
    emit("losses", cases=len(loss_cases()), layers=layers,
         gradients=n_grads, tol={"rtol": rtol, "atol": atol},
         worst_scaled_err=worst)


# -- phase 23: hapi (Model.fit over io.DataLoader) ---------------------------

_M64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _permute_index(i, n, seed):
    """``csrc/datafeed/datafeed.cpp``'s ``permute_index``: a 4-round
    Feistel bijection over [0, n), cycle-walked back into range."""
    if n <= 1:
        return 0
    half = ((n - 1).bit_length() + 1) // 2
    mask = (1 << half) - 1
    x = i
    while True:
        lo, hi = x & mask, x >> half
        for rnd in range(4):
            lo, hi = hi, lo ^ (_splitmix64((hi + seed + rnd) & _M64) & mask)
        x = (hi << half) | lo
        if x < n:
            return x


def datafeed_windows(tokens, seq_len, batch, seed, shuffle, n_batches,
                     epoch=0):
    """The ``[batch, seq_len + 1]`` windows of the token feed's first
    `n_batches` batches of `epoch`, rebuilt in numpy from the flat token
    array (windows of seq_len + 1 tokens, batch b holding windows b *
    batch .. b * batch + batch - 1, each through the shuffle of (seed +
    epoch))."""
    w = seq_len + 1
    n_windows = len(tokens) // w
    out = []
    for b in range(n_batches):
        rows = []
        for s in range(batch):
            idx = b * batch + s
            if shuffle:
                idx = _permute_index(idx, n_windows, seed + epoch)
            rows.append(tokens[idx * w:(idx + 1) * w])
        out.append(np.stack(rows))
    return out


def lm_pairs(feed, record=None):
    """The user adapter of hapi's LM path: an iterable dataset over the
    token feed's dict batches yielding ``(input_ids, labels)``, since
    ``Model`` gives a dict batch no labels; each pair is appended to
    `record` when one is given."""
    from paddle_tpu_torch.io import IterableDataset

    class LMPairs(IterableDataset):
        def __iter__(self):
            for b in feed:
                pair = (b["input_ids"], b["labels"])
                if record is not None:
                    record.append(pair)
                yield pair
    return LMPairs()


class SeededImages:
    """A map-style dataset of `n` host images (`channels` x `hw` x `hw`
    fp32) and labels over `classes`, each made from its own seed when
    asked for: the object pickles small, as a worker process receives
    it."""

    def __init__(self, n, seed, hw=224, classes=1000, channels=3):
        self.n, self.seed, self.hw, self.classes = n, seed, hw, classes
        self.channels = channels

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        img = rng.standard_normal((self.channels, self.hw, self.hw),
                                  dtype=np.float32)
        return img, np.int64(rng.integers(0, self.classes))

    def __len__(self):
        return self.n


class SlowItems:
    """A dataset whose item `slow` takes `sleep_s` seconds (a stuck
    worker, for the loader's timeout)."""

    def __init__(self, n, slow, sleep_s):
        self.n, self.slow, self.sleep_s = n, slow, sleep_s

    def __getitem__(self, i):
        if i == self.slow:
            time.sleep(self.sleep_s)
        return np.full((4,), i, np.int64)

    def __len__(self):
        return self.n


def loss_log():
    """A hapi callback recording each train batch's loss."""
    from paddle_tpu_torch.hapi import Callback

    class LossLog(Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
    return LossLog()


HAPI_RESNET_TRAIN, HAPI_RESNET_EVAL = 6, 2      # batches of RESNET_B
HAPI_RESNET_LOSS_TOL = 1e-4     # TrainStep vs eager step, relative
HAPI_GPT_BATCHES = 10
HAPI_GPT_LOSS_TOL = 1e-3        # Model.fit vs TrainStep, bf16, relative


def _bitwise(what, a, b):
    """Raise unless two (nested) batches are bitwise equal."""
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: structure differs")
        for x, y in zip(a, b):
            _bitwise(what, x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape or \
            a.tobytes() != b.tobytes():
        raise AssertionError(f"{what}: batches differ")


def _launches(kernels):
    return {fn.__name__: fn.launches for fn in kernels.KERNELS
            if fn.launches}


def hapi_resnet(dev, kernels, tmp):
    """hapi-ResNet-50 (module docstring, 23)."""
    import io as _io
    from paddle_tpu_torch import Model, metric, nn, seed
    from paddle_tpu_torch import summary as pt_summary
    from paddle_tpu_torch.hapi import EarlyStopping, LRScheduler, \
        ModelCheckpoint
    from paddle_tpu_torch.io import DataLoader, default_collate_fn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision import models
    B = RESNET_B
    train = SeededImages(HAPI_RESNET_TRAIN * B, 1)
    evald = SeededImages(HAPI_RESNET_EVAL * B, 2)

    # the worker pool's batches against one process's, bitwise (forkserver
    # workers, after this process initialised CUDA)
    t0 = time.perf_counter()
    single = []
    for batch in DataLoader(train, batch_size=B, num_workers=0):
        single.append(batch)
    single_s = time.perf_counter() - t0
    pool = DataLoader(train, batch_size=B, num_workers=2)
    t0 = time.perf_counter()
    pooled = list(pool)
    pooled_s = time.perf_counter() - t0
    pool.close()
    if len(pooled) != len(single) != HAPI_RESNET_TRAIN:
        raise AssertionError("hapi resnet50: batch counts differ")
    for a, b in zip(pooled, single):
        _bitwise("hapi resnet50 workers", a, b)
    samples = [train[i] for i in range(B)]
    t0 = time.perf_counter()
    default_collate_fn(samples)
    collate_s = time.perf_counter() - t0

    def optimizer(net):
        return Momentum(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                        parameters=net.parameters())

    seed(0)
    net = models.resnet50(device=dev)
    init = {k: v.detach().clone() for k, v in net.state_dict().items()}
    model = Model(net)
    model.prepare(optimizer(net), nn.CrossEntropyLoss(),
                  metric.Accuracy(topk=(1, 5)))
    log = loss_log()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    hist = model.fit(train, evald, batch_size=B, epochs=1, shuffle=False,
                     num_workers=2, verbose=0,
                     callbacks=[LRScheduler(), EarlyStopping(),
                                ModelCheckpoint(save_dir=str(tmp)), log])
    fit_s = time.perf_counter() - t0
    logs = model.evaluate(evald, batch_size=B, verbose=0)
    launches = _launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = model.last_fit_stats
    n_train, n_eval = HAPI_RESNET_TRAIN, 2 * HAPI_RESNET_EVAL
    want = {"cross_entropy_fwd": n_train + n_eval,
            "cross_entropy_bwd": n_train, "multi_tensor_norm": n_train}
    if launches != want:
        raise AssertionError(f"hapi resnet50: launches {launches}, "
                             f"expected {want}")
    if model._train_step._device.type != "cuda":
        raise AssertionError("hapi resnet50: the step is not on the card")
    files = sorted(os.listdir(tmp))
    if files != ["0.pdopt", "0.pdparams", "final.pdopt", "final.pdparams"]:
        raise AssertionError(f"hapi resnet50: checkpoint files {files}")

    # Accuracy against a torch.topk count over the same logits
    logits = torch.from_numpy(model.predict(evald, batch_size=B,
                                            stack_outputs=True)).to(dev)
    labels = torch.as_tensor([evald[i][1] for i in range(len(evald))],
                             device=dev)
    top = torch.topk(logits, 5, dim=1).indices == labels[:, None]
    counted = [float(top[:, :k].any(1).float().mean()) for k in (1, 5)]
    if [logs["acc_top1"], logs["acc_top5"]] != counted:
        raise AssertionError(f"hapi resnet50: accuracy {logs} against the "
                             f"topk count {counted}")

    # save -> load into a fresh model: weights and optimizer state bitwise
    model.save(str(tmp / "round"))
    seed(1)
    net2 = models.resnet50(device=dev)
    model2 = Model(net2)
    model2.prepare(optimizer(net2), nn.CrossEntropyLoss())
    model2.load(str(tmp / "round"))
    for (k, a), b in zip(net.state_dict().items(),
                         net2.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"hapi resnet50: {k} after save / load")
    s1, s2 = model._train_step.state_dict(), model2._train_step.state_dict()
    if s1["step"] != s2["step"] or any(
            np.asarray(v).tobytes() != np.asarray(
                s2["opt_state"][n][k]).tobytes()
            for n, st in s1["opt_state"].items() for k, v in st.items()):
        raise AssertionError("hapi resnet50: optimizer state after "
                             "save / load")
    del model2, net2, s1, s2
    with contextlib.redirect_stdout(_io.StringIO()):
        info = model.summary(input_size=(1, 3, 224, 224))
        shape = pt_summary(net, (1, 3, 224, 224))["output_shape"]
    n_params = sum(p.numel() for p in net.parameters())
    if info["total_params"] != n_params or shape != (1, 1000):
        raise AssertionError(f"hapi resnet50: summary {info}, {shape}; "
                             f"{n_params} parameters")

    # the first two losses against the eager step on the same weights and
    # batches (the resnet50 phase's loop)
    net.set_state_dict(init)
    net.train()
    opt = optimizer(net)
    eager = []
    for x, y in single[:2]:
        loss = F.cross_entropy(net(torch.from_numpy(x).to(dev)),
                               torch.from_numpy(y).to(dev))
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(float(loss.detach()))
    fit_losses = log.losses[:2]
    rel = [abs(a - b) / abs(b) for a, b in zip(fit_losses, eager)]
    if not max(rel) <= HAPI_RESNET_LOSS_TOL:
        raise AssertionError(f"hapi resnet50: fit losses {fit_losses} vs "
                             f"eager {eager}")
    loop = [a + b + c for a, b, c in zip(stats["data_s"], stats["h2d_s"],
                                         stats["step_s"])]
    dt = float(np.median(loop[1:]))           # the first: pool start-up
    eager_s = REF_STEP_S.get("resnet50")
    emit("hapi_resnet50", batch=B, train_batches=n_train,
         eval_batches=HAPI_RESNET_EVAL, num_workers=2,
         worker_start="forkserver", fit_s=fit_s, history=hist,
         losses=log.losses, eager_losses=eager, loss_rel_err=rel,
         loss_tol=HAPI_RESNET_LOSS_TOL, evaluate=logs,
         accuracy_topk_count=counted, launches=launches,
         step_s=loop, step_s_median=dt, images_per_s=B / dt,
         step_parts_median={k: float(np.median(v[1:]))
                            for k, v in stats.items()},
         eager_step_s_median=eager_s,
         vs_eager=dt / eager_s if eager_s else None,
         collate_s_a_batch=collate_s,
         h2d_bytes_a_step=B * 3 * 224 * 224 * 4 + B * 8,
         loader_s={"one_process": single_s, "two_workers": pooled_s,
                   "batches": n_train},
         peak_gib=peak, params=n_params, checkpoint_files=files)
    del model, net, init, opt, single, pooled
    torch.cuda.empty_cache()
    return launches


def hapi_gpt(dev, kernels, tmp):
    """hapi-GPT-2 medium (module docstring, 23)."""
    from paddle_tpu_torch import Model, nn, seed
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.io.token_dataset import (TokenFileDataset,
                                                   write_token_file)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    cfg = GPTConfig(dtype="bfloat16", hidden_dropout_prob=0.0,
                    attention_dropout_prob=0.0)
    L = cfg.num_hidden_layers
    n = HAPI_GPT_BATCHES
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, n * GPT_B * (GPT_S + 1)).astype(np.int32)
    path = write_token_file(str(tmp / "tokens.bin"), toks)
    feed = TokenFileDataset(path, seq_len=GPT_S, batch_size=GPT_B,
                            shuffle=True, seed=0)
    try:
        seen = []
        pairs = lm_pairs(feed, record=seen)
        seed(0)
        net = GPTForCausalLM(cfg, device=dev)
        model = Model(net)
        model.prepare(AdamW(learning_rate=1e-4, multi_precision=True),
                      nn.CrossEntropyLoss())
        log = loss_log()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model.fit(DataLoader(pairs, batch_size=None), epochs=1,
                  verbose=0, callbacks=[log])
        fit_s = time.perf_counter() - t0
        launches = _launches(kernels)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stats = model.last_fit_stats
        if model._train_step._device.type != "cuda":
            raise AssertionError("hapi gpt: the step is not on the card")
    finally:
        feed.close()
    if len(seen) != n or len(log.losses) != n:
        raise AssertionError(f"hapi gpt: {len(seen)} batches, "
                             f"{len(log.losses)} losses, expected {n}")
    ref = datafeed_windows(toks, GPT_S, GPT_B, 0, True, n)
    for (ids, labels), w in zip(seen, ref):
        if ids.dtype != np.int32 or ids.tobytes() != w[:, :-1].tobytes() \
                or labels.tobytes() != w[:, 1:].tobytes():
            raise AssertionError("hapi gpt: a feed batch differs from the "
                                 "numpy windows")
    want = {"cross_entropy_fwd": n, "cross_entropy_bwd": n,
            "flash_attention_fwd": L * n, "flash_attention_bwd_dq": L * n,
            "flash_attention_bwd_dkv": L * n, "multi_tensor_norm": n,
            "multi_tensor_adam": n}
    if launches != want:
        raise AssertionError(f"hapi gpt: launches {launches}, expected "
                             f"{want}")
    del model, net
    torch.cuda.empty_cache()
    # the same weights and batches through TrainStep directly
    seed(0)
    net = GPTForCausalLM(cfg, device=dev)
    step = TrainStep(net, AdamW(learning_rate=1e-4, multi_precision=True))
    direct = []
    for ids, labels in seen:
        direct.append(float(step({"input_ids": torch.from_numpy(ids).to(dev),
                                  "labels": torch.from_numpy(labels).to(
                                      dev)})))
    rel = [abs(a - b) / abs(b) for a, b in zip(log.losses, direct)]
    if not max(rel) <= HAPI_GPT_LOSS_TOL or not np.all(
            np.isfinite(log.losses)):
        raise AssertionError(f"hapi gpt: fit losses {log.losses} vs "
                             f"TrainStep {direct}")
    loop = [a + b + c for a, b, c in zip(stats["data_s"], stats["h2d_s"],
                                         stats["step_s"])]
    dt = float(np.median(loop[1:]))
    ref_s = REF_STEP_S.get("train_gpt")
    emit("hapi_gpt", layers=L, batch=GPT_B, seq=GPT_S, batches=n,
         feed={"tokens": int(toks.size), "shuffle": True, "seed": 0,
               "threads": 2}, fit_s=fit_s, losses=log.losses,
         trainstep_losses=direct, loss_rel_err=rel,
         loss_tol=HAPI_GPT_LOSS_TOL, launches=launches,
         launches_per_step={k: v / n for k, v in launches.items()},
         step_s=loop, step_s_median=dt, tokens_per_s=GPT_B * GPT_S / dt,
         step_parts_median={k: float(np.median(v[1:]))
                            for k, v in stats.items()},
         train_gpt_step_s_median=ref_s,
         vs_train_gpt=dt / ref_s if ref_s else None, peak_gib=peak)
    del step, net
    torch.cuda.empty_cache()
    return launches


def hapi_phase(dev, kernels):
    """Phase 23: the two hapi runs, each in a temporary directory."""
    import pathlib
    out = {}
    for name, run in (("resnet50", hapi_resnet), ("gpt", hapi_gpt)):
        tmp = pathlib.Path(tempfile.mkdtemp(prefix=f"ptt_hapi_{name}_"))
        try:
            out[name] = run(dev, kernels, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return out



# -- phase 24: deploy (to_static -> jit.save -> create_predictor) -----------

DEPLOY_S = 1024                  # ERNIE's long-text signature (flash)
DEPLOY_SHORT_S = 128             # its short-text one (plain attention)
ERNIE_BATCHES = (8, 32)
DEPLOY_RUNS = 10
DEPLOY_SEED = 23


def deploy_vocab(n):
    """A synthetic WordPiece vocab of `n` entries (ERNIE's own vocab.txt is
    not in the repo): the specials, ``##a``..``##z`` continuations, then
    words ``w0``, ``w1``, ..."""
    head = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz"]
    return head + [f"w{i}" for i in range(n - len(head))]


def deploy_texts(n_words, count, rng):
    """`count` seeded texts of `n_words` words, a tenth with a suffix the
    vocab lacks as a word (``w12xy`` -> ``w12 ##x ##y``), and
    punctuation, which the tokenizer splits off."""
    texts = []
    for _ in range(count):
        ids = rng.integers(0, 30000, n_words)
        words = [f"w{i}" + ("xy" if i % 10 == 0 else "")
                 + ("," if i % 17 == 0 else "") for i in ids]
        texts.append(" ".join(words))
    return texts


def median_ms(fn, n=DEPLOY_RUNS):
    """The median device ms of `fn` over n calls, CUDA events around each
    (after one warm call)."""
    fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def feed(pred, arrays):
    for name, arr in zip(pred.get_input_names(), arrays):
        pred.get_input_handle(name).copy_from_cpu(arr)


def fetch(pred):
    pred.run()
    return [pred.get_output_handle(n).copy_to_cpu()
            for n in pred.get_output_names()]


def artifact_bytes(prefix):
    return sum(os.path.getsize(prefix + ext)
               for ext in (".pdmodel", ".pdiparams.npz", ".pdmeta"))


def save_and_load(model, prefix, specs, pool=0):
    """jit.save then a predictor (or a pool of `pool`): the save's trace
    and write seconds (from the meta), the load's seconds, the bytes."""
    from paddle_tpu_torch import inference, jit
    jit.save(model, prefix, input_spec=specs)
    with open(prefix + ".pdmeta") as f:
        meta = json.load(f)
    t0 = time.perf_counter()
    cfg = inference.Config(prefix + ".pdmodel")
    pred = inference.PredictorPool(cfg, pool) if pool else \
        inference.create_predictor(cfg)
    stats = {"export_s": meta["export_s"], "write_s": meta["write_s"],
             "load_s": time.perf_counter() - t0,
             "artifact_bytes": artifact_bytes(prefix),
             "platform": meta["platform"]}
    return pred, stats


def launched(kernels):
    return {fn.__name__: fn.launches for fn in kernels.KERNELS
            if fn.launches}


def program_flash(pred):
    """What the loaded program holds around flash: the head_dim of each
    ``ptt::flash_attention_fwd`` node's q (from its traced value) and the
    number of pad nodes (``aten.constant_pad_nd`` / ``aten.pad``)."""
    dims, pads = [], 0
    for node in pred._layer._program.graph.nodes:
        if node.op != "call_function":
            continue
        target = str(node.target)
        if "flash_attention_fwd" in target:
            dims.append(int(node.args[0].meta["val"].shape[-1]))
        elif "constant_pad_nd" in target or target.startswith("aten.pad"):
            pads += 1
    return {"flash_head_dims": dims, "pad_nodes": pads}


def same_as_eager(what, got, eager):
    """The predictor's output against the eager port's on the same
    weights: bitwise, else within 1e-6 of the output's largest value
    (an op the exported graph runs in another order)."""
    err = float(np.abs(got - eager).max())
    scale = float(np.abs(eager).max())
    if not np.isfinite(got).all() or err > 1e-6 * scale:
        raise AssertionError(f"{what}: predictor vs eager max abs err "
                             f"{err} > 1e-6 * {scale}")
    return err, bool(err == 0.0)


# the fp32 flash forward's rows (3xTF32 on wgmma): ERNIE-3.0-medium's
# attention as the deploy path launches it, and a head_dim-128 causal GQA
# shape; (b, s, h, hk, d, causal)
FLASH_FP32_ROWS = {"ernie": (8, 1024, 12, 12, 64, False),
                   "d128_causal_gqa": (2, 2048, 16, 4, 128, True)}


def flash_f64(q, k, v, causal, scale):
    """``(out, lse)`` of the same attention in float64 throughout."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    qd = q.double().reshape(b, s, hk, h // hk, d)
    sc = torch.einsum("bqgrd,bkgd->bgrqk", qd, k.double()) * scale
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(sc, -1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", torch.exp(sc - lse[..., None]),
                       v.double())
    return out.reshape(b, s, h, d), lse.reshape(b, h, s)


def kernel_flash_fp32(FA, FB, dev, timer):
    """The fp32 flash forward (3xTF32 on wgmma, csrc/flash_tf32x3.cuh) at
    each FLASH_FP32_ROWS shape, unpadded: out and lse against the plain
    version (TOL) and against float64 (out and lse within
    FB.TF32X3_F64_FACTOR times the plain version's own error), timed
    beside the plain version, fp32 F.scaled_dot_product_attention (the
    library) and its split pre-pass alone (``split_ms``, included in
    ``ms``); the bound at the 3xTF32 rate (the design's, 165 TFLOP/s)
    and at 67 (``bound_ms_fp32_cores``), over the products this run's
    mask leaves (s (s + 1) / 2 pairs a head when causal)."""
    from paddle_tpu_torch.ops.kernels import _build
    lib = _build.library("flash_attention")
    F_ = torch.nn.functional
    rows = {}
    for name, (b, s, h, hk, d, causal) in FLASH_FP32_ROWS.items():
        g = torch.Generator(device=dev).manual_seed(DEPLOY_SEED + d)
        q = rand(g, (b, s, h, d), torch.float32, dev)
        k, v = (rand(g, (b, s, hk, d), torch.float32, dev) for _ in "kv")
        scale = d ** -0.5
        out, lse = FA.flash_attention_fwd(q, k, v, causal, scale)
        ref, ref_lse = FA.flash_fwd_reference(q, k, v, causal, scale)
        err = max(check_close(f"flash fp32 {name} {n}", a, r_,
                              torch.float32)
                  for n, a, r_ in (("out", out, ref), ("lse", lse, ref_lse)))
        o64, l64 = flash_f64(q, k, v, causal, scale)
        f64 = f64_errors([out], [ref], [o64])
        f64.update({"lse_" + k_: v_ for k_, v_ in
                    f64_errors([lse], [ref_lse], [l64]).items()})
        if max(f64["f64_ratio"], f64["lse_f64_ratio"]) > \
                FB.TF32X3_F64_FACTOR:
            raise AssertionError(f"flash fp32 {name}: error against float64 "
                                 f"{f64}, over {FB.TF32X3_F64_FACTOR}x the "
                                 "plain version's")
        del o64, l64
        del out, lse, ref, ref_lse
        torch.cuda.empty_cache()
        work = torch.empty(FA.flash_fp32_floats(b, s, h, hk, d),
                           dtype=torch.float32, device=dev)

        def split():
            _build.check(lib, lib.ptt_flash_fp32_split(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), work.data_ptr(),
                work.numel(), b, s, h, hk, d, _build.stream_of(q)),
                "ptt_flash_fp32_split")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * b * h * pairs * d
        nbytes = 4 * (2 * q.numel() + 2 * k.numel() + b * h * s)
        row = {"ms": timer(lambda: FA.flash_attention_fwd(q, k, v, causal,
                                                          scale)),
               "split_ms": timer(split),
               "plain_ms": timer(lambda: FA.flash_fwd_reference(
                   q, k, v, causal, scale), iters=3, warmup=1),
               "library_ms": timer(lambda: F_.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=hk != h)),
               "library": "F.scaled_dot_product_attention (fp32)",
               "max_abs_err": err, **f64, "flops": flops,
               "split_bytes": 3 * 4 * (q.numel() + 2 * k.numel()),
               "shape": f"b={b} s={s} h={h} hk={hk} d={d}, "
                        f"{'causal' if causal else 'not causal'}, fp32, "
                        "unpadded"}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                    TF32X3_FLOP_PER_S)
        row["bound_ms_fp32_cores"], _ = bound_ms(nbytes, flops,
                                                 FP32_FLOP_PER_S)
        rows[name] = row
        del work
        if name == "ernie":
            rows.update(flash_bwd_fp32_rows(FA, timer, q, k, v, causal,
                                            scale, g))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def flash_bwd_fp32_rows(FA, timer, q, k, v, causal, scale, g):
    """The fp32 dq and dk/dv (the first, shared-memory design) at the
    forward row's shape: each against its plain version (TOL), timed
    beside it and the autograd backward of fp32
    F.scaled_dot_product_attention (dq, dk and dv together), bound at
    the fp32 CUDA-core rate, the design's (bytes: q, k, v, dO and the
    two statistics read once, the gradients written once; operations:
    dq takes S, dP and dS K, dk/dv S, dP, P^T dO and dS^T Q, 2 d
    operations a (query, key) pair each)."""
    F_ = torch.nn.functional
    b, s, h, d = q.shape
    hk = k.shape[2]
    do = rand(g, q.shape, torch.float32, q.device)
    out, lse = FA.flash_attention_fwd(q, k, v, causal, scale)
    delta = FA.flash_delta(out, do)
    del out
    dq = FA.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                        scale)
    rdq, rdk, rdv = FA.flash_bwd_reference(q, k, v, do, lse, delta, causal,
                                           scale)
    errs = {"dq": check_close("flash fp32 dq", dq, rdq, torch.float32),
            "dkv": max(check_close("flash fp32 dk", dk, rdk, torch.float32),
                       check_close("flash fp32 dv", dv, rdv,
                                   torch.float32))}
    del dq, dk, dv, rdq, rdk, rdv
    lib_in = [t.detach().transpose(1, 2).clone().requires_grad_(True)
              for t in (q, k, v)]
    lib_out = F_.scaled_dot_product_attention(*lib_in, is_causal=causal,
                                              enable_gqa=hk != h)
    do_t = do.transpose(1, 2)
    lib_ms = timer(lambda: torch.autograd.grad(lib_out, lib_in, do_t,
                                               retain_graph=True))
    pairs = s * (s + 1) // 2 if causal else s * s
    stats = 2 * 4 * b * h * s
    rows = {}
    for name, kern, nout, prods in (
            ("dq", lambda: FA.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, causal, scale), q.numel(), 3),
            ("dkv", lambda: FA.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, causal, scale), 2 * k.numel(), 4)):
        nbytes = 4 * (2 * q.numel() + 2 * k.numel() + nout) + stats
        flops = prods * 2 * b * h * pairs * d
        row = {"ms": timer(kern),
               "plain_ms": timer(lambda: FA.flash_bwd_reference(
                   q, k, v, do, lse, delta, causal, scale), iters=3,
                   warmup=1),
               "library_ms": lib_ms,
               "library": "autograd backward of fp32 "
                          "F.scaled_dot_product_attention (dq, dk and dv "
                          "together)",
               "max_abs_err": errs[name], "flops": flops,
               "shape": f"b={b} s={s} h={h} hk={hk} d={d}, "
                        f"{'causal' if causal else 'not causal'}, fp32"}
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                    FP32_FLOP_PER_S)
        rows[f"ernie_bwd_{name}"] = row
    del lib_in, lib_out, do, lse, delta
    return rows


def deploy_ernie(dev, kernels, tmp, cfg=None):
    """ERNIE-3.0-medium-zh (fp32, 6 x 768, 12 heads, vocab 40000) behind
    FasterTokenizer: to_static -> jit.save at [None, 1024] and at [None,
    128] -> create_predictor, run at batch 8 and 32 through the handles.
    At s=1024 flash launches once a layer (6 a run) on the unpadded
    head_dim-64 inputs (the loaded program holds no pad); at 128 no
    kernel launches.  The logits equal the eager port's
    and, row 0 at s=1024, the plain version's (the CPU) within
    FLASH_TOL."""
    from paddle_tpu_torch import jit, seed, text
    from paddle_tpu_torch.models import (ErnieConfig,
                                         ErnieForSequenceClassification)
    cfg = cfg or ErnieConfig()
    seed(DEPLOY_SEED)
    model = ErnieForSequenceClassification(cfg, device=dev).eval()
    t0 = time.perf_counter()
    tok = text.FasterTokenizer(deploy_vocab(cfg.vocab_size))
    texts = deploy_texts(1100, max(ERNIE_BATCHES),
                         np.random.default_rng(DEPLOY_SEED))
    enc = {s: tok(texts, max_seq_len=s) for s in (DEPLOY_S, DEPLOY_SHORT_S)}
    tok_s = time.perf_counter() - t0
    tok.close()
    if not (enc[DEPLOY_S]["input_ids"] != tok.pad_id).all():
        raise AssertionError("deploy: a text did not fill 1024 tokens")
    out = {"tokenize_s": tok_s, "signatures": {}}
    fa = kernels.flash_attention_fwd
    for s in (DEPLOY_S, DEPLOY_SHORT_S):
        specs = [jit.InputSpec([None, s], "int64", "input_ids"),
                 jit.InputSpec([None, s], "int64", "token_type_ids")]
        static = jit.to_static(model, input_spec=specs)
        pred, stats = save_and_load(static, f"{tmp}/ernie_{s}", specs)
        want = cfg.num_hidden_layers if s == DEPLOY_S else 0
        stats["program"] = program_flash(pred)
        # fp32 at head_dim 64 runs the kernel as it is: no pad
        if stats["program"] != {"flash_head_dims": [cfg.hidden_size //
                                                    cfg.num_attention_heads]
                                * want, "pad_nodes": 0}:
            raise AssertionError(f"deploy ernie s={s}: the loaded program "
                                 f"holds {stats['program']}, expected "
                                 f"{want} flash nodes at head_dim 64 and "
                                 "no pad")
        for b in ERNIE_BATCHES:
            ids = enc[s]["input_ids"][:b]
            tt = enc[s]["token_type_ids"][:b]
            feed(pred, (ids, tt))
            kernels.reset_launch_counts()
            got = fetch(pred)[0]
            runs = launched(kernels)
            if runs != ({fa.__name__: want} if want else {}):
                raise AssertionError(f"deploy ernie s={s} b={b}: launches "
                                     f"{runs}, expected flash {want}")
            ids_t = torch.from_numpy(ids).to(dev)
            tt_t = torch.from_numpy(tt).to(dev)
            with torch.no_grad():
                eager = model(ids_t, tt_t).float().cpu().numpy()
            err, bitwise = same_as_eager(f"deploy ernie s={s} b={b}", got,
                                         eager)
            row = {"launches": runs, "logits_shape": list(got.shape),
                   "eager_max_abs_err": err, "bitwise": bitwise,
                   "predictor_run_ms": median_ms(lambda: fetch(pred)),
                   "program_ms": median_ms(lambda: pred._layer(ids, tt))}
            with torch.no_grad():
                row["eager_ms"] = median_ms(lambda: model(ids_t, tt_t))
            if s == DEPLOY_S and b == ERNIE_BATCHES[0]:
                row["plain_max_abs_err"] = ernie_plain(model, cfg, ids, tt,
                                                       got)
            stats[f"b{b}"] = row
        out["signatures"][str(s)] = stats
        del pred
    del model
    torch.cuda.empty_cache()
    return out


def ernie_plain(model, cfg, ids, tt, got):
    """Row 0's logits against the plain version: the same weights on the
    CPU (fp32, plain attention), within FLASH_TOL["fwd"]."""
    from paddle_tpu_torch.models import ErnieForSequenceClassification
    host = ErnieForSequenceClassification(cfg, device="cpu").eval()
    host.set_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        ref = host(torch.from_numpy(ids[:1]), torch.from_numpy(tt[:1]))
    return check_close("deploy ernie vs plain", torch.from_numpy(got[:1]),
                       ref, torch.float32, FLASH_TOL["fwd"])


def deploy_dit(dev, kernels, tmp, cfg=None):
    """DiT-XL/2 (fp32, 28 blocks, hidden 1152, 16 heads of 72, 256 tokens
    from 4 x 32 x 32 latents), its zero-initialised adaLN and final
    layers drawn from the seeded stream so the output is not zero: saved
    with a dynamic batch, run at batch 8 through create_predictor; equal
    to the eager port's; head_dim 72 takes plain attention, so no kernel
    launches."""
    from paddle_tpu_torch import jit, seed
    from paddle_tpu_torch.models import DiT, DiTConfig
    cfg = cfg or DiTConfig.dit_xl_2()
    seed(DEPLOY_SEED)
    model = DiT(cfg, device=dev).eval()
    g = torch.Generator(device=dev).manual_seed(DEPLOY_SEED)
    with torch.no_grad():
        for lin in [blk.adaLN for blk in model.blocks] + [model.final]:
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=g,
                                         device=dev) * 0.02)
            lin.bias.copy_(torch.randn(lin.bias.shape, generator=g,
                                       device=dev) * 0.02)
    specs = [jit.InputSpec([None, cfg.in_channels, cfg.input_size,
                            cfg.input_size], "float32", "x"),
             jit.InputSpec([None], "float32", "t"),
             jit.InputSpec([None], "int64", "y")]
    pred, stats = save_and_load(model, f"{tmp}/dit", specs)
    rng = np.random.default_rng(DEPLOY_SEED)
    b = 8
    x = rng.standard_normal((b, cfg.in_channels, cfg.input_size,
                             cfg.input_size)).astype(np.float32)
    t = rng.integers(0, 1000, b).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, b).astype(np.int64)
    feed(pred, (x, t, y))
    kernels.reset_launch_counts()
    got = fetch(pred)[0]
    if launched(kernels):
        raise AssertionError(f"deploy dit: kernels launched "
                             f"{launched(kernels)}, expected none")
    xs = [torch.from_numpy(a).to(dev) for a in (x, t, y)]
    with torch.no_grad():
        eager = model(*xs).cpu().numpy()
    err, bitwise = same_as_eager("deploy dit", got, eager)
    stats.update(batch=b, out_shape=list(got.shape), eager_max_abs_err=err,
                 bitwise=bitwise, out_abs_max=float(np.abs(got).max()),
                 predictor_run_ms=median_ms(lambda: fetch(pred)),
                 program_ms=median_ms(lambda: pred._layer(x, t, y)))
    with torch.no_grad():
        stats["eager_ms"] = median_ms(lambda: model(*xs))
    del pred, model
    torch.cuda.empty_cache()
    return stats


def deploy_llama(dev, kernels, tmp, cfg=None):
    """Llama-3-8B width cut to 2 layers (bf16): the scoring forward saved
    at [1, 1024] and run through a PredictorPool of 2: QKV, the MLP and
    flash launch twice a run (once a layer) from the loaded program, the
    logits equal the eager port's, both slots equal."""
    from paddle_tpu_torch import jit, seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    if cfg is None:
        cfg = LlamaConfig.llama3_8b()
        cfg.num_hidden_layers = 2
    seed(DEPLOY_SEED)
    model = LlamaForCausalLM(cfg, device=dev)
    specs = [jit.InputSpec([1, DEPLOY_S], "int64", "input_ids")]
    pool, stats = save_and_load(model, f"{tmp}/llama", specs, pool=2)
    ids = np.random.default_rng(DEPLOY_SEED).integers(
        0, cfg.vocab_size, (1, DEPLOY_S))
    with torch.no_grad():
        eager = model(torch.from_numpy(ids).to(dev)).float().cpu().numpy()
    want = {fn.__name__: cfg.num_hidden_layers
            for fn in (kernels.fused_rmsnorm_qkv, kernels.fused_mlp,
                       kernels.flash_attention_fwd)}
    slots = []
    for i in range(2):
        pred = pool.retrieve(i)
        feed(pred, (ids,))
        kernels.reset_launch_counts()
        got = fetch(pred)[0]
        if launched(kernels) != want:
            raise AssertionError(f"deploy llama slot {i}: launches "
                                 f"{launched(kernels)}, expected {want}")
        stats[f"slot{i}_eager_max_abs_err"], stats[f"slot{i}_bitwise"] = \
            same_as_eager(f"deploy llama slot {i}", got, eager)
        slots.append(got)
    if not np.array_equal(slots[0], slots[1]):
        raise AssertionError("deploy llama: the pool's slots differ")
    pred = pool.retrieve(0)
    ids_t = torch.from_numpy(ids).to(dev)
    stats.update(launches=want, logits_shape=list(slots[0].shape),
                 predictor_run_ms=median_ms(lambda: fetch(pred)),
                 program_ms=median_ms(lambda: pred._layer(ids)))
    with torch.no_grad():
        stats["eager_ms"] = median_ms(lambda: model(ids_t))
    del pool, pred, model, slots
    torch.cuda.empty_cache()
    return stats


class _Dy2Static(torch.nn.Module):
    """A module whose forward is a to_static (dy2static-converted)
    function."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _deploy_if(x):
    if x.sum() > 0:
        y = x * 2
    else:
        y = x - 1
    return y


def _deploy_while(x, n):
    y = x
    i = 0
    while i < n:
        y = y + 1
        i = i + 1
    return y


def deploy_dy2static(dev):
    """torch.export of to_static functions on the card's torch: a traced
    `if` must become torch.cond and its program equal the eager call;
    whether this torch traces while_loop (a loop bound that is data) is
    recorded, and where it cannot the helper raises a TypeError at trace
    time."""
    from paddle_tpu_torch.jit import to_static
    x = torch.randn(4, 8, device=dev, generator=torch.Generator(
        device=dev).manual_seed(DEPLOY_SEED))
    n = torch.tensor(3, device=dev)
    res = {"torch": torch.__version__}
    for name, fn, args in (("cond", _deploy_if, (x,)),
                           ("cond_negative", _deploy_if, (-x,)),
                           ("while_loop", _deploy_while, (x, n))):
        try:
            ep = torch.export.export(_Dy2Static(to_static(fn)), args)
        except TypeError as e:
            if name != "while_loop":
                raise
            res[name] = False
            res[name + "_error"] = str(e)[:300]
            continue
        hops = sorted({nd.target.name() for nd in ep.graph.nodes
                       if isinstance(nd.target,
                                     torch._ops.HigherOrderOperator)})
        if not hops or not torch.equal(ep.module()(*args), fn(*args)):
            raise AssertionError(f"deploy dy2static {name}: ops {hops}, "
                                 "or the program differs from eager")
        res[name] = hops
    return res


def deploy_phase(dev, kernels):
    """Phase 24: the fp32 flash row at ERNIE's shape, then ERNIE, DiT and
    Llama served from saved artifacts, and the dy2static export check;
    the artifacts in a temporary directory."""
    import pathlib
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import fused_block as FB
    rows = kernel_flash_fp32(FA, FB, dev, Timer(dev))
    emit("kernels_deploy", results={f"flash_attention_fwd_fp32_{k}": r
                                    for k, r in rows.items()})
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ptt_deploy_"))
    out = {}
    try:
        for name, run in (("ernie", deploy_ernie), ("dit", deploy_dit),
                          ("llama", deploy_llama)):
            t0 = time.perf_counter()
            out[name] = run(dev, kernels, tmp)
            out[name]["seconds"] = time.perf_counter() - t0
            emit(f"deploy_{name}", **out[name])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["dy2static"] = deploy_dy2static(dev)
    emit("deploy_dy2static", **out["dy2static"])
    return rows, out


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
    with timed("kernels"):
        res = {"fused_rmsnorm_qkv": {T: kernel_qkv(FB, dev, timer, T)
                                     for T in (1, 8, 16, 256)},
               "fused_mlp": {T: kernel_mlp(FB, dev, timer, T)
                             for T in (1, 8, 16, 256)},
               "paged_decode_attention": {8: kernel_paged(PA, dev, timer)}}
        emit("kernels", results={k: {str(t): v for t, v in r.items()}
                                 for k, r in res.items()})
    with timed("kernels_train"):
        train_rows = kernel_flash(FA, dev, timer)
        train_rows["fused_rmsnorm_qkv_train"] = kernel_qkv_train(FB, dev,
                                                                 timer)
        train_rows["fused_rmsnorm_qkv_fwd_T8192"] = kernel_qkv(
            FB, dev, timer, TRAIN_B * TRAIN_S, plain_iters=3)
        train_rows["fused_mlp_train"] = kernel_mlp(FB, dev, timer,
                                                   TRAIN_B * TRAIN_S,
                                                   plain_iters=3)
        fp32_rows = kernel_amp_fp32(FB, dev, timer)
        train_rows.update(fp32_rows)
        train_rows.update(kernel_amp_fp16(FA, FB, dev, timer))
        emit("kernels_train", results=train_rows)
        amp_fp32_gates(FB, fp32_rows)
    with timed("kernels_quant"):
        quant_rows = kernel_quant_rows(QM, quantize_linear_weight, dev,
                                       timer)
        quant_rows["paged_decode_attention_int8"] = kernel_paged_int8(
            PA, _quantize_kv, dev, timer)
        emit("kernels_quant", results=quant_rows)
    with timed("kernels_moe"):
        moe_rows = kernels_moe(GM, TM, dev, timer)
        emit("kernels_moe", results=moe_rows)
    with timed("kernels_ce"):
        ce_rows = kernels_ce(CE, dev, timer)
        emit("kernels_ce", results=ce_rows)
    with timed("kernels_ffn"):
        ffn_rows = kernels_ffn(FB, dev, timer)
        emit("kernels_ffn", results=ffn_rows)
    with timed("kernels_decoder"):
        dec_rows = kernel_decoder(FB, dev, timer)
        norm_rows = kernel_rmsnorm(RN, dev, timer)
        emit("kernels_decoder", results={"fused_decoder_block": dec_rows,
                                         "fused_rmsnorm": norm_rows})
    with timed("kernels_multi_tensor"):
        mt_rows = kernel_multi_tensor(MT, dev, timer)
        emit("kernels_multi_tensor", results=mt_rows)
    del timer
    torch.cuda.empty_cache()
    with timed("op_surface"):
        op_surface(dev)
    torch.cuda.empty_cache()

    with timed("parity"):
        card, host, prompt = parity(dev)
        parity_quant(card, host, prompt, kernels)
        parity_int8w(card, host, prompt, kernels)
        static_parity(card, host, prompt)
        concat_cache(card, kernels)
    with timed("ptq_qat"):
        ptq_qat(card, host, kernels)
    del card, host
    torch.cuda.empty_cache()
    with timed("train_parity"):
        train_parity(dev)
    torch.cuda.empty_cache()
    with timed("serve"):
        launches, model, prompts, bf16_tokens, eager = serve(dev, kernels)
    torch.cuda.empty_cache()
    with timed("serve_quant"):
        quant_launches = serve_quant(dev, kernels, model, prompts,
                                     bf16_tokens)
    torch.cuda.empty_cache()
    with timed("serve_int8w"):
        int8w_launches = serve_int8w(kernels, model, prompts, bf16_tokens)
    torch.cuda.empty_cache()
    graphed = {}
    with timed("serve_graph"):
        graphed["serve_graph"], chunk_launches = serve_graph(
            dev, kernels, model, prompts, bf16_tokens, eager)
    with timed("serve_spec"):
        serve_spec(kernels, model)
    with timed("serve_static"):
        graphed["serve_static"] = serve_static(kernels, model, prompts,
                                               bf16_tokens)
    with timed("serve_fleet"):
        fleet_launches = serve_fleet(kernels, model, prompts, bf16_tokens)
    with timed("generate"):
        graphed["generate"] = generate_phase(
            kernels, model, "llama3_8b", 4, 512, 64,
            (kernels.SERVING[0], kernels.SERVING[1]))
    with timed("score_decoder"):
        score_launches = score_decoder(model, kernels)
    torch.cuda.empty_cache()
    with timed("device_profile"), \
            tempfile.TemporaryDirectory() as ledger:
        reports = device_profile(dev, kernels, ledger)
        measured_tier(model, kernels, ledger, reports)
    del model
    torch.cuda.empty_cache()
    with timed("generate_gpt"):
        generate_gpt(dev, kernels)
    with timed("train"):
        train_launches, train_peak = train(dev, kernels)
    torch.cuda.empty_cache()
    with timed("train_graph"):
        graph_launches = train_graph(dev, kernels)
    torch.cuda.empty_cache()
    with timed("train_state"):
        train_state(dev)
    torch.cuda.empty_cache()
    with timed("amp"):
        amp_launches = amp_phases(dev, kernels)
    torch.cuda.empty_cache()
    with timed("decoder_parity"):
        decoder_parity(dev, kernels)
    torch.cuda.empty_cache()
    with timed("train_decoder"):
        dec_launches = train_decoder(dev, kernels, train_peak)
    torch.cuda.empty_cache()
    with timed("moe_parity"):
        moe_parity(GM, TM, dev)
    torch.cuda.empty_cache()
    with timed("train_moe"):
        moe_launches = train_moe(dev, kernels)
    torch.cuda.empty_cache()
    with timed("gpt_parity"):
        gpt_parity(dev, kernels)
    torch.cuda.empty_cache()
    with timed("train_gpt"):
        gpt_launches = train_gpt(dev, kernels)
    torch.cuda.empty_cache()
    with timed("train_gpt_graph"):
        gpt_graph_launches = train_gpt_graph(dev, kernels)
    torch.cuda.empty_cache()
    with timed("recovery_drill"):
        drill_launches, digest_row = recovery_drill(dev, kernels)
    torch.cuda.empty_cache()
    with timed("cold_start"):
        cold_launches = cold_start()
    with timed("transformer_infer"):
        ffn_launches = transformer_infer(dev, kernels)
    torch.cuda.empty_cache()
    with timed("norm_residual"):
        norm_launches = norm_residual(dev, kernels)
    torch.cuda.empty_cache()
    with timed("sparse_embed"):
        sparse_launches = sparse_embed(dev, kernels)
    torch.cuda.empty_cache()
    with timed("autograd"):
        autograd_phase(dev)
    with timed("resnet50"):
        resnet_launches = resnet50_phase(dev, kernels)
    with timed("rnn"):
        rnn_phase(dev)
    torch.cuda.empty_cache()
    with timed("losses"):
        losses_phase(dev)
    with timed("hapi"):
        hapi_launches = hapi_phase(dev, kernels)
    torch.cuda.empty_cache()
    with timed("deploy"):
        flash32_rows, deploy = deploy_phase(dev, kernels)
    torch.cuda.empty_cache()
    with timed("demo"):
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
        # the loaded Llama artifact's run (deploy)
        entry["launches_deploy_llama"] = deploy["llama"]["launches"].get(
            name, 0)
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
            entry["gpt_shape"]["launches_hapi_gpt"] = \
                hapi_launches["gpt"].get(name, 0)
        if name == "flash_attention_fwd":
            # the loaded Llama artifact's run (bf16)
            entry["launches_deploy_llama"] = deploy["llama"]["launches"][
                name]
        if "_bwd_" in name:            # the reduction before each backward
            entry["flash_delta_ms"] = train_rows["flash_delta"]["ms"]
            entry["gpt_shape"]["flash_delta_ms"] = \
                train_rows["flash_delta_gpt"]["ms"]
        # AMP's steps (amp_o1, amp_o2): this wrapper's launches by dtype
        for phase, got in amp_launches.items():
            entry[f"launches_{phase}"] = got[wrapper]
        # the sparse_embed phase's eager steps (its sparse run)
        entry["launches_sparse_embed"] = sparse_launches[wrapper]
        if "_bwd_" in name:            # fp32 at ERNIE's shape (d = 64)
            key = "ernie_bwd_" + name.rsplit("_", 1)[-1]
            entry["fp32_ernie_shape"] = {
                **{k: flash32_rows[key][k] for k in keys},
                "shape": flash32_rows[key]["shape"], "launches": 0,
                "path": "none (ERNIE's deploy path runs no backward)"}
        line.append(entry)
    # AMP float16 (kernel_amp_fp16's rows): launches in fp16 from the
    # amp_o1_fp16 and amp_o2_fp16 steps (flash at both levels; QKV's
    # training variant and the MLP at O2, O1 keeping them fp32)
    for name, (src, rep) in train_where.items():
        row = train_rows[name + "_fp16"]
        wrapper = name.removesuffix("_train")
        by = {ph: amp_launches[ph][wrapper].get("float16", 0)
              for ph in ("amp_o1_fp16", "amp_o2_fp16")}
        line.append({"name": name + "_fp16", "route": "cuda", "source": src,
                     "replaces": rep, "launches": sum(by.values()),
                     **{k: row[k] for k in keys}, "shape": row["shape"],
                     "path": "amp_o1_fp16, amp_o2_fp16",
                     "launches_by_phase": by,
                     **{k: row[k] for k in ("kernel_path", "overflow")
                        if k in row}})
    # the fp32 forward (3xTF32 on wgmma): launches from the loaded ERNIE
    # artifact's run at batch 8, s = 1024, all unpadded fp32 at head_dim
    # 64; the d=128 causal GQA row beside it
    ernie = flash32_rows["ernie"]
    line.append({
        "name": "flash_attention_fwd_fp32", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/flash_tf32x3.cuh",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:71",
        "launches": deploy["ernie"]["signatures"][str(DEPLOY_S)]["b8"][
            "launches"].get("flash_attention_fwd", 0),
        **{k: ernie[k] for k in keys}, "shape": ernie["shape"],
        "path": "deploy (ERNIE)", "split_ms": ernie["split_ms"],
        "bound_ms_fp32_cores": ernie["bound_ms_fp32_cores"],
        "d128_causal_gqa": {
            k: flash32_rows["d128_causal_gqa"][k]
            for k in keys + ("shape", "split_ms", "bound_ms_fp32_cores")}})
    # the fp32 kernels that amp_o1 launches (QKV's training variant and
    # the MLP at T = 8192, 3xTF32, bound at the 3xTF32 rate): launches
    # from amp_o1's steps; the float64 errors beside the row's
    extra = ("max_abs_err_f64", "plain_max_abs_err_f64", "f64_ratio")
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
                     **{k: row[k] for k in extra},
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
        r64 = ce_rows["fp32 T=64 V=1000"][name]
        line.append({"name": name, "route": "cuda",
                     "source": src + "cross_entropy.cu", "replaces": rep_,
                     "launches": gpt_launches[name],
                     **{k: r[k] for k in keys}, "shape": r["shape"],
                     "path": "train_gpt",
                     "launches_resnet50": resnet_launches[name],
                     "launches_hapi": {k: v.get(name, 0) for k, v in
                                       hapi_launches.items()},
                     "resnet50_shape": {**{k: r64[k] for k in keys},
                                        "shape": r64["shape"],
                                        "path": "resnet50"}})
    # the nn.Transformer path: relu bf16 at its FFN shape; launches from
    # transformer_infer
    r, r8 = ffn_rows["relu bf16"], ffn_rows["relu bf16 T=8"]
    r16 = train_rows["fused_ffn_fp16"]
    line.append({"name": "fused_ffn", "route": "cuda",
                 "source": src + "fused_block.cu",
                 "replaces": "paddle_tpu/ops/pallas/fused_block.py:494",
                 "launches": ffn_launches["fused_ffn"],
                 **{k: r[k] for k in keys}, "shape": r["shape"],
                 "path": "transformer_infer",
                 "decode_T8": {**{k: r8[k] for k in keys},
                               "kernel_path": r8["path"]},
                 # fp16 (no path runs it: the Transformer cell is bf16)
                 "fp16": {**{k: r16[k] for k in keys},
                          "shape": r16["shape"], "kernel_path": r16["path"],
                          "launches": 0}})
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
        entry = {"name": name, "route": "cuda",
                 "source": src + "multi_tensor.cu", "replaces": rep_,
                 "launches": train_launches[name],
                 **{k: r[k] for k in keys}, "shape": r["shape"],
                 "path": "train (eager), train_graph (one graph)",
                 "bitwise": r["bitwise"],
                 "launches_train_gpt": gpt_launches[name],
                 "graph_launches_a_replay": {
                     "train_graph": graph_launches[name],
                     "train_gpt_graph": gpt_graph_launches[name]}}
        if name == "multi_tensor_adam":
            entry.update({k: r[k] for k in ("bound_share", "tb_per_s")})
        else:                             # fp16 gradients (no clip on
            r16 = mt_rows["multi_tensor_norm_fp16"]   # the AMP path)
            entry["fp16"] = {**{k: r16.get(k) for k in keys},
                             "shape": r16["shape"], "launches": 0}
        line.append(entry)
    # the update in AMP float16 (fp16 params, fp32 masters, fp16 grads):
    # launches from amp_o2_fp16's steps
    r = mt_rows["multi_tensor_adam_fp16"]
    line.append({"name": "multi_tensor_adam_fp16", "route": "cuda",
                 "source": src + "multi_tensor.cu",
                 "replaces": "paddle_tpu/optimizer/optimizers.py:144",
                 "launches": amp_launches["amp_o2_fp16"][
                     "multi_tensor_adam"].get("float16", 0),
                 **{k: r[k] for k in keys}, "shape": r["shape"],
                 "path": "amp_o2_fp16", "bitwise": r["bitwise"],
                 **{k: r[k] for k in ("bound_share", "tb_per_s")}})
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
        if w in sparse_launches:
            entry.setdefault("launches_sparse_embed", sparse_launches[w])
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
